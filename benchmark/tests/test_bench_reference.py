"""The plain reference against the port on the CPU at a tiny size: the
models alone, whole cells through the drivers, and the faults each cell's
check has to catch (the timed path broken underneath, ``correct`` false)."""
import time

import pytest
import torch

from benchmark import reference
from benchmark.drivers import serve_session, train_matching
from benchmark.reference.init import load_into
from benchmark.tests.tiny import (tiny_serve_config, tiny_traffic,
                                  tiny_train_config)


def _model_pair(kind):
    from sketchyscenecolorization_torch.config import (
        BGGanConfig, FGGanConfig, MatchingConfig)
    from sketchyscenecolorization_torch.models import bg_gan, fg_gan
    from sketchyscenecolorization_torch.models.rmi import RMI
    fw = tiny_serve_config()["framework"]
    ref, state = reference.build(kind, fw[kind], 3, "cpu")
    prog = {"bg_gan": lambda: bg_gan.build_generator(BGGanConfig(**fw[kind])),
            "fg_gan": lambda: fg_gan.build_generator(FGGanConfig(**fw[kind])),
            "matching": lambda: RMI(MatchingConfig(**fw[kind]))}[kind]()
    load_into(prog, state)
    return prog, ref


@pytest.mark.parametrize("kind", ["bg_gan", "fg_gan"])
def test_generators_agree_with_the_port_in_float64(kind):
    torch.manual_seed(0)
    prog, ref = _model_pair(kind)
    prog, ref = prog.double(), ref.double()
    n = 1 if kind == "bg_gan" else 3
    x = torch.rand(n, 64, 64, 3, dtype=torch.float64) * 2 - 1
    t = 8 if kind == "bg_gan" else 15
    tok = torch.tensor([[0] * (t - 5) + [2, 3, 4, 5, 6]] * n)
    with torch.no_grad():
        if kind == "bg_gan":
            got, want = prog(x, tok)[0], ref(x, tok)[0]
        else:
            lab = torch.tensor([1, 2, 3])
            noise = torch.randn(3, 16, dtype=torch.float64)
            got = prog(x, tok, lab, noise, per_sample=True)
            want = ref(x, tok, lab, noise)
    assert float((got - want).abs().max()) < 1e-9


def test_matcher_agrees_with_the_port():
    torch.manual_seed(0)
    prog, ref = _model_pair("matching")
    x = torch.randn(1, 64, 64, 3) * 60
    w, n = torch.tensor([[3, 4, 5, 6] + [0] * 11]), torch.tensor([4])
    with torch.no_grad():
        got, want = prog(x, w, n).up, ref(x, w, n).up
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4


def serve(cell, seed=1234567891011, seconds=3.0, **traffic):
    run = serve_session.run(
        cell={"name": cell, "chips": 1}, config=tiny_serve_config(),
        traffic=tiny_traffic(cell, **traffic), seed=seed, seconds=seconds,
        trace=False, started=time.time(), device="cpu")
    return run, {c["name"]: c["value"] for c in run.checks}


def train(seed=31, seconds=2.0):
    traffic = tiny_traffic("matching_train", pool_batches=8)
    run = train_matching.run(
        cell={"name": "matching_train", "chips": 1},
        config=tiny_train_config(), traffic=traffic, seed=seed,
        seconds=seconds, trace=False, started=time.time(), device="cpu")
    return run, {c["name"]: c["value"] for c in run.checks}


@pytest.mark.parametrize("cell", ["fg_interactive", "bg_interactive",
                                  "fg_stream"])
def test_serving_cells_run_correct_on_the_cpu(cell):
    run, values = serve(cell)
    assert run.correct, run.checks
    assert run.attempted > 10 and run.failed == 0
    assert values["visits_compared"] >= 2 and values["canvas_mismatch"] == 0


def test_training_cell_runs_correct_on_the_cpu():
    run, values = train()
    assert run.correct, run.checks
    assert run.steps > 3


# ------------------------------------------------------------------ faults
def _fg_engine():
    from sketchyscenecolorization_torch.pipeline import engines
    return engines.FGColorizeEngine


def _bump_output(cls, method, delta):
    orig = getattr(cls, method)

    def bumped(self, *a, **kw):
        return orig(self, *a, **kw) + delta
    return bumped


def test_an_altered_generator_row_fails(monkeypatch):
    from sketchyscenecolorization_torch.models import fg_gan
    orig = fg_gan.MRUGenerator.forward

    def altered(self, *args, **kw):
        return orig(self, *args, **kw) * 0.97
    monkeypatch.setattr(fg_gan.MRUGenerator, "forward", altered)
    run, values = serve("fg_interactive")
    assert not run.correct
    assert values["fg_rows_gap"] > 1e-2


def test_half_the_instance_rows_left_out_fails(monkeypatch):
    cls = _fg_engine()
    orig = cls.prep_fwd

    def half(self, rows, class_ids25, tokens_rows, bucket):
        out = orig(self, rows, class_ids25, tokens_rows, bucket)
        k = len(class_ids25)
        out[k // 2:k] = out[:1].expand(k - k // 2, *out.shape[1:])
        return out
    monkeypatch.setattr(cls, "prep_fwd", half)
    run, values = serve("fg_interactive")
    assert not run.correct
    assert values["canvas_mismatch"] > 0


def test_an_altered_token_fails(monkeypatch):
    from sketchyscenecolorization_torch.pipeline import engines
    orig = engines.colorization_encode

    def altered(text, vocab, max_len):
        out = list(orig(text, vocab, max_len))
        out[-1] = (out[-1] + 1) % len(vocab)
        return out
    monkeypatch.setattr(engines, "colorization_encode", altered)
    run, values = serve("fg_interactive")
    assert not run.correct
    assert values["fg_rows_gap"] > 1e-3


def test_altered_logits_fail(monkeypatch):
    from sketchyscenecolorization_torch.pipeline import engines
    monkeypatch.setattr(engines.MatchingEngine, "fuse_logits", _bump_output(
        engines.MatchingEngine, "fuse_logits", 0.01))
    run, values = serve("fg_interactive")
    assert not run.correct
    assert values["logits_gap"] > 1e-3


@pytest.mark.parametrize("cell", ["fg_interactive", "fg_stream"])
def test_a_dropped_instance_fails(monkeypatch, cell):
    from sketchyscenecolorization_torch.pipeline.session import \
        ColorizationSession
    orig = ColorizationSession._match_many

    def dropped(self, state, texts):
        return [m[:-1] if len(m) > 1 else m for m in orig(self, state, texts)]
    monkeypatch.setattr(ColorizationSession, "_match_many", dropped)
    run, values = serve(cell)
    assert not run.correct
    assert values["selection_misses"] > 0


def test_an_altered_canvas_fails(monkeypatch):
    from sketchyscenecolorization_torch.pipeline import session
    orig = session.write_png

    def altered(path, image, level=1):
        image = image.copy()
        image[20:22, 20:22] ^= 1
        return orig(path, image, level)
    monkeypatch.setattr(session, "write_png", altered)
    for cell in ("fg_interactive", "bg_interactive"):
        run, values = serve(cell)
        assert not run.correct
        assert values["canvas_mismatch"] > 0


def test_an_altered_bg_generator_fails(monkeypatch):
    from sketchyscenecolorization_torch.models import bg_gan
    orig = bg_gan.ResidualGenerator.forward

    def altered(self, x, tokens):
        out, reg = orig(self, x, tokens)
        return out * 0.97, reg
    monkeypatch.setattr(bg_gan.ResidualGenerator, "forward", altered)
    run, values = serve("bg_interactive")
    assert not run.correct
    assert values["bg_rows_gap"] > 1e-2


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from sketchyscenecolorization_torch.train import matching
    orig = matching.make_matching_train_step

    def frozen(cfg, mesh=None):
        step = orig(cfg, mesh)

        def no_update(state, batch):
            saved = {n: p.detach().clone()
                     for n, p in state.model.named_parameters()}
            state, metrics = step(state, batch)
            with torch.no_grad():
                for n, p in state.model.named_parameters():
                    p.copy_(saved[n])
            return state, metrics
        return no_update
    monkeypatch.setattr(matching, "make_matching_train_step", frozen)
    monkeypatch.setattr(train_matching, "make_matching_train_step", frozen,
                        raising=False)
    run, values = train()
    assert not run.correct
    assert values["change_gap"] > 0.5
