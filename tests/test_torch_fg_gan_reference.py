"""The port's FG GAN train step (``train/fg_gan.py:make_fg_gan_train_step``)
against the benchmark's plain reference of it
(``benchmark/reference/fg_gan_step.py``, its discriminator in
``fg_disc.py``) through the benchmark's check
(``benchmark/fg_gan_train_check.py``), and the step's spans.

The port starts from the reference's seeded weights and spectral-norm
vectors and takes three steps on random batches (image 32, base 8, noise
16, batch 2, the paper's 25 classes and 15-token captions), drawing its
noise by its own recipe; the reference takes each step from the state the
port held before it, drawing by its copy of the recipe; both in float64,
so that what is left is the order of the arithmetic.  Compared, each the
worst over the steps, with a tolerance of 1e-9 (float64 rounding, five
orders of magnitude under any fault below):

- ``loss_gap``: each step's ``loss_d`` and ``loss_g``, relative (measured
  3.4e-16);
- ``grad_gap``: each leaf's gradient, read from Adam's first moment (b1 =
  0 makes it the gradient), the distance over the larger of the leaf's
  norm and its model's median leaf norm (measured 8.5e-14);
- ``change_gap``: each leaf's move against the reference's Adam update
  from the same state with the port's gradient, the same way (measured
  0);
- ``sn_gap``: the vectors each step stored against the reference's power
  iteration from the vectors before it on the port's kernels after it
  (measured 0).

A step that commits no spectral-norm vector (``sn_gap`` 0.42), or that
drops the ACGAN term (``loss_gap`` 0.68, ``grad_gap`` 1.0), fails the
comparison.  Traced, one step records ``step`` (``req`` the state's step,
``d_updates`` its D updates) over ``draws``, one ``d_update`` a D update
over ``d_forward``, ``d_backward`` and ``adam``, and ``g_update`` over
``g_forward``, ``g_backward`` and ``adam``; its results are bit-equal to
the untraced step's."""
import contextlib

import numpy as np
import pytest
import torch

from benchmark import fg_gan_train_check as check
from benchmark.drivers.train_fg_gan import parts, record_step
from benchmark.harness import load_json
from benchmark.reference import fg_gan_step as ref
from benchmark.reference.init import load_into
from sketchyscenecolorization_torch.config import FGGanConfig
from sketchyscenecolorization_torch.train import fg_gan as port
from sketchyscenecolorization_torch.train.optim import AdamState
from sketchyscenecolorization_torch.utils.tracing import Tracer

SEED, STEPS = 20231023, 3
TOL = {"loss_gap": 1e-9, "grad_gap": 1e-9, "change_gap": 1e-9,
       "sn_gap": 1e-9}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sizes(**over):
    f = dict(load_json("configs", "train_fg_gan_mru192.json")
             ["framework"]["fg_gan"])
    f.update(image_size=32, base_channels=8, noise_dim=16, **over)
    return f


def batches(f, n=STEPS):
    rng = np.random.default_rng(7)
    b, s, t = f["batch_size"], f["image_size"], f["max_len"]

    def one():
        tokens = rng.integers(1, f["vocab_size"], (b, t))
        for row, pad in zip(tokens, rng.integers(0, t - 2, b)):
            row[:pad] = 0                       # front-padded captions
        return {"images": rng.uniform(-1, 1, (b, s, s, 3)),
                "sketches": rng.uniform(-1, 1, (b, s, s, 3)),
                "images_d": rng.uniform(-1, 1, (b, s, s, 3)),
                "class_id": rng.integers(0, f["num_classes"], b),
                "class_id_d": rng.integers(0, f["num_classes"], b),
                "tokens": tokens.astype(np.int32)}
    return [(one(), one()) for _ in range(n)]


def port_state(f, dtype):
    gen, disc = ref.models(f, SEED, "cpu")
    g, d = port.build_models(FGGanConfig(**f), SEED)
    load_into(g, gen.state_dict())
    load_into(d, disc.state_dict())
    g, d = g.to(dtype), d.to(dtype)
    return port.FGGanTrainState(
        generator=g, discriminator=d,
        g_opt=AdamState.zeros(dict(g.named_parameters())),
        d_opt=AdamState.zeros(dict(d.named_parameters())))


def device_batch(batch, dtype):
    return {k: torch.from_numpy(np.asarray(v)).to(dtype)
            if np.asarray(v).dtype.kind == "f" else torch.from_numpy(
                np.asarray(v)).long() for k, v in batch.items()}


def port_steps(f, data, dtype=torch.float64, trace=None):
    """The port's steps, recorded as the benchmark's driver records them:
    the state before each step, its losses, gradients (Adam's first
    moment), moves and stored vectors."""
    cfg = FGGanConfig(**f)
    state = port_state(f, dtype)
    step = port.make_fg_gan_train_step(cfg, seed=SEED, trace=trace)
    out = {k: [] for k in ("losses", "grads", "change", "sn", "starts")}
    for bd, bg in data:
        out["starts"].append(ref.snapshot(*parts(state)))
        draws = port.fg_gan_draws(cfg, SEED, state.step, "cpu")
        draws = {"d": [{k: v.to(dtype) for k, v in d.items()}
                       for d in draws["d"]],
                 "g": {k: v.to(dtype) for k, v in draws["g"].items()}}
        _, metrics = step(state, device_batch(bd, dtype),
                          device_batch(bg, dtype), draws)
        record_step(out, state, metrics)
    return out, state


def compare(f, data):
    """The comparison of the benchmark's check: each port step against
    the reference's step from the state the port held before it."""
    prog, _ = port_steps(f, data)
    want = ref.reference_steps(f, data, SEED, "cpu", dtype=torch.float64,
                               starts=prog["starts"])
    return check.gaps(prog, want, f)


def test_the_port_step_is_the_plain_reference_step():
    f = sizes()
    got = compare(f, batches(f))
    assert all(got[k] <= TOL[k] for k in TOL), got


def _no_commit(model):
    return contextlib.nullcontext()


def _no_acgan(real_logits, real_labels, fake_logits, fake_labels, n):
    zero = real_logits.sum() * 0.0
    return zero, zero


@pytest.mark.parametrize("fault,name,fake", [
    ("sn_gap", "commit_sn", _no_commit),
    ("loss_gap", "acgan_focal_loss", _no_acgan)])
def test_a_step_without_a_part_fails_the_comparison(monkeypatch, fault, name,
                                                    fake):
    monkeypatch.setattr(port, name, fake)
    f = sizes()
    got = compare(f, batches(f))
    assert got[fault] > 1e3 * TOL[fault], got


def test_a_traced_step_records_its_updates_and_changes_nothing():
    f = sizes(disc_steps=2)
    data = batches(f, 2)
    tracer = Tracer()
    plain, s_plain = port_steps(f, data, torch.float32)
    traced, s_traced = port_steps(f, data, torch.float32, trace=tracer)
    assert plain["losses"] == traced["losses"]
    for a, b in ((s_plain.generator, s_traced.generator),
                 (s_plain.discriminator, s_traced.discriminator)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[n], sb[n]) for n in sa)
    for a, b in ((s_plain.g_opt, s_traced.g_opt),
                 (s_plain.d_opt, s_traced.d_opt)):
        assert all(torch.equal(a.nu[n], b.nu[n]) for n in a.nu)

    events = tracer.events
    by_id = {e.id: e for e in events}
    roots = [e for e in events if e.parent is None]
    assert [(r[0], r.req, r.counts) for r in roots] == [
        ("step", 0, {"d_updates": 2}), ("step", 1, {"d_updates": 2})]
    for root in roots:
        kids = [e for e in events if e.parent == root.id]
        assert [k[0] for k in kids] == ["d_update", "d_update", "g_update"]
        for k in kids:
            inner = [e[0] for e in events if e.parent == k.id]
            part = k[0][0]
            assert inner == [f"{part}_forward", f"{part}_backward", "adam"]
            assert all(e.req == root.req for e in events
                       if e.parent == k.id)
        assert all(root[1] <= k[1] <= k[2] <= root[2] for k in kids)
    # the step's own draws, when none are passed in
    step = port.make_fg_gan_train_step(FGGanConfig(**f), seed=SEED,
                                       trace=tracer)
    tracer.clear()
    bd, bg = data[0]
    step(port_state(f, torch.float32), device_batch(bd, torch.float32),
         device_batch(bg, torch.float32))
    root = [e for e in tracer.events if e.parent is None][0]
    assert [e[0] for e in tracer.events if e.parent == root.id][0] == "draws"
    assert all(by_id[e.parent][0] != "adam" for e in events
               if e.parent in by_id)
