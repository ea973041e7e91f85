"""Port parity of the FG GAN variants (``models/fg_gan_variants.py``,
``models/fg_gan.py`` with ``num_blocks`` > 1 or without ``lstm_hybrid``)
against the JAX package's, at the sizes of
``tests/test_fg_gan_variants.py:15`` (batch 2, 64^2, base 4).  JAX's flax
variables go through the bridge into the port's modules; torch runs on
one thread.

Tolerances, with the max-abs differences measured on the CPU:
- the G and D forwards of Pix2Pix, Residual, MRU with ``num_blocks=2`` and
  MRU without the text fusion: 1e-4 of each output's largest magnitude,
  against JAX and against a float64 evaluation of the port's module.  The
  Residual generator's 31 batch-stats blocks make float32 itself uncertain
  beyond that: JAX's output is 2.3e-4 from the float64 evaluation (the
  port's 2.1e-4).  Where JAX is further than 1e-4 from it, the port may be
  1.5 x as far, and 2.5 x from JAX; JAX must be within 1e-3 of it (a
  structural fault moves the output by 1e-1 or more);
- one train step of Pix2Pix and of Residual from the same state, batches
  and JAX's draws (``tests/test_torch_train_fg_gan.py``): losses within
  1e-5 relative; the committed spectral-norm vector of ``ac_logits``
  within 1e-5; the gradients, read from Adam's first moment (with b1 = 0
  it is the step's gradient), against the port's step in float64: each
  leaf within 2e-2 of its largest magnitude (floored at 1e-3 of its
  model's largest), or 1.5 x JAX's own distance where that is larger;
  JAX's gradients within 5e-2 of the float64 step's largest element (a
  structural fault moves whole leaves by their own size).  Under the
  suite's XLA flags (``tests/conftest.py``) JAX's Residual G gradient is
  2.5e-2 of that from the float64 step (in ``encoder_2_0/block_3_conv``)
  and 6.5e-2 of its own size in ``encoder_1_bn/offset``, whose true
  gradient nearly cancels; the port's is within 1.6e-4 of it;
- MRU with ``num_blocks=2``: JAX's jitted train step takes minutes to
  compile (``tests/test_fg_gan_variants.py:58-64``), so the gradients of a
  fixed linear read-out of G's image and of D's two outputs are compared
  instead, within 2e-2 of each leaf's largest magnitude, floored at 1e-3
  of the model's largest."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchyscenecolorization_tpu.config import FGGanConfig
from sketchyscenecolorization_tpu.train import fg_gan as j_fg
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.models import fg_gan
from sketchyscenecolorization_torch.train import (create_fg_gan_state,
                                                  make_fg_gan_train_step)
from sketchyscenecolorization_torch.train.optim import AdamState
from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                         flatten_tree,
                                                         load_jax_tree)
from test_torch_train_fg_gan import (_adam_state, _jax_params, _torch_batch,
                                     jax_draws)

BASE_KW = dict(batch_size=2, image_size=64, vocab_size=10, max_len=4,
               base_channels=4, noise_dim=8, max_iters=100)
VARIANTS = {"Pix2Pix": dict(block_type="Pix2Pix"),
            "Residual": dict(block_type="Residual"),
            "MRU_blocks2": dict(num_blocks=2),
            "MRU_no_text": dict(lstm_hybrid=False)}
FWD_REL, FWD_CEIL = 1e-4, 1e-3
LOSS_RTOL, SN_ATOL, GRAD_REL = 1e-5, 1e-5, 2e-2
EXACT_CEIL, ERR_RATIO = 5e-2, 1.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg, seed=0):
    """``tests/test_fg_gan_variants.py:_batch``, as NumPy."""
    rng = np.random.RandomState(seed)
    s, b = cfg.image_size, cfg.batch_size
    return {
        "images": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "sketches": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "images_d": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "class_id": rng.randint(0, cfg.num_classes, (b,)).astype(np.int32),
        "class_id_d": rng.randint(0, cfg.num_classes, (b,)).astype(np.int32),
        "tokens": rng.randint(0, cfg.vocab_size,
                              (b, cfg.max_len)).astype(np.int32),
    }


def _build(name):
    """(name, JAX config, JAX G and D with their variables, the port's G
    and D loaded from them)."""
    kw = dict(BASE_KW, **VARIANTS[name])
    cfg = FGGanConfig(**kw)
    gen, disc = j_fg.build_models(cfg)
    b = _batch(cfg)
    g_vars = jax.jit(gen.init)(
        jax.random.PRNGKey(0), b["sketches"], b["tokens"], b["class_id"],
        jnp.zeros((cfg.batch_size, cfg.noise_dim), jnp.float32))
    d_vars = jax.jit(disc.init)(jax.random.PRNGKey(1), b["sketches"],
                                b["images"], b["class_id"])
    tcfg = tconfig.FGGanConfig(**kw)
    tgen = load_jax_tree(fg_gan.build_generator(tcfg),
                         jax.tree.map(np.asarray, g_vars["params"]))
    tdisc = load_jax_tree(fg_gan.build_discriminator(tcfg),
                          jax.tree.map(np.asarray, d_vars["params"]),
                          sn=jax.tree.map(np.asarray, d_vars.get("sn", {})))
    return name, cfg, (gen, g_vars), (disc, d_vars), tgen, tdisc


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    return _build(request.param)


def _noise(cfg, seed=5):
    return np.random.RandomState(seed).randn(
        cfg.batch_size, cfg.noise_dim).astype(np.float32)


def _close(got, want, exact, what):
    """Port and JAX float32 against each other and against the port's
    float64 evaluation, relative to the output's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = np.abs(exact).max()
    own = np.abs(want - exact).max() / top
    err = np.abs(got - exact).max() / top
    vs = np.abs(got - want).max() / top
    print(f"{what}: port vs JAX {vs:.3g}; from float64: port {err:.3g}, "
          f"JAX {own:.3g}")
    assert own <= FWD_CEIL, (what, own)
    assert err <= max(FWD_REL, ERR_RATIO * own), (what, err)
    assert vs <= max(FWD_REL, (1 + ERR_RATIO) * own), (what, vs)


def test_generator_and_discriminator_forwards_match_jax(variant):
    name, cfg, (gen, g_vars), (disc, d_vars), tgen, tdisc = variant
    b, noise = _batch(cfg, 1), _noise(cfg)
    want = gen.apply(g_vars, b["sketches"], b["tokens"], b["class_id"],
                     noise)
    tb = _torch_batch(b)
    args = (tb["sketches"], tb["tokens"].long(), tb["class_id"].long(),
            torch.from_numpy(noise))
    with torch.no_grad():
        got = tgen(*args)
        exact = copy.deepcopy(tgen).double()(*_doubles(args))
    assert got.shape == (cfg.batch_size, cfg.image_size, cfg.image_size, 3)
    _close(got.numpy(), want, exact.numpy(), f"{name} G")
    j_outs = disc.apply(d_vars, b["sketches"], b["images"], b["class_id"])
    args = (tb["sketches"], tb["images"], tb["class_id"])
    with torch.no_grad():
        t_outs = tdisc(*args)
        exact = copy.deepcopy(tdisc).double()(*_doubles(args))
    for t, j, e, part in zip(t_outs, j_outs, exact, ("patch", "logits")):
        _close(t.numpy(), j, e.numpy(), f"{name} D {part}")
    if name == "MRU_blocks2":
        names = {k for k, _ in tgen.named_parameters()}
        assert {"initial_hidden_state_1", "initial_decoder_state_1"} <= names
    if name == "MRU_no_text":
        assert not hasattr(tgen, "TextLSTM")


def _doubles(args):
    return [a.double() if a.is_floating_point() else a for a in args]


def _grad_close(got, want, what):
    assert sorted(got) == sorted(want), what
    top = max(np.abs(w).max() for w in want.values())
    worst = 0.0
    for leaf, w in want.items():
        scale = max(np.abs(w).max(), 1e-3 * top)
        err = np.abs(got[leaf] - w).max() / scale
        worst = max(worst, err)
        assert err <= GRAD_REL, (what, leaf, err)
    print(f"{what}: worst leaf error {worst:.3g} of its scale")


def test_blocks2_gradients_match_jax():
    """The gradients of fixed linear read-outs of G's image and of D's
    patch logits and class logits (each a jitted ``jax.grad`` of seconds;
    the whole train step is what takes minutes)."""
    name, cfg, (gen, g_vars), (disc, d_vars), tgen, tdisc = \
        _build("MRU_blocks2")
    b, noise = _batch(cfg, 2), _noise(cfg, 6)
    rng = np.random.RandomState(7)
    r_img = rng.randn(cfg.batch_size, cfg.image_size, cfg.image_size,
                      3).astype(np.float32)
    g_grads = jax.jit(jax.grad(lambda p: jnp.sum(gen.apply(
        {"params": p}, b["sketches"], b["tokens"], b["class_id"],
        noise) * r_img)))(g_vars["params"])
    d_grads = jax.jit(jax.grad(lambda p: sum(
        jnp.sum(o * 0.5 ** i) for i, o in enumerate(disc.apply(
            {"params": p, "sn": d_vars["sn"]}, b["sketches"],
            b["images"], b["class_id"])))))(d_vars["params"])
    tb = _torch_batch(b)
    tgen.zero_grad()
    torch.sum(tgen(tb["sketches"], tb["tokens"].long(),
                   tb["class_id"].long(), torch.from_numpy(noise))
              * torch.from_numpy(r_img)).backward()
    tdisc.zero_grad()
    sum(torch.sum(o * 0.5 ** i) for i, o in enumerate(
        tdisc(tb["sketches"], tb["images"], tb["class_id"]))).backward()
    for module, grads, what in ((tgen, g_grads, "G"), (tdisc, d_grads, "D")):
        got = _jax_params(module, {k: p.grad for k, p in
                                   module.named_parameters()})
        _grad_close(got, flatten_tree(jax.tree.map(np.asarray, grads)),
                    f"{name} {what}")


def _double(tree):
    return {k: (v.double() if v.is_floating_point() else v)
            for k, v in tree.items()}


def _exact_step(tcfg, state, batch_d, batch_g, draws):
    """The port's step on a float64 copy of ``state``: its Adam first
    moments, in the JAX layout."""
    state = copy.deepcopy(state)
    for module in (state.generator, state.discriminator):
        module.double()
    state.g_opt = AdamState.zeros(dict(state.generator.named_parameters()))
    state.d_opt = AdamState.zeros(
        dict(state.discriminator.named_parameters()))
    state, _ = make_fg_gan_train_step(tcfg)(
        state, _double(_torch_batch(batch_d)), _double(_torch_batch(batch_g)),
        draws={"d": [_double(d) for d in draws["d"]],
               "g": _double(draws["g"])})
    return [_jax_params(copy.deepcopy(m).float(),
                        {k: v.float() for k, v in opt.mu.items()})
            for m, opt in ((state.generator, state.g_opt),
                           (state.discriminator, state.d_opt))]


@pytest.mark.parametrize("block_type", ["Pix2Pix", "Residual"])
def test_variant_train_step_matches_jax(block_type):
    """One step of each variant from the port's fresh state (exported to
    JAX), the same batches and JAX's draws.  The gradients are also held
    against the port's step in float64: the Residual variant's batch-stats
    blocks make float32 itself uncertain at the 1e-2 level in some leaves,
    and there each leaf of the port may be as far from the float64 step as
    1.5 x JAX's own distance from it."""
    kw = dict(BASE_KW, block_type=block_type)
    cfg, tcfg = FGGanConfig(**kw), tconfig.FGGanConfig(**kw)
    state = create_fg_gan_state(tcfg, seed=3, device="cpu")
    gen, disc = state.generator, state.discriminator
    opt_g, opt_d = j_fg.make_optimizers(cfg)
    g_params, d_params = export_jax_tree(gen), export_jax_tree(disc)
    j_state = j_fg.FGGanTrainState(
        g_params=g_params, d_params=d_params,
        d_sn=export_jax_tree(disc, "sn"), g_opt_state=opt_g.init(g_params),
        d_opt_state=opt_d.init(d_params), step=jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(7)
    batch_d, batch_g = _batch(cfg, 0), _batch(cfg, 1)
    draws = jax_draws(cfg, key, 0)
    exact = _exact_step(tcfg, state, batch_d, batch_g, draws)
    j_state, j_metrics = j_fg.make_fg_gan_train_step(cfg, donate=False)(
        j_state, batch_d, batch_g, key)
    state, t_metrics = make_fg_gan_train_step(tcfg)(
        state, _torch_batch(batch_d), _torch_batch(batch_g), draws=draws)
    for k in ("loss_d", "loss_g", "recon_l1"):
        print(f"{block_type} {k}: port {float(t_metrics[k]):.8g} JAX "
              f"{float(j_metrics[k]):.8g}")
        np.testing.assert_allclose(t_metrics[k].numpy(),
                                   np.asarray(j_metrics[k]), rtol=LOSS_RTOL,
                                   atol=0, err_msg=k)
    assert not bool(t_metrics["nan"])
    j_sn = flatten_tree(jax.tree.map(np.asarray, j_state.d_sn))
    t_sn = flatten_tree(export_jax_tree(disc, "sn"))
    assert sorted(t_sn) == sorted(j_sn) == ["ac_logits/u"]
    np.testing.assert_allclose(t_sn["ac_logits/u"], j_sn["ac_logits/u"],
                               rtol=0, atol=SN_ATOL)
    for (module, opt, j_opt, what), ex in zip(
            ((gen, state.g_opt, j_state.g_opt_state, "G"),
             (disc, state.d_opt, j_state.d_opt_state, "D")), exact):
        got = _jax_params(module, opt.mu)
        want = flatten_tree(jax.tree.map(np.asarray, _adam_state(j_opt).mu))
        assert sorted(got) == sorted(want) == sorted(ex)
        top = max(np.abs(e).max() for e in ex.values())
        structural = max(np.abs(want[k] - e).max() for k, e in ex.items())
        assert structural <= EXACT_CEIL * top, (what, structural / top)
        worst = (0.0, 0.0, "")
        for leaf, e in ex.items():
            scale = max(np.abs(e).max(), 1e-3 * top)
            own = np.abs(want[leaf] - e).max() / scale
            err = np.abs(got[leaf] - e).max() / scale
            assert err <= max(GRAD_REL, ERR_RATIO * own), (what, leaf, err)
            worst = max(worst, (err, own, leaf))
        print(f"{block_type} {what} step gradient: worst leaf {worst[2]} "
              f"{worst[0]:.3g} from float64 (JAX {worst[1]:.3g})")


def test_cli_fg_gan_trains_the_residual_variant(tmp_path, monkeypatch):
    """``cli_fg_gan --mode train --block_type Residual --device cpu`` at
    base 4 and 64^2: two steps, resumed to three (a snapshot at the end of
    each launch); the snapshot holds the
    Residual pair."""
    import functools
    import json
    import os

    from sketchyscenecolorization_torch import cli_fg_gan
    from sketchyscenecolorization_torch.utils.checkpoint import (
        list_checkpoint_steps, restore_checkpoint)
    from test_torch_gan_harness import write_fg_data
    monkeypatch.setattr(cli_fg_gan, "FGGanConfig", functools.partial(
        tconfig.FGGanConfig, base_channels=4, noise_dim=8))
    base = str(tmp_path / "data")
    write_fg_data(base)
    common = ["--data_base_dir", base, "--small_img", "1", "--device", "cpu",
              "--block_type", "Residual"]
    run = str(tmp_path / "run")
    assert cli_fg_gan.main(["--mode", "train", "--resume_from", run,
                            "--max_iter_step", "2"] + common) == 0
    assert cli_fg_gan.main(["--mode", "train", "--resume_from", run,
                            "--max_iter_step", "3"] + common) == 0
    assert list_checkpoint_steps(os.path.join(run, "snapshot")) == [2, 3]
    assert json.load(open(os.path.join(run, "params.json")))[
        "block_type"] == "Residual"
    saved = restore_checkpoint(os.path.join(run, "snapshot", "step_3"),
                               map_location="cpu")
    assert "decoder_5_0.block_1_deconv.filter" in saved["generator"]
    assert set(saved["discriminator"]) >= {"layer_5_out.filter",
                                           "ac_logits.u"}


def test_build_session_serves_bf16_variants(tmp_path):
    """``build_session`` with every model at bfloat16, the SegNet matcher
    and the Pix2Pix FG generator serves a BG and a routed FG command."""
    import os

    from sketchyscenecolorization_torch.pipeline import build_session
    from test_pipeline import small_config, write_fixtures
    from test_torch_session import port_config
    write_fixtures(str(tmp_path / "examples"))
    cfg = port_config(small_config(tmp_path))
    cfg = dataclasses.replace(
        cfg, matching=dataclasses.replace(cfg.matching, backbone="segnet",
                                          compute_dtype="bfloat16"),
        fg_gan=dataclasses.replace(cfg.fg_gan, block_type="Pix2Pix",
                                   compute_dtype="bfloat16"),
        bg_gan=dataclasses.replace(cfg.bg_gan, compute_dtype="bfloat16"))
    session = build_session(cfg, seed=0, device="cpu")
    assert type(session.fg.model).__name__ == "Pix2PixFGGenerator"
    assert session.matching.model.scope == "SegNet"
    out = session.colorize(7, "the sky is blue")
    assert os.path.isfile(out)
    out = session.colorize_foreground(7, "the bus is yellow", [0], "7_2.png",
                                      "7_1.png")
    assert os.path.isfile(out)
    assert session.colorize(7, "the bus is red").endswith(".png")
