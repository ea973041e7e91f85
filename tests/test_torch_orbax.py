"""Serving the JAX package's orbax training snapshots in the port, through
``scripts/orbax_to_torch.py``, on the CPU.

JAX ``utils/checkpoint.save_checkpoint`` writes a matching, a FG GAN and
a BG GAN train state (``MatchingTrainState``, ``FGGanTrainState`` with its
spectral-norm vectors, ``BGGanTrainState``; their optimizer states from
the JAX optimizers) at the sizes of ``tests/test_pipeline.py:small_config``;
the parameters are those of fresh port modules, so the test knows what
each snapshot must give back.  The script converts the three, and the
port's ``build_session`` on the CPU restores them: every module's state
equals the saved parameters bit for bit (the discriminators' too, with
``u``).  Against JAX engines built on the same parameters, with the
tolerances of ``tests/test_torch_session.py`` and the parity tests it
relies on (measured on the CPU in parentheses): the matching ``up``
logits within 1e-5 max-abs (1.9e-7) and the masks equal wherever
|logit - threshold| > 1e-6; the FG generator within 2e-5 (2.8e-6); the
BG engine's u8 background within 1 LSB (1) and its region labels equal.
The script's CLI, given the JAX run's config changes as JSON and a step
directory, converts that step, to the same tensors."""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchyscenecolorization_tpu.pipeline import engines as jeng
from sketchyscenecolorization_tpu.pipeline.factory import \
    _placeholder_vocab
from sketchyscenecolorization_tpu.text import colorization_encode
from sketchyscenecolorization_tpu.train import bg_gan as jbg
from sketchyscenecolorization_tpu.train import fg_gan as jfg
from sketchyscenecolorization_tpu.train.matching import create_matching_state
from sketchyscenecolorization_tpu.utils.checkpoint import save_checkpoint
from sketchyscenecolorization_torch.models import bg_gan, fg_gan
from sketchyscenecolorization_torch.models.rmi import RMI
from sketchyscenecolorization_torch.pipeline.engines import PIXEL_MU
from sketchyscenecolorization_torch.pipeline.factory import build_session
from sketchyscenecolorization_torch.utils.bridge import export_jax_tree
from sketchyscenecolorization_torch.utils.checkpoint import (
    list_checkpoint_steps, restore_checkpoint)
from test_pipeline import small_config, write_fixtures
from test_torch_session import port_config
from test_torch_train_fg_gan import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import orbax_to_torch  # noqa: E402

IMAGE_ID = 7
STEPS = {"matching": 5, "fg": 3, "bg": 4}
UP_ATOL = 1e-5
THRESH_MARGIN = 1e-6
FG_ATOL = 2e-5


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _train_states(jcfg, tcfg):
    """JAX train states on fresh port modules' parameters, and the port
    modules, by kind."""
    g = torch.Generator()
    modules = {
        "matching": (RMI(tcfg.matching, g.manual_seed(1)),),
        "fg": (fg_gan.build_generator(tcfg.fg_gan, g.manual_seed(2)),
               fg_gan.build_discriminator(tcfg.fg_gan, g.manual_seed(3))),
        "bg": (bg_gan.build_generator(tcfg.bg_gan, g.manual_seed(4)),
               bg_gan.build_discriminator(tcfg.bg_gan, g.manual_seed(5))),
    }
    m = _jnp(export_jax_tree(modules["matching"][0]))
    states = {"matching": create_matching_state(m, jcfg.matching)._replace(
        step=jnp.asarray(STEPS["matching"], jnp.int32))}
    fg_g, fg_d = (_jnp(export_jax_tree(mod)) for mod in modules["fg"])
    opt_g, opt_d = jfg.make_optimizers(jcfg.fg_gan)
    states["fg"] = jfg.FGGanTrainState(
        g_params=fg_g, d_params=fg_d,
        d_sn=_jnp(export_jax_tree(modules["fg"][1], "sn")),
        g_opt_state=opt_g.init(fg_g), d_opt_state=opt_d.init(fg_d),
        step=jnp.asarray(STEPS["fg"], jnp.int32))
    bg_g, bg_d = (_jnp(export_jax_tree(mod)) for mod in modules["bg"])
    opt = jbg.make_optimizer(jcfg.bg_gan)
    states["bg"] = jbg.BGGanTrainState(
        g_params=bg_g, d_params=bg_d, g_opt_state=opt.init(bg_g),
        d_opt_state=opt.init(bg_d),
        ema_losses={k: jnp.zeros((), jnp.float32) for k in jbg.LOSS_KEYS},
        step=jnp.asarray(STEPS["bg"], jnp.int32))
    return states, modules


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """JAX snapshots written (two steps each), the newest converted by the
    script, and a port session built on the conversions."""
    tmp = tmp_path_factory.mktemp("orbax")
    write_fixtures(str(tmp / "examples"), image_id=IMAGE_ID)
    jcfg = small_config(tmp)
    tcfg = port_config(jcfg)
    states, modules = _train_states(jcfg, tcfg)
    out = {}
    for kind, state in states.items():
        root = str(tmp / "orbax" / kind)
        earlier = state._replace(step=jnp.asarray(STEPS[kind] - 1,
                                                  jnp.int32))
        save_checkpoint(root, STEPS[kind] - 1, jax.device_get(earlier))
        save_checkpoint(root, STEPS[kind], jax.device_get(state))
        out[kind] = str(tmp / "torch" / kind)
        cfg = {"matching": tcfg.matching, "fg": tcfg.fg_gan,
               "bg": tcfg.bg_gan}[kind]
        written = orbax_to_torch.convert_snapshot(root, kind, out[kind], cfg)
        assert os.path.basename(written) == f"step_{STEPS[kind]}"
    cfg = dataclasses.replace(tcfg, pipeline=dataclasses.replace(
        tcfg.pipeline, match_ckpt_dir=out["matching"],
        fg_ckpt_dir=out["fg"], bg_ckpt_dir=out["bg"]))
    session = build_session(cfg, seed=0, device="cpu")
    return tmp, jcfg, states, modules, out, session


def test_converted_snapshots_hold_the_saved_parameters(converted):
    _, _, _, modules, out, session = converted
    served = {"matching": session.matching.model, "fg": session.fg.model,
              "bg": session.bg.model}
    for kind, mods in modules.items():
        saved = restore_checkpoint(os.path.join(out[kind],
                                                f"step_{STEPS[kind]}"))
        assert saved["step"] == STEPS[kind]
        keys = ("model",) if kind == "matching" else ("generator",
                                                      "discriminator")
        assert sorted(saved) == sorted(keys + ("step",))
        for key, mod in zip(keys, mods):
            want = mod.state_dict()
            assert sorted(saved[key]) == sorted(want), (kind, key)
            for name, value in want.items():
                assert torch.equal(saved[key][name], value), (kind, name)
        for name, value in mods[0].state_dict().items():
            assert torch.equal(served[kind].state_dict()[name], value), name


def test_matching_logits_match_the_jax_engine(converted):
    _, jcfg, states, _, _, session = converted
    engine = jeng.MatchingEngine(
        jcfg.matching, states["matching"].params,
        _placeholder_vocab(jcfg.matching.vocab_size),
        jcfg.pipeline.score_thresh)
    sketch = session._state(IMAGE_ID).sketch
    texts = ["the bus", "the grass on the left"]
    image = (sketch.astype(np.float32) - PIXEL_MU).astype(np.float32)
    words, lens = engine.encode_texts(texts)
    want = np.asarray(engine._fuse(
        engine.params, engine._extract(engine.params,
                                       jnp.asarray(image[None])),
        jnp.asarray(words), jnp.asarray(lens)))
    port = session.matching
    got = port.fuse_logits(port.extract_visual_dev(
        torch.from_numpy(image[None])), *port.encode_texts(texts)).numpy()
    err = float(np.abs(got - want).max())
    print(f"up logits: max-abs {err:.2e}")
    assert err <= UP_ATOL
    clear = np.abs(want[..., 0] - engine.score_thresh) > THRESH_MARGIN
    got_masks = port.predict_masks(sketch, texts)
    want_masks = engine.predict_masks(sketch, texts)
    np.testing.assert_array_equal(got_masks[clear], want_masks[clear])


def test_fg_generator_matches_the_jax_engine(converted):
    _, jcfg, states, _, _, session = converted
    jcfg = jcfg.fg_gan
    engine = jeng.FGColorizeEngine(jcfg, states["fg"].g_params,
                                   _placeholder_vocab(jcfg.vocab_size))
    rng = np.random.RandomState(2)
    s = jcfg.image_size
    sketch = rng.uniform(-1, 1, (1, s, s, 3)).astype(np.float32)
    tokens = np.asarray([colorization_encode(
        "the bus is yellow", engine.vocab, jcfg.max_len)], np.int32)
    labels = np.array([4], np.int32)
    noise = rng.randn(1, jcfg.noise_dim).astype(np.float32)
    want = np.asarray(engine._forward(engine.g_params, *map(
        jnp.asarray, (sketch, tokens, labels, noise))))
    with torch.no_grad():
        got = session.fg.model(torch.from_numpy(sketch),
                               torch.from_numpy(tokens).long(),
                               torch.from_numpy(labels).long(),
                               torch.from_numpy(noise)).numpy()
    err = float(np.abs(got - want).max())
    print(f"fg generator: max-abs {err:.2e}")
    assert err <= FG_ATOL


def test_bg_engine_matches_the_jax_engine(converted):
    _, jcfg, states, _, _, session = converted
    jcfg = jcfg.bg_gan
    engine = jeng.BGColorizeEngine(jcfg, states["bg"].g_params,
                                   _placeholder_vocab(jcfg.vocab_size))
    fg = session._state(IMAGE_ID).sketch
    text = "the sky is blue and the ground is green"
    want, want_region = engine.colorize(fg, text)
    got, got_region = session.bg.colorize(fg, text)
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"bg: max u8 difference {diff.max()}")
    assert diff.max() <= 1
    np.testing.assert_array_equal(got_region, want_region)


def test_script_cli_converts_a_step(converted, tmp_path):
    tmp, _, _, _, out, _ = converted
    again = str(tmp_path / "bg")
    cfg = dict(image_size=64, vocab_size=16, max_len=8, ngf=4, ndf=4,
               multi_residual=False)
    for step in (STEPS["bg"] - 1, STEPS["bg"]):
        assert orbax_to_torch.main(
            ["--kind", "bg", "--orbax_dir",
             str(tmp / "orbax" / "bg" / f"step_{step}"), "--out_dir", again,
             "--config", json.dumps(cfg)]) == 0
    assert list_checkpoint_steps(again) == [STEPS["bg"] - 1, STEPS["bg"]]
    got = restore_checkpoint(os.path.join(again, f"step_{STEPS['bg']}"))
    want = restore_checkpoint(os.path.join(out["bg"], f"step_{STEPS['bg']}"))
    for key in ("generator", "discriminator"):
        for name, value in want[key].items():
            assert torch.equal(got[key][name], value), name
    with pytest.raises(FileNotFoundError):
        orbax_to_torch.snapshot_step(str(tmp_path / "nothing"))
