"""Port parity of the BG GAN train step (``sketchyscenecolorization_torch/train/bg_gan.py``)
against ``make_bg_gan_train_step(cfg, donate=False)`` at
``tests/test_train.py:BG_SMALL`` (64^2, ngf = ndf = 4, no
``multi_residual``, the residual discriminator): the port's fresh models
go through the bridge into a JAX ``BGGanTrainState`` and both take two
steps on seeded batches.  As in ``tests/test_torch_train_fg_gan.py``, the
port is loaded with JAX's state after step 1 before step 2 (Adam's first
update moves every element by about +-lr, the rounding-driven ones
differently on the two sides).

Compared after each step, with the tolerances stated:
- the raw losses and their EMAs (``ema/*``; the first step sets them, the
  second mixes 0.99 / 0.01): relative 1e-5 (measured 1.0e-6);
- the gradients, read from Adam's first moment (b1 = 0.5: the moment is
  half the gradient after step 1, and half the old moment plus half the
  gradient after step 2, from the same old moment): 1e-2 of each leaf's
  largest magnitude, floored at 1e-3 of its model's largest (measured
  3.9e-4);
- the parameters, in units of lr: an element whose moment is at least
  1e-5 on both sides within 1e-2 lr (measured 1.8e-3); every element
  within Adam's bound, 2 sqrt(1 - 0.999^k) / (1 - 0.5^k) / sqrt(0.001) lr
  at update k.
With ``remat`` (``torch.utils.checkpoint`` on the generator) a step gives
the same losses and parameters, and the same launches of the fusion's
forward: three generator forwards a step instead of two."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchyscenecolorization_tpu.config import BGGanConfig
from sketchyscenecolorization_tpu.train import bg_gan as j_bg
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.ops import mlstm
from sketchyscenecolorization_torch.train import (create_bg_gan_state,
                                                  make_bg_gan_train_step)
from sketchyscenecolorization_torch.train.bg_gan import LOSS_KEYS
from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                         flatten_tree,
                                                         load_jax_tree)
from test_torch_train_fg_gan import (_adam_state, _jax_params,  # noqa: F401
                                     one_torch_thread)

SMALL_KW = dict(batch_size=2, image_size=64, vocab_size=8, max_len=4, ngf=4,
                ndf=4, multi_residual=False, max_steps=100)
LOSS_RTOL, GRAD_REL = 1e-5, 1e-2
CLEAR_MU, UPDATE_ATOL = 1e-5, 1e-2


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    s, b = cfg.image_size, cfg.batch_size
    tokens = rng.randint(1, cfg.vocab_size, (b, cfg.max_len))
    tokens[0, :2] = 0                                 # front padding
    return {"inputs": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
            "targets": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
            "tokens": tokens.astype(np.int32),
            "labels": rng.randint(0, 3, (b, s, s)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _sync_to_jax(state, j_state):
    """Load a JAX ``BGGanTrainState`` into the port's state."""
    tree = lambda t: jax.tree.map(np.asarray, t)      # noqa: E731
    for module, opt, params, j_opt in (
            (state.generator, state.g_opt, j_state.g_params,
             j_state.g_opt_state),
            (state.discriminator, state.d_opt, j_state.d_params,
             j_state.d_opt_state)):
        load_jax_tree(module, tree(params))
        adam = _adam_state(j_opt)
        for ours, theirs in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
            named = dict(load_jax_tree(copy.deepcopy(module),
                                       tree(theirs)).named_parameters())
            for name, value in named.items():
                ours[name].copy_(value.detach())
        opt.count = int(adam.count)
    for k in LOSS_KEYS:
        state.ema_losses[k].fill_(float(j_state.ema_losses[k]))
    state.step = int(j_state.step)


@pytest.fixture(scope="module")
def two_steps():
    cfg, tcfg = BGGanConfig(**SMALL_KW), tconfig.BGGanConfig(**SMALL_KW)
    state = create_bg_gan_state(tcfg, seed=5, device="cpu")
    gen, disc = state.generator, state.discriminator
    opt = j_bg.make_optimizer(cfg)
    g_params, d_params = export_jax_tree(gen), export_jax_tree(disc)
    j_state = j_bg.BGGanTrainState(
        g_params=g_params, d_params=d_params, g_opt_state=opt.init(g_params),
        d_opt_state=opt.init(d_params),
        ema_losses={k: jnp.zeros((), jnp.float32) for k in LOSS_KEYS},
        step=jnp.zeros((), jnp.int32))
    j_step = j_bg.make_bg_gan_train_step(cfg, donate=False)
    t_step = make_bg_gan_train_step(tcfg)
    records, before = [], []
    for i in range(2):
        batch = _batch(cfg, i)
        if i:
            _sync_to_jax(state, j_state)
        before.append({"g": _jax_params(gen), "d": _jax_params(disc)})
        j_state, j_metrics = j_step(j_state, batch)
        state, t_metrics = t_step(state, _torch_batch(batch))
        tree = lambda t: flatten_tree(jax.tree.map(np.asarray, t))  # noqa
        records.append({
            "jax": {"metrics": jax.tree.map(np.asarray, j_metrics),
                    "g": tree(j_state.g_params), "d": tree(j_state.d_params),
                    "mu_g": tree(_adam_state(j_state.g_opt_state).mu),
                    "mu_d": tree(_adam_state(j_state.d_opt_state).mu)},
            "port": {"metrics": {k: v.numpy() for k, v in t_metrics.items()},
                     "g": _jax_params(gen), "d": _jax_params(disc),
                     "mu_g": _jax_params(gen, state.g_opt.mu),
                     "mu_d": _jax_params(disc, state.d_opt.mu)}})
    assert state.step == 2 and int(j_state.step) == 2
    return cfg, records, before


def test_losses_and_emas_match_jax(two_steps):
    _, records, _ = two_steps
    for i, rec in enumerate(records):
        j_m, t_m = rec["jax"]["metrics"], rec["port"]["metrics"]
        assert sorted(j_m) == sorted(t_m)
        for key, want in j_m.items():
            if key == "nan":
                assert not want and not t_m[key]
                continue
            np.testing.assert_allclose(t_m[key], want, rtol=LOSS_RTOL,
                                       atol=0, err_msg=f"step {i + 1} {key}")
        if i == 0:
            for k in LOSS_KEYS:
                assert t_m[f"ema/{k}"] == t_m[k]


def test_gradients_match_jax(two_steps):
    _, records, _ = two_steps
    for i, rec in enumerate(records):
        for side in ("mu_g", "mu_d"):
            want, got = rec["jax"][side], rec["port"][side]
            assert sorted(want) == sorted(got)
            top = max(np.abs(w).max() for w in want.values())
            for name, w in want.items():
                scale = max(np.abs(w).max(), 1e-3 * top)
                err = np.abs(got[name] - w).max() / scale
                assert err <= GRAD_REL, (i + 1, side, name, err)


def test_updated_parameters_match_jax(two_steps):
    cfg, records, before = two_steps
    b1, b2 = cfg.beta1, 0.999
    for i, rec in enumerate(records):
        k = i + 1
        bound = 2 * np.sqrt(1 - b2 ** k) / (1 - b1 ** k) / np.sqrt(1 - b2)
        for side in ("g", "d"):
            want, got = rec["jax"][side], rec["port"][side]
            mu_j, mu_t = rec["jax"]["mu_" + side], rec["port"]["mu_" + side]
            for name, w in want.items():
                diff = np.abs(got[name] - w) / cfg.lr
                assert diff.max() <= bound, (k, side, name, diff.max())
                clear = (np.abs(mu_j[name]) >= CLEAR_MU) & \
                    (np.abs(mu_t[name]) >= CLEAR_MU)
                if clear.any():
                    worst = float(diff[clear].max())
                    assert worst <= UPDATE_ATOL, (k, side, name, worst)
            moved = sum(int((w != before[i][side][n]).sum())
                        for n, w in want.items())
            assert moved > 0.5 * sum(w.size for w in want.values())


def test_remat_gives_the_same_step(monkeypatch):
    tcfg = tconfig.BGGanConfig(**SMALL_KW)
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        state = create_bg_gan_state(cfg, seed=5, device="cpu")
        calls = []
        forward = state.generator.forward
        monkeypatch.setattr(state.generator, "forward",
                            lambda *a: calls.append(1) or forward(*a))
        state, metrics = make_bg_gan_train_step(cfg)(
            state, _torch_batch(_batch(cfg, 0)))
        runs.append((metrics, _jax_params(state.generator),
                     _jax_params(state.discriminator), len(calls)))
    (m0, g0, d0, n0), (m1, g1, d1, n1) = runs
    assert (n0, n1) == (2, 3)
    for key in LOSS_KEYS:
        assert float(m0[key]) == float(m1[key]), key
    for a, b in ((g0, g1), (d0, d1)):
        for name in a:
            np.testing.assert_allclose(b[name], a[name], rtol=0, atol=1e-7,
                                       err_msg=name)
    assert mlstm.mlstm_cuda.launches == 0     # the CPU takes the plain path
