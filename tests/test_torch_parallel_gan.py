"""Data-parallel GAN training in the port on two CPU ranks over gloo
(``tests/torch_parallel_ranks.py:gan_dp``, ``fg_harness``), one row of the
global batch of 2 a rank, against single-process steps on the global
batch, as ``tests/test_train.py:279,297`` tie JAX's sharded steps to its
unsharded ones.

- FG GAN, default config (spectral norm): two steps against JAX's
  unsharded step from the same weights (the port's seeded models,
  bridged), batches and draws (JAX's, global; each rank takes its rows).
  Losses rtol 2e-4, 5e-4 at the free-running second step; after step 1
  the committed spectral-norm vectors within 1e-5, the gradients (Adam's
  first moment: b1 = 0) within 2e-2 of each leaf's largest magnitude,
  floored at 1e-3 of the model's largest, and the parameters as
  ``tests/test_torch_train_fg_gan.py`` holds them (an element whose
  gradient is at least 1e-5 on both sides within 1e-2 lr, every element
  within Adam's bound).
- FG GAN with DRAGAN and two D updates (the global batch's standard
  deviation, the clipping on summed gradients), on the step's own
  (seed, step) draws: against the port's single-process step, losses and
  gradients as above.
- FG GAN with the Pix2Pix discriminator and WGAN-GP: the penalty's
  double backward runs through the batch-stats BN's global moments, so
  the all-reduce's own backward must be differentiable; against the
  port's single-process step, losses and gradients as above.
- BG GAN: two steps against JAX's unsharded step; raw losses and EMAs
  rtol 2e-4 (5e-4 at step 2), gradients within 1e-2 of each leaf's
  largest, floored at 1e-3 of the model's largest.
- Every step leaves both ranks' parameters, spectral-norm vectors and
  moments bit-equal.
- ``train_fg_gan`` on the mesh for 2 steps, resumed to 3: only the first
  rank writes snapshots, the run resumes, and its metrics log has one
  line a step.
Each test prints the largest differences it measured (on this CPU: FG
losses 1.2e-6, gradients 5.8e-3, sn 2.4e-7, updates 7.5e-5 lr; DRAGAN
losses 1.3e-7, gradients 1.3e-3; Pix2Pix WGAN-GP losses 1.0e-7,
gradients 9.6e-7; BG losses 1.1e-6, gradients 3.7e-4)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from torch_parallel_launch import join_ranks, start_ranks
from sketchyscenecolorization_tpu.config import BGGanConfig, FGGanConfig
from sketchyscenecolorization_tpu.train import bg_gan as j_bg
from sketchyscenecolorization_tpu.train import fg_gan as j_fg
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.data import write_record_shard
from sketchyscenecolorization_torch.train import (create_bg_gan_state,
                                                  create_fg_gan_state,
                                                  make_fg_gan_train_step)
from sketchyscenecolorization_torch.train.bg_gan import LOSS_KEYS
from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                         load_jax_tree)
from sketchyscenecolorization_torch.utils.checkpoint import \
    list_checkpoint_steps
from test_torch_train_fg_gan import (ADAM_BOUND, CLEAR_GRAD, _adam_state,
                                     _jax_params, _port_tensors, jax_draws)

LOSS_RTOL, LOSS_RTOL_2 = 2e-4, 5e-4
FG_GRAD_REL, BG_GRAD_REL = 2e-2, 1e-2
SN_ATOL, UPDATE_ATOL = 1e-5, 1e-2
FG_KEY = 7


def _jax_fg(cfg, tcfg):
    """JAX's two unsharded FG steps from the port's fresh state: per step
    the metrics, and the state after it in the port's names."""
    state = create_fg_gan_state(tcfg, seed=ranks.FG_SEED, device="cpu")
    gen, disc = state.generator, state.discriminator
    opt_g, opt_d = j_fg.make_optimizers(cfg)
    g_params, d_params = export_jax_tree(gen), export_jax_tree(disc)
    j_state = j_fg.FGGanTrainState(
        g_params=g_params, d_params=d_params,
        d_sn=export_jax_tree(disc, "sn"), g_opt_state=opt_g.init(g_params),
        d_opt_state=opt_d.init(d_params), step=jnp.zeros((), jnp.int32))
    j_step = j_fg.make_fg_gan_train_step(cfg, donate=False)
    key = jax.random.PRNGKey(FG_KEY)
    steps = []
    for i in range(2):
        j_state, metrics = j_step(j_state, ranks.fg_batch(cfg, 2 * i),
                                  ranks.fg_batch(cfg, 2 * i + 1), key)
        tree = lambda t: jax.tree.map(np.asarray, t)    # noqa: E731
        load_jax_tree(gen, tree(j_state.g_params))
        load_jax_tree(disc, tree(j_state.d_params), sn=tree(j_state.d_sn))
        steps.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "g": {k: v.clone() for k, v in gen.state_dict().items()},
            "d": {k: v.clone() for k, v in disc.state_dict().items()},
            "mu_g": {k: v.detach().clone() for k, v in _port_tensors(
                gen, _adam_state(j_state.g_opt_state).mu).items()},
            "mu_d": {k: v.detach().clone() for k, v in _port_tensors(
                disc, _adam_state(j_state.d_opt_state).mu).items()}})
    return steps


def _port_fg(tcfg):
    """The port's single-process FG steps on the global batches."""
    state = create_fg_gan_state(tcfg, seed=ranks.FG_SEED, device="cpu")
    step = make_fg_gan_train_step(tcfg, seed=ranks.FG_SEED)
    steps = []
    for i in range(2):
        state, metrics = step(state, ranks.tensors(ranks.fg_batch(tcfg, 2 * i)),
                              ranks.tensors(ranks.fg_batch(tcfg, 2 * i + 1)))
        steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                      **ranks._gan_state(state)})
    return steps


def _jax_bg(cfg, tcfg):
    state = create_bg_gan_state(tcfg, seed=ranks.BG_SEED, device="cpu")
    gen, disc = state.generator, state.discriminator
    opt = j_bg.make_optimizer(cfg)
    g_params, d_params = export_jax_tree(gen), export_jax_tree(disc)
    j_state = j_bg.BGGanTrainState(
        g_params=g_params, d_params=d_params, g_opt_state=opt.init(g_params),
        d_opt_state=opt.init(d_params),
        ema_losses={k: jnp.zeros((), jnp.float32) for k in LOSS_KEYS},
        step=jnp.zeros((), jnp.int32))
    j_step = j_bg.make_bg_gan_train_step(cfg, donate=False)
    steps = []
    for i in range(2):
        j_state, metrics = j_step(j_state, ranks.bg_batch(cfg, i))
        steps.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "mu_g": {k: v.detach().clone() for k, v in _port_tensors(
                gen, _adam_state(j_state.g_opt_state).mu).items()},
            "mu_d": {k: v.detach().clone() for k, v in _port_tensors(
                disc, _adam_state(j_state.d_opt_state).mu).items()}})
    return steps


def _write_shard(path):
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 255, (4, 384, 384, 3), dtype=np.uint8)
    write_record_shard(path, [f"{i}.png" for i in range(4)], arr, arr,
                       "bus", np.zeros(4, np.int32), ["x"] * 4,
                       np.zeros((4, 4), np.uint8))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("gan")
    fg_cfg = FGGanConfig(**ranks.FG_KW)
    draws = [jax_draws(fg_cfg, jax.random.PRNGKey(FG_KEY), i)
             for i in range(2)]
    shard = _write_shard(str(out / "bus.npz"))
    contexts = [
        start_ranks(ranks.gan_dp, 2, f"file://{out}/rendezvous_dp",
                    args=(str(out), draws), threads=1),
        start_ranks(ranks.fg_harness, 2, f"file://{out}/rendezvous_harness",
                    args=(str(out), shard, str(out / "run")), threads=1)]
    want = {
        "fg": _jax_fg(fg_cfg, tconfig.FGGanConfig(**ranks.FG_KW)),
        "dragan": _port_fg(tconfig.FGGanConfig(**ranks.FG_KW,
                                               **ranks.FG_DRAGAN)),
        "pix2pix_gp": _port_fg(tconfig.FGGanConfig(**ranks.FG_KW,
                                                   **ranks.FG_PIX2PIX_GP)),
        "bg": _jax_bg(BGGanConfig(**ranks.BG_KW),
                      tconfig.BGGanConfig(**ranks.BG_KW))}
    for context in contexts:
        join_ranks(context)
    return (want, [ranks.load(str(out), "gan", r) for r in range(2)],
            [ranks.load(str(out), "harness", r) for r in range(2)],
            str(out / "run"))


def _losses(got_steps, want_steps, keys, label):
    worst = 0.0
    for i, (got, want) in enumerate(zip(got_steps, want_steps)):
        for key in keys:
            g, w = float(got["metrics"][key]), want["metrics"][key]
            worst = max(worst, abs(g - w) / abs(w))
            np.testing.assert_allclose(
                g, w, rtol=LOSS_RTOL if i == 0 else LOSS_RTOL_2,
                err_msg=f"{label} step {i + 1} {key}")
        assert not bool(got["metrics"]["nan"])
    return worst


def _gradients(got, want, rel, label):
    """Adam's first moments after step 1, each leaf within ``rel`` of its
    largest magnitude, floored at 1e-3 of the model's largest."""
    worst = 0.0
    for side in ("mu_g", "mu_d"):
        top = max(float(w.abs().max()) for w in want[side].values())
        for name, w in want[side].items():
            scale = max(float(w.abs().max()), 1e-3 * top)
            err = float((got[side][name] - w).abs().max()) / scale
            worst = max(worst, err)
            assert err <= rel, (label, side, name, err)
    return worst


def _ranks_bit_equal(results, name):
    for i, (a, b) in enumerate(zip(results[0][name], results[1][name])):
        for part in ("g", "d", "mu_g", "mu_d"):
            for key, value in a[part].items():
                assert torch.equal(b[part][key], value), (name, i, part, key)


def test_fg_data_parallel_steps_match_jax(runs):
    want, got, _, _ = runs
    fg, jfg = got[0]["fg"], want["fg"]
    loss = _losses(fg, jfg, ("loss_d", "loss_g", "recon_l1"), "fg")
    grad = _gradients(fg[0], jfg[0], FG_GRAD_REL, "fg")
    sn = max(float((fg[0]["d"][k] - v).abs().max())
             for k, v in jfg[0]["d"].items() if k.endswith("u"))
    assert sn <= SN_ATOL
    lr = FGGanConfig().lr_g
    worst = 0.0
    for side in ("g", "d"):
        mu = "mu_" + side
        for name, w in jfg[0][mu].items():
            diff = (fg[0][side][name] - jfg[0][side][name]).abs() / lr
            assert float(diff.max()) <= ADAM_BOUND, (side, name)
            clear = (w.abs() >= CLEAR_GRAD) & (fg[0][mu][name].abs()
                                               >= CLEAR_GRAD)
            if bool(clear.any()):
                worst = max(worst, float(diff[clear].max()))
                assert float(diff[clear].max()) <= UPDATE_ATOL, (side, name)
    _ranks_bit_equal(got, "fg")
    print(f"FG DP: loss rel {loss:.2e}, gradients {grad:.2e}, sn {sn:.2e}, "
          f"updates {worst:.2e} lr")


def test_fg_dragan_data_parallel_steps_match_single_process(runs):
    want, got, _, _ = runs
    loss = _losses(got[0]["dragan"], want["dragan"],
                   ("loss_d", "loss_g", "recon_l1"), "dragan")
    grad = _gradients(got[0]["dragan"][0], want["dragan"][0], FG_GRAD_REL,
                      "dragan")
    _ranks_bit_equal(got, "dragan")
    print(f"FG DRAGAN DP: loss rel {loss:.2e}, gradients {grad:.2e}")


def test_fg_pix2pix_gradient_penalty_data_parallel_matches_single_process(
        runs):
    """WGAN-GP differentiates the Pix2Pix discriminator twice, through the
    batch-stats BN's global moments: the all-reduce's backward must itself
    be differentiable, as JAX's psum is."""
    want, got, _, _ = runs
    loss = _losses(got[0]["pix2pix_gp"], want["pix2pix_gp"],
                   ("loss_d", "loss_g", "recon_l1"), "pix2pix_gp")
    grad = _gradients(got[0]["pix2pix_gp"][0], want["pix2pix_gp"][0],
                      FG_GRAD_REL, "pix2pix_gp")
    _ranks_bit_equal(got, "pix2pix_gp")
    print(f"FG Pix2Pix WGAN-GP DP: loss rel {loss:.2e}, gradients "
          f"{grad:.2e}")


def test_bg_data_parallel_steps_match_jax(runs):
    want, got, _, _ = runs
    keys = LOSS_KEYS + tuple(f"ema/{k}" for k in LOSS_KEYS)
    loss = _losses(got[0]["bg"], want["bg"], keys, "bg")
    grad = _gradients(got[0]["bg"][0], want["bg"][0], BG_GRAD_REL, "bg")
    _ranks_bit_equal(got, "bg")
    print(f"BG DP: loss rel {loss:.2e}, gradients {grad:.2e}")


def test_fg_harness_on_a_mesh_snapshots_from_the_first_rank(runs):
    _, _, harness, run_dir = runs
    assert [h["status"] for h in harness] == [[0, 0], [0, 0]]
    assert harness[0]["written"] == [1, 2, 3] and harness[1]["written"] == []
    assert list_checkpoint_steps(os.path.join(run_dir, "snapshot")) == \
        [1, 2, 3]
    rows = [json.loads(line) for line in
            open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3]
