"""Port parity of the FG GAN train step (``sketchyscenecolorization_torch/train/fg_gan.py``)
against ``make_fg_gan_train_step(cfg, donate=False)`` at the sizes of
``tests/test_train.py:FG_SMALL``: the port's fresh models go through the
bridge into a JAX ``FGGanTrainState`` (``g_params``, ``d_params``, ``d_sn``),
both take two steps on the same seeded batches, and the port gets the
random draws that the JAX step makes from its key (the noise of every
generator pass, the GP's uniforms), recomputed with ``jax.random`` here.
Three configurations: the default (spectral norm, WGAN-SN, ACGAN), DRAGAN
without spectral norm with two D updates a step (the clipping chain), and
WGAN-GP without spectral norm.

Each step starts both sides from the same state: before step 2 the port
is loaded with JAX's state after step 1 (parameters, ``u``, Adam's
moments).  Adam with b1 = 0 moves every element by about +-lr, and lr is
1% of the weights' scale; an element whose true gradient is zero (a gate's
bias under a min-max normalization, a conv bias under a batch norm) moves
by a rounding-driven amount, differently on the two sides, so a
free-running second step sees weights up to 1% apart and gradients a few
percent apart.  Compared after each step, with the tolerances stated:
- ``loss_d``, ``loss_g``, ``recon_l1``: relative 1e-5 (measured
  1.1e-6); the free-running port's second step 1e-4 (measured
  7.1e-6);
- the spectral-norm vectors the G step commits: 1e-5 (measured
  2.4e-7);
- the gradients, read from Adam's first moment (with b1 = 0 it is the
  gradient of the step's last update, after clipping): 2e-2 of each
  leaf's largest magnitude, floored at 1e-3 of the largest gradient of
  its model (measured 7.7e-3, in a leaf whose gradient is a sum that
  nearly cancels; the G step runs after the D update, whose
  rounding-driven moves change D slightly);
- the parameters after the update, in units of lr: an element whose
  gradient is at least 1e-5 (1000 x Adam's eps) on both sides within
  1e-2 lr (measured 3.1e-3), on a side that takes one update a step;
  every element within Adam's bound, 2 sqrt(1.9) lr an update.
Also the NaN flag, and that without spectral norm the discriminator has no
``u`` to commit."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sketchyscenecolorization_tpu.config import FGGanConfig
from sketchyscenecolorization_tpu.train import fg_gan as j_fg
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.train import (create_fg_gan_state,
                                                  make_fg_gan_train_step)
from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                         flatten_tree,
                                                         load_jax_tree)

SMALL_KW = dict(batch_size=2, image_size=64, vocab_size=10, max_len=4,
                base_channels=4, noise_dim=8, max_iters=100)
CONFIGS = {
    "sn": {},
    "dragan_d2": dict(spectral_norm=False, disc_steps=2),
    "wgan_gp": dict(spectral_norm=False, wgan=True),
}
LOSS_RTOL, FREE_RTOL = 1e-5, 1e-4
SN_ATOL = 1e-5
GRAD_REL = 2e-2
CLEAR_GRAD, UPDATE_ATOL = 1e-5, 1e-2
ADAM_BOUND = 2.0 * np.sqrt(1.9)     # |update| <= sqrt(1 - 0.81) / 0.1 lr


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several workers
    on the box's cores at once, and oversubscribed torch threads slow
    every worker down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg, seed):
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


def jax_draws(cfg, key, step):
    """The draws of the JAX step (``train/fg_gan.py:229-245``):
    ``k_d, k_g = split(fold_in(key, step))``; D update k splits
    ``fold_in(k_d, k)``, the G update ``k_g``, into (noise, GP) keys."""
    k_d, k_g = jax.random.split(jax.random.fold_in(key, step))
    b, s = cfg.batch_size, cfg.image_size

    def draw(k):
        k_noise, k_gp = jax.random.split(k)
        d = {"noise": jax.random.normal(k_noise, (b, cfg.noise_dim))}
        if not cfg.spectral_norm:
            if cfg.wgan:
                d["alpha"] = jax.random.uniform(k_gp, (b, 1, 1, 1))
            else:
                k_pert, k_alpha = jax.random.split(k_gp)
                d["perturb"] = jax.random.uniform(k_pert, (b, s, s, 3))
                d["alpha"] = jax.random.uniform(k_alpha, (b, 1, 1, 1))
        return {n: torch.from_numpy(np.array(v)) for n, v in d.items()}
    return {"d": [draw(jax.random.fold_in(k_d, k))
                  for k in range(max(cfg.disc_steps, 1))],
            "g": draw(k_g)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_params(module, tensors=None):
    """{"a/b": array} of a port module, or of ``tensors`` named like its
    parameters (Adam's moments), in the JAX layout."""
    if tensors is not None:
        module = copy.deepcopy(module)
        module.load_state_dict({**module.state_dict(), **tensors})
    return flatten_tree(export_jax_tree(module))


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` in an optax chain's state."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


def _port_tensors(module, tree):
    """A JAX-layout tree named like ``module``'s parameters -> {port name:
    tensor} in the port's layout."""
    module = load_jax_tree(copy.deepcopy(module), jax.tree.map(np.asarray,
                                                               tree))
    return dict(module.named_parameters())


def _sync_to_jax(state, j_state):
    """Load a JAX ``FGGanTrainState`` into the port's state: parameters,
    spectral-norm vectors, Adam moments and counts, step."""
    load_jax_tree(state.generator, jax.tree.map(np.asarray, j_state.g_params))
    load_jax_tree(state.discriminator,
                  jax.tree.map(np.asarray, j_state.d_params),
                  sn=jax.tree.map(np.asarray, j_state.d_sn))
    for module, opt, j_opt in ((state.generator, state.g_opt,
                                j_state.g_opt_state),
                               (state.discriminator, state.d_opt,
                                j_state.d_opt_state)):
        adam = _adam_state(j_opt)
        for ours, theirs in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
            for name, value in _port_tensors(module, theirs).items():
                ours[name].copy_(value.detach())
        opt.count = int(adam.count)
    state.step = int(j_state.step)


def _record(j_state, j_metrics, state, t_metrics):
    gen, disc = state.generator, state.discriminator
    tree = lambda t: flatten_tree(jax.tree.map(np.asarray, t))  # noqa: E731
    return {
        "jax": {"metrics": jax.tree.map(np.asarray, j_metrics),
                "g": tree(j_state.g_params), "d": tree(j_state.d_params),
                "mu_g": tree(_adam_state(j_state.g_opt_state).mu),
                "mu_d": tree(_adam_state(j_state.d_opt_state).mu),
                "sn": tree(j_state.d_sn)},
        "port": {"metrics": {k: v.numpy() for k, v in t_metrics.items()},
                 "g": _jax_params(gen), "d": _jax_params(disc),
                 "mu_g": _jax_params(gen, state.g_opt.mu),
                 "mu_d": _jax_params(disc, state.d_opt.mu),
                 "sn": flatten_tree(export_jax_tree(disc, "sn"))}}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def two_steps(request):
    """Both sides' two steps from the same weights, batches and draws:
    (cfg, one record per step, the parameters before each step, the
    free-running port's step-2 metrics).  Before step 2 the port is loaded
    with JAX's state after step 1, so that each step starts from the same
    state: with b1 = 0 and lr 1% of the weights' scale, Adam turns the
    rounding-level gradients of step 1 (+-lr either way) into a 1%
    difference of some weights, and step 2's gradients then differ by a
    few percent.  A record maps "jax"/"port" to {"metrics", "g", "d"
    (parameters), "mu_g", "mu_d" (Adam's first moments: with b1 = 0, the
    gradient of the step's last update, after clipping), "sn"}, all in
    the JAX layout."""
    kw = dict(SMALL_KW, **CONFIGS[request.param])
    cfg, tcfg = FGGanConfig(**kw), tconfig.FGGanConfig(**kw)
    state = create_fg_gan_state(tcfg, seed=3, device="cpu")
    free = copy.deepcopy(state)
    gen, disc = state.generator, state.discriminator
    opt_g, opt_d = j_fg.make_optimizers(cfg)
    g_params = export_jax_tree(gen)
    d_params = export_jax_tree(disc)
    j_state = j_fg.FGGanTrainState(
        g_params=g_params, d_params=d_params,
        d_sn=export_jax_tree(disc, "sn"), g_opt_state=opt_g.init(g_params),
        d_opt_state=opt_d.init(d_params), step=jnp.zeros((), jnp.int32))
    j_step = j_fg.make_fg_gan_train_step(cfg, donate=False)
    t_step = make_fg_gan_train_step(tcfg)
    key = jax.random.PRNGKey(7)
    records, before = [], []
    for i in range(2):
        batch_d, batch_g = _batch(cfg, 2 * i), _batch(cfg, 2 * i + 1)
        if i:
            _sync_to_jax(state, j_state)
        before.append({"g": _jax_params(gen), "d": _jax_params(disc)})
        args = (_torch_batch(batch_d), _torch_batch(batch_g))
        draws = jax_draws(cfg, key, i)
        j_state, j_metrics = j_step(j_state, batch_d, batch_g, key)
        state, t_metrics = t_step(state, *args, draws=draws)
        free, free_metrics = t_step(free, *args, draws=draws)
        records.append(_record(j_state, j_metrics, state, t_metrics))
    assert state.step == free.step == 2 and int(j_state.step) == 2
    return cfg, records, before, {k: v.numpy()
                                  for k, v in free_metrics.items()}


def test_losses_match_jax(two_steps):
    """Each step's losses, and the free-running port's second step."""
    cfg, records, _, free = two_steps
    for i, rec in enumerate(records):
        j_m, t_m = rec["jax"]["metrics"], rec["port"]["metrics"]
        for key in ("loss_d", "loss_g", "recon_l1"):
            np.testing.assert_allclose(t_m[key], j_m[key], rtol=LOSS_RTOL,
                                       atol=0, err_msg=f"step {i + 1} {key}")
            if i:
                np.testing.assert_allclose(free[key], j_m[key],
                                           rtol=FREE_RTOL, atol=0,
                                           err_msg=f"free step 2 {key}")
        assert not t_m["nan"] and not j_m["nan"]


def test_committed_sn_vectors_match_jax(two_steps):
    cfg, records, _, _ = two_steps
    for i, rec in enumerate(records):
        j_sn, t_sn = rec["jax"]["sn"], rec["port"]["sn"]
        assert sorted(t_sn) == sorted(j_sn)
        assert bool(j_sn) == cfg.spectral_norm
        for key, want in j_sn.items():
            np.testing.assert_allclose(t_sn[key], want, rtol=0, atol=SN_ATOL,
                                       err_msg=f"step {i + 1} {key}")


def test_gradients_match_jax(two_steps):
    """Adam's first moment with b1 = 0 is the gradient of the step's last
    update (clipped, without spectral norm): each leaf within GRAD_REL of
    its largest magnitude, floored at 1e-3 of the side's largest."""
    _, records, _, _ = two_steps
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
    """In units of lr: an element whose gradient was at least CLEAR_GRAD
    on both sides (a side with one update a step) moved alike within
    UPDATE_ATOL; every element within ADAM_BOUND an update."""
    cfg, records, before, _ = two_steps
    lr = {"g": cfg.lr_g, "d": cfg.lr_d}
    n_d = max(cfg.disc_steps, 1)
    for i, rec in enumerate(records):
        for side, updates in (("g", 1), ("d", n_d)):
            want, got = rec["jax"][side], rec["port"][side]
            mu_j, mu_t = rec["jax"]["mu_" + side], rec["port"]["mu_" + side]
            assert sorted(want) == sorted(got)
            for name, w in want.items():
                diff = np.abs(got[name] - w) / lr[side]
                assert diff.max() <= ADAM_BOUND * updates, (i + 1, side, name)
                if updates > 1:           # two updates, one observed
                    continue
                clear = (np.abs(mu_j[name]) >= CLEAR_GRAD) & \
                    (np.abs(mu_t[name]) >= CLEAR_GRAD)
                if clear.any():
                    worst = float(diff[clear].max())
                    assert worst <= UPDATE_ATOL, (i + 1, side, name, worst)
            moved = sum(int((w != before[i][side][n]).sum())
                        for n, w in want.items())
            assert moved > 0.5 * sum(w.size for w in want.values())


def test_nan_flag():
    tcfg = tconfig.FGGanConfig(**SMALL_KW)
    state = create_fg_gan_state(tcfg, device="cpu")
    bad = _torch_batch(_batch(tcfg, 0))
    bad["images_d"] = bad["images_d"] * float("nan")
    _, metrics = make_fg_gan_train_step(tcfg)(
        state, bad, _torch_batch(_batch(tcfg, 1)))
    assert bool(metrics["nan"])


def test_without_spectral_norm_nothing_to_commit():
    tcfg = tconfig.FGGanConfig(**dict(SMALL_KW, spectral_norm=False))
    state = create_fg_gan_state(tcfg, device="cpu")
    assert not list(state.discriminator.buffers())
    assert not export_jax_tree(state.discriminator, "sn")
