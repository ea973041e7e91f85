"""Port parity of the GAN training pieces below the train steps: spectral
norm, the spectral-normed layers and the ``u`` they commit, the three
discriminators, every GAN loss, the FG learning-rate decay, the optimizer
arithmetic against optax, and the NaN watchdog.  JAX parameter trees (and
the flax ``sn`` collection) go through the bridge; inputs come from seeded
numpy.

Tolerances, with the measured max-abs difference:
- ``spectral_normalize``: w/sigma and u 1e-6, the gradient with respect to
  w 1e-5 (measured 2.4e-7 over all three);
- ``SNConv``/``SNDense`` with spectral norm: output and committed u 1e-5
  (measured 4.8e-7);
- ``MRUDiscriminator`` (ACGAN and ``proj_d``): patch and class logits 1e-4,
  committed u 1e-5 (measured 1.8e-7);
- ``PatchDiscriminator`` 1e-5 (measured 1.8e-7) and
  ``ResidualDiscriminator`` 5e-5 (measured 6.6e-6: five blocks of
  batch-stats BN on random weights), both after a sigmoid;
- the losses: relative 1e-5 (measured 7.5e-7); WGAN-GP and DRAGAN with
  JAX's uniforms fed in: loss relative 1e-5 and the gradient of the D loss
  with respect to every D leaf 1e-4 of the largest gradient magnitude of
  any leaf (the gates' biases, which a min-max normalization cancels, have
  a zero gradient up to rounding; measured max-abs 7.1e-9, through the
  double backward);
- ``fg_gan_lr_decay`` exact (both in float32); Adam with both clips
  against ``optax`` 1e-6 (measured 1.5e-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sketchyscenecolorization_tpu.models import bg_gan as j_bg
from sketchyscenecolorization_tpu.models import fg_gan as j_fg
from sketchyscenecolorization_tpu.models import gan_layers as j_layers
from sketchyscenecolorization_tpu.ops.norm import \
    spectral_normalize as j_spectral_normalize
from sketchyscenecolorization_tpu.train import losses as jl
from sketchyscenecolorization_tpu.train.fg_gan import _per_tensor_clip
from sketchyscenecolorization_tpu.train.schedules import \
    fg_gan_lr_decay as j_lr_decay
from sketchyscenecolorization_torch.models import bg_gan as t_bg
from sketchyscenecolorization_torch.models import fg_gan as t_fg
from sketchyscenecolorization_torch.models.gan_layers import (SNConv, SNDense,
                                                              commit_sn)
from sketchyscenecolorization_torch.ops.norm import spectral_normalize
from sketchyscenecolorization_torch.train import losses as tl
from sketchyscenecolorization_torch.train import optim
from sketchyscenecolorization_torch.train.schedules import fg_gan_lr_decay
from sketchyscenecolorization_torch.train.watchdog import (
    NaNWatchdog, run_with_nan_restart)
from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                         flatten_tree,
                                                         load_jax_tree)
from test_torch_train_fg_gan import one_torch_thread  # noqa: F401


def T(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, atol, rel=False):
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        tol = atol * max(np.abs(w).max(), 1e-30) if rel else atol
        np.testing.assert_allclose(got[key], w, rtol=0, atol=tol,
                                   err_msg=key)


# ------------------------------------------------------------ spectral norm

@pytest.mark.parametrize("shape", [(3, 3, 5, 7), (6, 9)])
def test_spectral_normalize_value_and_grad(shape):
    rng = np.random.RandomState(0)
    w = rng.randn(*shape).astype(np.float32) * 0.3
    u = rng.randn(1, shape[-1]).astype(np.float32)
    r_w = rng.randn(*shape).astype(np.float32)
    r_u = rng.randn(1, shape[-1]).astype(np.float32)

    def objective(w_):
        w_bar, u_new = j_spectral_normalize(w_, jnp.asarray(u))
        return jnp.sum(w_bar * r_w) + jnp.sum(u_new * r_u)
    want_w, want_u = j_spectral_normalize(jnp.asarray(w), jnp.asarray(u))
    want_grad = jax.grad(objective)(jnp.asarray(w))

    # the port's conv kernels are OIHW: out on axis 0
    perm = (3, 2, 0, 1) if len(shape) == 4 else (0, 1)
    inv = tuple(np.argsort(perm))
    out_dim = 0 if len(shape) == 4 else -1
    w_t = T(w.transpose(perm).copy()).requires_grad_(True)
    w_bar, u_new = spectral_normalize(w_t, T(u), out_dim=out_dim)
    (torch.sum(w_bar * T(r_w.transpose(perm).copy()))
     + torch.sum(u_new * T(r_u))).backward()
    np.testing.assert_allclose(w_bar.detach().numpy().transpose(inv),
                               want_w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(u_new.detach().numpy(), want_u, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(w_t.grad.numpy().transpose(inv), want_grad,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("layer", ["conv", "dense"])
def test_sn_layers_and_the_u_they_commit(layer):
    rng = np.random.RandomState(1)
    if layer == "conv":
        x = rng.randn(2, 8, 8, 4).astype(np.float32)
        jmod = j_layers.SNConv(6, 3, sn=True, activation="prelu")
        port = SNConv(4, 6, 3, activation="prelu", sn=True)
    else:
        x = rng.randn(3, 5).astype(np.float32)
        jmod = j_layers.SNDense(7, sn=True)
        port = SNDense(5, 7, sn=True)
    variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want, new_vars = jmod.apply(variables, jnp.asarray(x), mutable=["sn"])
    load_jax_tree(port, _np(variables["params"]), sn=_np(variables["sn"]))
    u0 = port.u.clone()
    with torch.no_grad():
        np.testing.assert_allclose(port(T(x)).numpy(), want, rtol=0,
                                   atol=1e-5)
        assert torch.equal(port.u, u0)          # no commit outside the block
        with commit_sn(port):
            got = port(T(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    _assert_trees_close(export_jax_tree(port, "sn"), _np(new_vars["sn"]),
                        1e-5)
    assert not torch.equal(port.u, u0)
    assert not port.commit_sn


# ------------------------------------------------------------ discriminators

@pytest.mark.parametrize("proj_d", [False, True])
def test_mru_discriminator_matches_flax(proj_d):
    rng = np.random.RandomState(3)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    labels = np.array([3, 17], np.int32)
    jd = j_fg.MRUDiscriminator(num_classes=25, size=4, proj_d=proj_d)
    variables = jd.init(jax.random.PRNGKey(4), jnp.asarray(img),
                        jnp.asarray(img), jnp.asarray(labels))
    (want_out, want_logits), new_vars = jd.apply(
        variables, jnp.asarray(img), jnp.asarray(img), jnp.asarray(labels),
        mutable=["sn"])
    port = t_fg.MRUDiscriminator(num_classes=25, size=4, sn=True,
                                 proj_d=proj_d)
    load_jax_tree(port, _np(variables["params"]), sn=_np(variables["sn"]))
    with torch.no_grad(), commit_sn(port):
        out, logits = port(T(img), T(img), T(labels))
    assert out.shape == (2, 2, 2, 1)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=1e-4)
    if proj_d:
        assert logits is None and want_logits is None
    else:
        np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                                   atol=1e-4)
    _assert_trees_close(export_jax_tree(port, "sn"), _np(new_vars["sn"]),
                        1e-5)
    _assert_trees_close(export_jax_tree(port), _np(variables["params"]), 0)


@pytest.mark.parametrize("kind", ["patch", "residual"])
def test_bg_discriminators_match_flax(kind):
    rng = np.random.RandomState(5)
    inputs = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    targets = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jcls, tcls = {"patch": (j_bg.PatchDiscriminator, t_bg.PatchDiscriminator),
                  "residual": (j_bg.ResidualDiscriminator,
                               t_bg.ResidualDiscriminator)}[kind]
    jd = jcls(ndf=4)
    params = jd.init(jax.random.PRNGKey(6), jnp.asarray(inputs),
                     jnp.asarray(targets))["params"]
    want = jd.apply({"params": params}, jnp.asarray(inputs),
                    jnp.asarray(targets))
    port = load_jax_tree(tcls(ndf=4), _np(params))
    with torch.no_grad():
        got = port(T(inputs), T(targets))
    assert got.shape == {"patch": (2, 6, 6, 1),
                         "residual": (2, 2, 2, 1024)}[kind]
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol={"patch": 1e-5, "residual": 5e-5}[kind])


# ------------------------------------------------------------ losses

def _close(got, want, rtol=1e-5):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, atol=0)


def test_fg_losses_match_jax():
    rng = np.random.RandomState(7)
    pred = rng.uniform(-2, 2, (2, 8, 8, 3)).astype(np.float32)
    target = rng.uniform(-2, 2, (2, 8, 8, 3)).astype(np.float32)
    _close(tl.smooth_l1(T(pred), T(target)),
           jl.smooth_l1(jnp.asarray(pred), jnp.asarray(target)))
    real_logits = rng.randn(4, 25).astype(np.float32) * 3
    fake_logits = rng.randn(4, 25).astype(np.float32) * 3
    real_lab, fake_lab = rng.randint(0, 25, 4), rng.randint(0, 25, 4)
    np.testing.assert_allclose(
        tl.sparse_softmax_xent(T(real_logits), T(real_lab)).numpy(),
        jl.sparse_softmax_xent(jnp.asarray(real_logits),
                               jnp.asarray(real_lab)), rtol=1e-5)
    for got, want in zip(
            tl.acgan_focal_loss(T(real_logits), T(real_lab), T(fake_logits),
                                T(fake_lab), 25),
            jl.acgan_focal_loss(jnp.asarray(real_logits),
                                jnp.asarray(real_lab),
                                jnp.asarray(fake_logits),
                                jnp.asarray(fake_lab), 25)):
        _close(got, want)
    fake_out = rng.randn(2, 4, 4, 1).astype(np.float32) * 4
    real_out = rng.randn(2, 4, 4, 1).astype(np.float32) * 4
    for got, want in zip(tl.wgan_sn_losses(T(fake_out), T(real_out)),
                         jl.wgan_sn_losses(jnp.asarray(fake_out),
                                           jnp.asarray(real_out))):
        _close(got, want)


def _disc_pair():
    jd = j_fg.MRUDiscriminator(num_classes=25, size=4, sn=False)
    x = jnp.zeros((2, 16, 16, 3))
    params = jd.init(jax.random.PRNGKey(8), x, x,
                     jnp.zeros((2,), jnp.int32))["params"]
    port = load_jax_tree(t_fg.MRUDiscriminator(num_classes=25, size=4,
                                               sn=False), _np(params))
    return jd, params, port


@pytest.mark.parametrize("kind", ["wgan_gp", "dragan"])
def test_gradient_penalty_losses_match_jax(kind):
    """The D loss with its penalty, through the double backward, from the
    same uniforms: JAX draws them from ``rng``, the test recomputes the
    draws with ``jax.random`` and feeds them to the port."""
    jd, params, port = _disc_pair()
    rng = np.random.RandomState(9)
    real = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    fake = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    labels = np.array([1, 4], np.int32)
    key = jax.random.PRNGKey(10)

    def j_loss(p):
        def disc_fn(x):
            return jd.apply({"params": p}, x, x, jnp.asarray(labels))[0]
        fake_out, real_out = disc_fn(jnp.asarray(fake)), disc_fn(
            jnp.asarray(real))
        if kind == "wgan_gp":
            return jl.wgan_gp_losses(disc_fn, fake_out, real_out,
                                     jnp.asarray(fake), jnp.asarray(real),
                                     key)
        return jl.dragan_losses(disc_fn, fake_out, real_out,
                                jnp.asarray(real), key)
    (want_g, want_d), want_grads = jax.jit(lambda p: (
        j_loss(p), jax.grad(lambda q: j_loss(q)[1])(p)))(params)

    def disc_fn(x):
        return port(x, x, T(labels))[0]
    fake_out, real_out = disc_fn(T(fake)), disc_fn(T(real))
    if kind == "wgan_gp":
        alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1)))
        loss_g, loss_d = tl.wgan_gp_losses(disc_fn, fake_out, real_out,
                                           T(fake), T(real), T(alpha))
    else:
        k_pert, k_alpha = jax.random.split(key)
        perturb = np.asarray(jax.random.uniform(k_pert, real.shape))
        alpha = np.asarray(jax.random.uniform(k_alpha, (2, 1, 1, 1)))
        loss_g, loss_d = tl.dragan_losses(disc_fn, fake_out, real_out,
                                          T(real), T(perturb), T(alpha))
    _close(loss_g, want_g)
    _close(loss_d, want_d)
    names = [n for n, _ in port.named_parameters()]
    params = [p for _, p in port.named_parameters()]
    grads = torch.autograd.grad(loss_d, params, allow_unused=True)
    got = {n.replace(".", "/"): (g if g is not None else torch.zeros_like(p))
           .numpy() for n, g, p in zip(names, grads, params)}
    want = {k: np.asarray(v) for k, v in flatten_tree(_np(want_grads)).items()}
    scale = max(np.abs(w).max() for w in want.values())
    for key_, w in want.items():
        g = got[key_]
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=key_)


def test_fc_weight_decay_takes_only_dense_kernels():
    jd, params, port = _disc_pair()
    _close(tl.fc_weight_decay_loss(dict(port.named_parameters())),
           jl.fc_weight_decay_loss(params))
    # only ac_logits.weights: 2-D and named weights
    w = port.ac_logits.weights.detach()
    _close(tl.fc_weight_decay_loss(dict(port.named_parameters())),
           1e-6 * 0.5 * torch.sum(w * w))
    emb = {"class_embedding": torch.ones(3, 4),
           "TextLSTM.alstm_w": torch.ones(4, 16)}
    assert float(tl.fc_weight_decay_loss(emb)) == 0.0


def test_bg_losses_match_jax():
    rng = np.random.RandomState(11)
    targets = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    outputs = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    region = rng.randn(2, 8, 8, 3).astype(np.float32) * 2
    labels = rng.randint(0, 3, (2, 8, 8)).astype(np.int32)
    p_real = rng.uniform(0, 1, (2, 3, 3, 1)).astype(np.float32)
    p_fake = rng.uniform(0, 1, (2, 3, 3, 1)).astype(np.float32)
    p_fake[0, 0, 0, 0] = 1.0                # saturated: log(0 + eps)
    got = tl.bg_gan_losses(T(p_real), T(p_fake), T(targets), T(outputs),
                           T(region), T(labels))
    want = jl.bg_gan_losses(*map(jnp.asarray, (p_real, p_fake, targets,
                                               outputs, region, labels)))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    empty = np.zeros_like(labels)            # no non-FG pixel: max(.., 1)
    _close(tl.masked_l1_loss(T(targets), T(outputs), T(empty)),
           jl.masked_l1_loss(jnp.asarray(targets), jnp.asarray(outputs),
                             jnp.asarray(empty)))


# ------------------------------------------------------------ schedule, optim

def test_fg_gan_lr_decay_matches_jax():
    for step in (0, 1, 7, 333, 50000, 88888, 100000, 250000):
        assert fg_gan_lr_decay(step, 100000) == float(j_lr_decay(step,
                                                                 100000))
    assert fg_gan_lr_decay(100000, 100000) == pytest.approx(0.2)


@pytest.mark.parametrize("clip", [None, (2.0, 0.5)])
def test_adam_and_clips_match_optax(clip):
    """Three updates of ``adam_update`` (b1 0, b2 0.9, a decaying lr), with
    the FG GAN's global-norm and per-tensor clips, against the optax chain
    of JAX ``train/fg_gan.py:make_optimizers``."""
    rng = np.random.RandomState(12)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    schedule = lambda count: 1e-2 * j_lr_decay(count, 10)   # noqa: E731
    chain = [optax.clip_by_global_norm(clip[0]),
             _per_tensor_clip(clip[1])] if clip else []
    opt = optax.chain(*chain, optax.adam(schedule, b1=0.0, b2=0.9, eps=1e-8))
    j_params, j_state = params, opt.init(params)
    t_params = {k: T(v.copy()) for k, v in params.items()}
    t_state = optim.AdamState.zeros(t_params)
    for i in range(3):
        grads = {k: (rng.randn(*s) * 10 ** (i - 1)).astype(np.float32)
                 for k, s in shapes.items()}
        grads["b"][0] = 0.0
        updates, j_state = opt.update(grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        g = {k: T(v) for k, v in grads.items()}
        if clip:
            g = optim.clip_by_tensor_norm(
                optim.clip_by_global_norm(g, clip[0]), clip[1])
        lr = float(np.float32(1e-2) * np.float32(fg_gan_lr_decay(i, 10)))
        optim.adam_update(t_params, g, t_state, lr, 0.0, 0.9)
        for k in shapes:
            np.testing.assert_allclose(t_params[k].numpy(), j_params[k],
                                       rtol=0, atol=1e-6, err_msg=k)
    assert t_state.count == 3


# ------------------------------------------------------------ watchdog

def test_nan_watchdog_and_restart():
    dog = NaNWatchdog()
    assert not dog.check({"nan": torch.tensor(False)}, 1)
    assert dog.check({"nan": torch.tensor(True)}, 2)
    assert dog.tripped and dog.trip_step == 2
    calls = []

    def launch():
        calls.append(1)
        return -1 if len(calls) < 3 else 0
    assert run_with_nan_restart(launch) == 0 and len(calls) == 3
    with pytest.raises(RuntimeError, match="restart limit"):
        run_with_nan_restart(lambda: -1, max_restarts=2)
