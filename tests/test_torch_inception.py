"""Port parity of Inception-v4 (``sketchyscenecolorization_torch/models/
inception_v4.py``), its resize and the FG perceptual term, against the JAX
package on the CPU.

Mirrors of ``tests/test_inception.py`` (the two ``RUN_SLOW`` ones stay
gated; the converter's two tests become the bridge's round trip and the
conv-table subgraph check here, and the port's converter is held against
JAX's in ``tests/test_torch_tf1_converter.py``), and
against JAX with bridged weights, with the tolerances stated:
- every endpoint of the full network with its Logits head at the reduced
  171^2 input, BN statistics set away from 0/1: max-abs error over the
  endpoint's largest magnitude <= 1e-5 (measured 3.1e-6, Mixed_5e);
- ``perceptual_loss`` at 32^2 inputs: relative 1e-5 (measured 2.0e-7);
- ``resize_bilinear_half_pixel`` up (64 -> 299, 192 -> 299) and down
  (768 -> 299): 1e-6 max-abs up (measured 6.0e-8), 1e-5 down (measured
  2.2e-6: the antialiased weights' normalising sums are taken in another
  order);
- ``inception_v4_class_probs`` (3 images at batch 2, the last batch
  padded; posteriors 0.005-0.50): 1e-6 max-abs (measured 2.4e-7);
- a port FG step with ``coeff_perceptual`` 2.5 gives ``loss_g`` of the
  step without it plus 2.5 x ``perceptual_loss`` of its fakes, within
  f32 rounding of the sum (4 ulp of ``loss_g``; measured 0.35); the
  frozen Inception module takes no gradient and no Adam moments, and the
  generator's gradient differs;
- under ``RUN_SLOW`` (the JAX step's Inception backward compiles for
  minutes on the CPU), the perceptual step against JAX's jitted step from
  the same state, batches and draws: losses relative 1e-5, the
  generator's first moments 2e-2 of each leaf's largest magnitude (as
  ``tests/test_torch_train_fg_gan.py``)."""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchyscenecolorization_tpu.config import FGGanConfig
from sketchyscenecolorization_tpu.evaluation import \
    inception_v4_class_probs as j_class_probs
from sketchyscenecolorization_tpu.models import inception_v4 as jinc
from sketchyscenecolorization_tpu.ops.image import \
    resize_bilinear_half_pixel as j_resize
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.evaluation import (
    inception_score, inception_v4_class_probs)
from sketchyscenecolorization_torch.models import inception_v4 as tinc
from sketchyscenecolorization_torch.ops.image import \
    resize_bilinear_half_pixel
from sketchyscenecolorization_torch.train import (create_fg_gan_state,
                                                  make_fg_gan_train_step)
from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                         flatten_tree,
                                                         load_jax_tree)
from test_torch_train_fg_gan import one_torch_thread  # noqa: F401

ENDPOINT_REL = 1e-5
LOSS_RTOL = 1e-5
UP_ATOL, DOWN_ATOL = 1e-6, 1e-5
PROBS_ATOL = 1e-6
SUM_ULPS = 4
GRAD_REL = 2e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _with_bn_stats(tree, seed=1):
    """The tree with every BN's beta, moving mean and variance drawn away
    from 0/1, so that the bridge's naming of each is tested."""
    rng = np.random.RandomState(seed)
    tree = copy.deepcopy(tree)

    def walk(node):
        for value in node.values():
            if not isinstance(value, dict):
                continue
            if "moving_mean" in value:
                n = value["moving_mean"].shape[0]
                value["beta"] = rng.uniform(-.1, .1, n).astype(np.float32)
                value["moving_mean"] = rng.uniform(-.1, .1, n).astype(
                    np.float32)
                value["moving_variance"] = rng.uniform(.5, 2., n).astype(
                    np.float32)
            else:
                walk(value)
    walk(tree)
    return tree


def _bridged(final_endpoint="Mixed_7d", num_classes=None,
             create_aux_logits=True, key=0):
    """(JAX tree, the port's module on it)."""
    tree = _with_bn_stats(_np(jax.jit(lambda k: jinc.init_params(
        k, final_endpoint, num_classes, create_aux_logits))(
            jax.random.PRNGKey(key))))
    model = tinc.InceptionV4(final_endpoint, num_classes, create_aux_logits)
    return tree, load_jax_tree(model, tree)


# ------------------------------------------------ mirrors of test_inception

def test_endpoint_shapes_match_inception_v4():
    model = tinc.InceptionV4(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        eps = tinc.extract_endpoints(model, torch.zeros(1, 299, 299, 3))
    assert [tuple(e.shape) for e in eps] == [(1, 147, 147, 32),
                                             (1, 71, 71, 192),
                                             (1, 35, 35, 384)]


def test_perceptual_loss_zero_for_identical():
    model = tinc.InceptionV4("Mixed_5b",
                             generator=torch.Generator().manual_seed(0))
    img = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(1)
                     ) * 2 - 1
    with torch.no_grad():
        assert float(tinc.perceptual_loss(model, img, img)) == 0.0
        assert float(tinc.perceptual_loss(model, img, -img)) > 0.0


def _fg_batch(cfg, seed):
    r = np.random.RandomState(seed)
    s, b = cfg.image_size, cfg.batch_size
    return {
        "images": torch.from_numpy(r.uniform(-1, 1, (b, s, s, 3))
                                   .astype(np.float32)),
        "sketches": torch.from_numpy(r.uniform(-1, 1, (b, s, s, 3))
                                     .astype(np.float32)),
        "images_d": torch.from_numpy(r.uniform(-1, 1, (b, s, s, 3))
                                     .astype(np.float32)),
        "class_id": torch.zeros(b, dtype=torch.long),
        "class_id_d": torch.zeros(b, dtype=torch.long),
        "tokens": torch.ones(b, cfg.max_len, dtype=torch.long),
    }


@pytest.mark.skipif(os.environ.get("RUN_SLOW") != "1",
                    reason="mirror of the JAX test gated for its ~8 min "
                           "inception backward; set RUN_SLOW=1")
def test_fg_train_step_with_perceptual():
    cfg = tconfig.FGGanConfig(batch_size=1, image_size=64, vocab_size=10,
                              max_len=4, base_channels=4, noise_dim=8,
                              max_iters=100, coeff_perceptual=1.0)
    perc = tinc.InceptionV4(generator=torch.Generator().manual_seed(5))
    state = create_fg_gan_state(cfg, device="cpu")
    step = make_fg_gan_train_step(cfg, perceptual=perc)
    _, metrics = step(state, _fg_batch(cfg, 0), _fg_batch(cfg, 1))
    assert np.isfinite(float(metrics["loss_g"]))


def test_full_base_channel_walk():
    model = tinc.InceptionV4(num_classes=7, create_aux_logits=False,
                             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits, eps = tinc.inception_v4(model, torch.zeros(1, 171, 171, 3))
    want_ch = {"Conv2d_1a_3x3": 32, "Conv2d_2a_3x3": 32, "Conv2d_2b_3x3": 64,
               "Mixed_3a": 160, "Mixed_4a": 192, "Mixed_5a": 384,
               "Mixed_5b": 384, "Mixed_5e": 384, "Mixed_6a": 1024,
               "Mixed_6h": 1024, "Mixed_7a": 1536, "Mixed_7d": 1536}
    for name, ch in want_ch.items():
        assert eps[name].shape[-1] == ch, name
    assert [eps[n].shape[1] for n in
            ("Mixed_3a", "Mixed_4a", "Mixed_5a", "Mixed_6a", "Mixed_7a")] \
        == [41, 39, 19, 9, 4]
    assert tuple(logits.shape) == (1, 7)
    assert tuple(eps["PreLogitsFlatten"].shape) == (1, 1536)
    np.testing.assert_allclose(float(eps["Predictions"].sum()), 1.0,
                               rtol=1e-5)


@pytest.mark.skipif(os.environ.get("RUN_SLOW") != "1",
                    reason="mirror of the JAX test gated for its full 299^2 "
                           "compile; set RUN_SLOW=1")
def test_full_network_at_canonical_299():
    model = tinc.InceptionV4(num_classes=1001,
                             generator=torch.Generator().manual_seed(0))
    x = torch.zeros(1, 299, 299, 3)
    with torch.no_grad():
        logits, eps = tinc.inception_v4(model, x)
        want = {"Conv2d_1a_3x3": (1, 149, 149, 32),
                "Conv2d_2a_3x3": (1, 147, 147, 32),
                "Conv2d_2b_3x3": (1, 147, 147, 64),
                "Mixed_3a": (1, 73, 73, 160), "Mixed_4a": (1, 71, 71, 192),
                "Mixed_5a": (1, 35, 35, 384), "Mixed_5e": (1, 35, 35, 384),
                "Mixed_6a": (1, 17, 17, 1024), "Mixed_6h": (1, 17, 17, 1024),
                "Mixed_7a": (1, 8, 8, 1536), "Mixed_7d": (1, 8, 8, 1536)}
        for name, shape in want.items():
            assert tuple(eps[name].shape) == shape, name
        assert tuple(eps["AuxLogits"].shape) == (1, 1001)
        assert tuple(logits.shape) == (1, 1001)
        l2, _ = tinc.inception_v4(model, x, is_training=True,
                                  dropout_generator=torch.Generator()
                                  .manual_seed(1))
    assert torch.isfinite(l2).all()


def test_param_count_matches_imagenet_inception_v4():
    n = sum(p.numel() for p in tinc.InceptionV4(
        num_classes=1001, create_aux_logits=False).parameters())
    assert n == 42_712_937, n
    n = sum(p.numel() for p in tinc.InceptionV4(num_classes=1001)
            .parameters())
    assert n == 46_074_066, n


def test_bridge_round_trip_is_pure_rename():
    """A JAX tree (heads and AuxLogits included) goes into the module and
    comes back leaf for leaf: the parameter names are the slim scope
    paths."""
    tree, model = _bridged(num_classes=11, key=3)
    back, want = flatten_tree(export_jax_tree(model)), flatten_tree(tree)
    assert sorted(back) == sorted(want)
    for path, leaf in want.items():
        assert back[path].shape == leaf.shape, path
        np.testing.assert_array_equal(back[path], leaf, err_msg=path)


def test_conv_table_subgraph_consistency():
    """The conv table equals JAX's at every endpoint; the Mixed_5b module's
    parameters are a strict subset of the full module's, one conv + BN per
    table entry."""
    for name in tinc.ENDPOINTS:
        assert tinc.conv_table(name) == jinc.conv_table(name), name
    sub = dict(tinc.InceptionV4("Mixed_5b").named_parameters())
    full = dict(tinc.InceptionV4().named_parameters())
    assert set(sub) < set(full)
    assert sorted(sub) == sorted(
        f"{path.replace('/', '.')}.{leaf}"
        for path, _ in tinc.conv_table("Mixed_5b")
        for leaf in ("weights", "BatchNorm.beta", "BatchNorm.moving_mean",
                     "BatchNorm.moving_variance"))


# ------------------------------------------------ against the JAX package

def test_endpoints_match_jax():
    tree, model = _bridged(num_classes=7, create_aux_logits=False)
    x = np.random.RandomState(2).uniform(0, 1, (1, 171, 171, 3)) \
        .astype(np.float32)
    _, want = jax.jit(jinc.inception_v4)(tree, jnp.asarray(x))
    with torch.no_grad():
        _, got = tinc.inception_v4(model, torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        assert g.shape == w.shape, name
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= ENDPOINT_REL, (name, err)


def test_perceptual_loss_matches_jax():
    tree, model = _bridged("Mixed_5b")
    rng = np.random.RandomState(4)
    a, b = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    want = float(jax.jit(jinc.perceptual_loss)(tree, a, b))
    with torch.no_grad():
        got = float(tinc.perceptual_loss(model, torch.from_numpy(a),
                                         torch.from_numpy(b)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("size,atol", [(64, UP_ATOL), (192, UP_ATOL),
                                       (768, DOWN_ATOL)])
def test_resize_bilinear_half_pixel_matches_jax(size, atol):
    x = np.random.RandomState(size).uniform(-1, 1, (1, size, size, 3)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(lambda v: j_resize(v, 299, 299))(x))
    got = resize_bilinear_half_pixel(torch.from_numpy(x), 299, 299).numpy()
    assert got.shape == want.shape == (1, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_inception_v4_class_probs_match_jax():
    """With the head's weights scaled to give logits within +-3, so that
    the posteriors are far from one-hot (the random base's activations
    grow by orders of magnitude)."""
    tree, model = _bridged(num_classes=9, create_aux_logits=False)
    imgs = np.random.RandomState(0).uniform(-1, 1, (3, 64, 64, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        logits, _ = tinc.inception_v4(model, resize_bilinear_half_pixel(
            torch.from_numpy(imgs), 299, 299))
    head = tree["Logits"]["Logits"]
    head["weights"] = head["weights"] * (3.0 / float(logits.abs().max()))
    model = load_jax_tree(model, tree)
    want = j_class_probs(tree, imgs, batch_size=2)
    got = inception_v4_class_probs(model, imgs, batch_size=2)
    assert got.shape == want.shape == (3, 9)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_ATOL)
    mean, _ = inception_score(got, splits=1)
    assert 1.0 <= mean <= 9.0 + 1e-6


# ------------------------------------------------ the FG perceptual term

SMALL_KW = dict(batch_size=1, image_size=32, vocab_size=10, max_len=4,
                base_channels=4, noise_dim=8, max_iters=100)


def test_perceptual_term_adds_coeff_times_loss():
    """From one state, batches and draws: the step with the term and the
    step without it differ in ``loss_g`` by coeff x perceptual_loss(real,
    fakes), the fakes of the G update (the D update leaves the generator
    as it is, and its batch-stats norm makes the forward pure)."""
    coeff = 2.5
    cfg = tconfig.FGGanConfig(**SMALL_KW, coeff_perceptual=coeff)
    plain = dataclasses.replace(cfg, coeff_perceptual=0.0)
    perc = tinc.InceptionV4("Mixed_5b",
                            generator=torch.Generator().manual_seed(5))
    before = {k: v.clone() for k, v in perc.state_dict().items()}
    state = create_fg_gan_state(cfg, seed=2, device="cpu")
    batch_d, batch_g = _fg_batch(cfg, 0), _fg_batch(cfg, 1)
    from sketchyscenecolorization_torch.train import fg_gan_draws
    draws = fg_gan_draws(cfg, 0, 0, "cpu")
    with torch.no_grad():
        fakes = state.generator(batch_g["sketches"], batch_g["tokens"],
                                batch_g["class_id"], draws["g"]["noise"])
        term = float(tinc.perceptual_loss(perc, batch_g["images"], fakes))
    without = copy.deepcopy(state)
    with_state, with_m = make_fg_gan_train_step(cfg, perceptual=perc)(
        state, batch_d, batch_g, draws=draws)
    without, without_m = make_fg_gan_train_step(plain)(
        without, batch_d, batch_g, draws=draws)
    got, base = float(with_m["loss_g"]), float(without_m["loss_g"])
    assert term > 0
    ulp = np.spacing(np.float32(got))
    assert abs(got - (base + coeff * term)) <= SUM_ULPS * ulp, \
        (got, base, coeff * term)
    assert float(with_m["loss_d"]) == float(without_m["loss_d"])
    assert all(not p.requires_grad and p.grad is None
               for p in perc.parameters())
    for k, v in perc.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert sorted(with_state.g_opt.mu) == sorted(
        n for n, _ in with_state.generator.named_parameters())
    assert not any("Conv2d_1a_3x3" in k
                   for k in with_state.state_dict()["generator"])
    moved = [n for n, mu in with_state.g_opt.mu.items()
             if not torch.equal(mu, without.g_opt.mu[n])]
    assert moved


@pytest.mark.skipif(os.environ.get("RUN_SLOW") != "1",
                    reason="the JAX step's inception backward takes ~8 min "
                           "on the CPU; set RUN_SLOW=1")
def test_perceptual_step_matches_jax():
    from sketchyscenecolorization_tpu.train import fg_gan as j_fg
    from test_torch_train_fg_gan import (_adam_state, _jax_params,
                                         _torch_batch, jax_draws)
    kw = dict(SMALL_KW, batch_size=2, image_size=64, coeff_perceptual=1.0)
    cfg, tcfg = FGGanConfig(**kw), tconfig.FGGanConfig(**kw)
    tree, perc = _bridged("Mixed_5b", key=5)
    state = create_fg_gan_state(tcfg, seed=3, device="cpu")
    gen, disc = state.generator, state.discriminator
    opt_g, opt_d = j_fg.make_optimizers(cfg)
    g_params, d_params = export_jax_tree(gen), export_jax_tree(disc)
    j_state = j_fg.FGGanTrainState(
        g_params=g_params, d_params=d_params,
        d_sn=export_jax_tree(disc, "sn"), g_opt_state=opt_g.init(g_params),
        d_opt_state=opt_d.init(d_params), step=jnp.zeros((), jnp.int32))
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(2):
        s, b = cfg.image_size, cfg.batch_size
        batches.append({
            "images": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
            "sketches": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
            "images_d": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
            "class_id": rng.randint(0, 25, (b,)).astype(np.int32),
            "class_id_d": rng.randint(0, 25, (b,)).astype(np.int32),
            "tokens": rng.randint(0, 10, (b, 4)).astype(np.int32)})
    key = jax.random.PRNGKey(7)
    j_state, j_m = j_fg.make_fg_gan_train_step(
        cfg, donate=False, perceptual_params=tree)(j_state, *batches, key)
    state, t_m = make_fg_gan_train_step(tcfg, perceptual=perc)(
        state, *(_torch_batch(b) for b in batches),
        draws=jax_draws(cfg, key, 0))
    for k in ("loss_d", "loss_g", "recon_l1"):
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]),
                                   rtol=LOSS_RTOL, atol=0, err_msg=k)
    want = flatten_tree(_np(_adam_state(j_state.g_opt_state).mu))
    got = _jax_params(gen, state.g_opt.mu)
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        scale = max(np.abs(w).max(), 1e-3 * top)
        assert np.abs(got[name] - w).max() / scale <= GRAD_REL, name
