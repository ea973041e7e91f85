"""The port's fresh initialisation against the JAX package's, leaf by leaf:
the matching model with each of its four backbones (full width), the FG
GAN pairs (MRU with two cells a stage and the projection head, Pix2Pix,
Residual) and the BG generator and discriminators.  The port draws from
``torch.Generator``s and JAX from its keys, so the values differ; every
leaf must come from the same distribution.

For each leaf of JAX's tree (the port's exported in the JAX layout):
- a constant leaf (zeros, ones, the PReLU leak 0.2) must be equal;
- a random leaf of n >= 64 elements: its mean within 6 sqrt(2/n) s and
  its standard deviation within 6 s / sqrt(n) of JAX's, s the larger of
  the two standard deviations (6 standard errors of a difference of two
  samples' statistics);
- a smaller random leaf (a spectral-norm vector of one to a few
  elements): the port's largest magnitude within 3 x JAX's distribution's
  bound (the truncated normal's 2) and the leaf not constant unless it
  has one element.
A leaf that fails is a fault of the port's initialiser (``ROADMAP.md``
section C).  One did: a fresh FG discriminator held its spectral-norm
vectors as drawn, while flax's ``init`` stores them after one power
iteration (a unit vector: ``embed_u``'s ones become
``l2n(l2n(ones E^T) E)``); the port now iterates them once at
construction (``models/gan_layers.py:init_sn``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchyscenecolorization_tpu import config as jconfig
from sketchyscenecolorization_tpu.models import rmi as j_rmi
from sketchyscenecolorization_tpu.train import bg_gan as j_bg
from sketchyscenecolorization_tpu.train import fg_gan as j_fg
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.models import bg_gan, fg_gan
from sketchyscenecolorization_torch.models.rmi import RMI
from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                         flatten_tree)

SIGMAS = 6.0
SMALL = 64
MATCH_KW = dict(vf_h=8, vf_w=8, H=64, W=64, vocab_size=12, w_emb_dim=16,
                v_emb_dim=16, m_rnn_size=8, w_rnn_size=16, max_len=5)
FG_KW = dict(batch_size=2, image_size=64, vocab_size=10, max_len=4,
             base_channels=4, noise_dim=8)
FG_VARIANTS = {"MRU_blocks2": dict(num_blocks=2),
               "MRU_proj_d": dict(proj_d=True),
               "Pix2Pix": dict(block_type="Pix2Pix"),
               "Residual": dict(block_type="Residual")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _compare(port_tree, jax_tree, what):
    want = flatten_tree(jax.tree.map(np.asarray, jax_tree))
    got = flatten_tree(port_tree)
    assert sorted(got) == sorted(want), what
    n_random = 0
    for path, w in want.items():
        g = np.asarray(got[path], np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, path)
        if w.size > 1 and w.std() == 0 or w.size == 1 and path.endswith(
                ("prelu_param", "param", "factor")):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}")
            continue
        n_random += 1
        if w.size < SMALL:
            assert np.abs(g).max() <= 3.0 * 2.0, (what, path)
            assert w.size == 1 or g.std() > 0, (what, path)
            continue
        s = max(w.std(), g.std())
        n = w.size
        assert abs(g.mean() - w.mean()) <= SIGMAS * s * np.sqrt(2.0 / n), \
            (what, path, g.mean(), w.mean(), s)
        assert abs(g.std() - w.std()) <= SIGMAS * s / np.sqrt(n), \
            (what, path, g.std(), w.std())
    print(f"{what}: {len(want)} leaves, {n_random} random")
    return n_random


@pytest.mark.parametrize("backbone", ["deeplab", "fcn_8s", "segnet",
                                      "deeplab_v3plus"])
def test_matching_init_matches_jax(backbone):
    cfg = jconfig.MatchingConfig(**MATCH_KW, backbone=backbone)
    want = jax.jit(lambda k: j_rmi.init_params(k, cfg))(
        jax.random.PRNGKey(0))
    model = RMI(tconfig.MatchingConfig(**MATCH_KW, backbone=backbone),
                torch.Generator().manual_seed(0))
    assert _compare(export_jax_tree(model), want, backbone) > 10


def _fg_init(cfg):
    gen, disc = j_fg.build_models(cfg)
    s, b = cfg.image_size, cfg.batch_size
    img = jnp.zeros((b, s, s, 3), jnp.float32)
    g_vars = jax.jit(gen.init)(
        jax.random.PRNGKey(1), img, jnp.zeros((b, cfg.max_len), jnp.int32),
        jnp.zeros((b,), jnp.int32), jnp.zeros((b, cfg.noise_dim)))
    d_vars = jax.jit(disc.init)(jax.random.PRNGKey(2), img, img,
                                jnp.zeros((b,), jnp.int32))
    return g_vars, d_vars


@pytest.mark.parametrize("variant", sorted(FG_VARIANTS))
def test_fg_gan_init_matches_jax(variant):
    kw = dict(FG_KW, **FG_VARIANTS[variant])
    g_vars, d_vars = _fg_init(jconfig.FGGanConfig(**kw))
    tcfg = tconfig.FGGanConfig(**kw)
    gen = fg_gan.build_generator(tcfg, torch.Generator().manual_seed(1))
    disc = fg_gan.build_discriminator(tcfg, torch.Generator().manual_seed(2))
    _compare(export_jax_tree(gen), g_vars["params"], f"{variant} G")
    _compare(export_jax_tree(disc), d_vars["params"], f"{variant} D")
    _compare(export_jax_tree(disc, "sn"), d_vars.get("sn", {}),
             f"{variant} D sn")


@pytest.mark.parametrize("residual_enc_d", [True, False])
def test_bg_gan_init_matches_jax(residual_enc_d):
    kw = dict(image_size=64, vocab_size=10, ngf=8, ndf=8,
              residual_enc_d=residual_enc_d)
    cfg = jconfig.BGGanConfig(**kw)
    gen, disc = j_bg.build_models(cfg)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    g_vars = jax.jit(gen.init)(jax.random.PRNGKey(3), x,
                               jnp.zeros((1, cfg.max_len), jnp.int32))
    d_vars = jax.jit(disc.init)(jax.random.PRNGKey(4), x, x)
    tcfg = tconfig.BGGanConfig(**kw)
    _compare(export_jax_tree(bg_gan.build_generator(
        tcfg, torch.Generator().manual_seed(3))), g_vars["params"], "BG G")
    _compare(export_jax_tree(bg_gan.build_discriminator(
        tcfg, torch.Generator().manual_seed(4))), d_vars["params"], "BG D")
