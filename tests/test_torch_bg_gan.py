"""Port parity of the BG generator (``sketchyscenecolorization_torch/models/bg_gan.py``)
and its ops: the flax modules' params go through the bridge, and both
sides see the same seeded inputs.

Tolerances (max-abs, measured when written in parentheses):
- ``pad1_conv4``, ``conv2d_transpose``, ``ConvEx`` with asymmetric SAME
  pads, ``BatchStatsNorm``: 1e-5 (<= 9.6e-7);
- the generators at 64^2, ngf 4, vocab 8: 1e-4 on rgb and region logits
  for the residual generator without ``multi_residual`` (measured 8.0e-6
  and 3.1e-5) and for pix2pix (measured 2.0e-7).  With ``multi_residual``
  (31 bottleneck blocks of batch-stats BN on random weights) float32 is
  itself far from the exact result: the JAX output differs from a float64
  evaluation of the port's module on the same weights by 8.0e-3 (rgb) and
  7.0e-4 (region logits), the port's float32 output from it by up to
  1.0e-2, and the two float32 outputs from each other by 2.3e-3 to 1.1e-2
  (the port's summation order follows the CPU's thread count).  There
  both float32 outputs are held within 2e-2 (1% of the rgb range) of the
  float64 evaluation, so within 4e-2 of each other; a structural fault (a
  wrong layer, layout or activation) moves them by 0.1 or more;
- the golden statistics of ``tests/test_goldens.py:52-66``: rtol 2e-3, as
  there (measured 1.1e-6 relative);
- the bridge round trip: bit for bit;
- ``BGColorizeEngine.colorize``: u8 within 1 LSB of the JAX engine's
  (measured 0 LSB), region labels equal wherever the JAX logits' top two
  differ by more than twice the logits' tolerance.  It runs on the two
  generators whose float32 output is accurate to 1e-4; the engine's code
  does not depend on ``multi_residual``."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchyscenecolorization_tpu.config import BGGanConfig
from sketchyscenecolorization_tpu.models import bg_gan as j_bg
from sketchyscenecolorization_tpu.models.gan_layers import \
    BatchStatsNorm as JBatchStatsNorm
from sketchyscenecolorization_tpu.ops import conv as j_conv
from sketchyscenecolorization_tpu.pipeline.engines import \
    BGColorizeEngine as JBGColorizeEngine
from sketchyscenecolorization_tpu.text import colorization_encode
from sketchyscenecolorization_tpu.train.bg_gan import build_models
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.models import bg_gan
from sketchyscenecolorization_torch.models.gan_layers import BatchStatsNorm
from sketchyscenecolorization_torch.ops.conv import (conv2d_transpose,
                                                     pad1_conv4, same_pads)
from sketchyscenecolorization_torch.pipeline.engines import BGColorizeEngine
from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                         flatten_tree,
                                                         load_jax_tree)

OP_ATOL = 1e-5
GEN_ATOL = 1e-4
EXACT_ATOL = 2e-2     # float32 against the float64 evaluation
GOLDEN_RTOL = 2e-3
VARIANTS = {
    "residual_multi": dict(multi_residual=True),
    "residual": dict(multi_residual=False),
    "pix2pix": dict(residual_enc_g=False),
}


def _cfg_kw(variant):
    return dict(batch_size=1, image_size=64, vocab_size=8, max_len=4, ngf=4,
                ndf=4, **VARIANTS[variant])


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


@pytest.mark.parametrize("stride", [1, 2])
def test_pad1_conv4_matches_jax(stride):
    x, w = _rand((2, 10, 10, 5), 0), _rand((4, 4, 5, 6), 1)
    want = np.asarray(j_conv.pad1_conv4(jnp.asarray(x), jnp.asarray(w),
                                        stride))
    got = pad1_conv4(torch.from_numpy(x),
                     torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), stride)
    assert got.shape == want.shape == (2, 9 if stride == 1 else 5,
                                       9 if stride == 1 else 5, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OP_ATOL)


@pytest.mark.parametrize("cin,cout", [(5, 3), (6, 6)])
def test_conv2d_transpose_matches_jax(cin, cout):
    x, w = _rand((2, 6, 7, cin), 2), _rand((4, 4, cin, cout), 3)
    want = np.asarray(j_conv.conv2d_transpose(jnp.asarray(x), jnp.asarray(w)))
    got = conv2d_transpose(torch.from_numpy(x),
                           torch.from_numpy(w.transpose(2, 3, 0, 1).copy()))
    assert got.shape == want.shape == (2, 12, 14, cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OP_ATOL)
    if cin == cout:
        # the OIHW layout of every other conv fits the shape but is wrong
        wrong = conv2d_transpose(
            torch.from_numpy(x),
            torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        assert np.abs(wrong.numpy() - want).max() > 1e-2


def _bridged(jmod, tmod, x, key):
    params = jmod.init(jax.random.PRNGKey(key), jnp.asarray(x))["params"]
    load_jax_tree(tmod, _np_tree(params))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("kernel,stride,pads", [(7, 2, (2, 3)),
                                                (4, 1, (1, 2))])
def test_conv_ex_asymmetric_same_pads(kernel, stride, pads):
    x = _rand((1, 16, 16, 3), 4)
    assert same_pads(16, kernel, stride) == pads
    got, want = _bridged(j_bg.ConvEx(5, stride, kernel),
                         bg_gan.ConvEx(3, 5, stride, kernel), x, 5)
    assert got.shape == want.shape == (1, 16 // stride, 16 // stride, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_ATOL)


def test_batch_stats_norm_matches_jax():
    x = _rand((2, 5, 6, 7), 6, -3.0, 4.0)
    got, want = _bridged(JBatchStatsNorm(), BatchStatsNorm(7), x, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_ATOL)


def _build(variant):
    jcfg = BGGanConfig(**_cfg_kw(variant))
    gen, _ = build_models(jcfg)
    params = gen.init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3)),
                      jnp.ones((1, 4), jnp.int32))["params"]
    model = bg_gan.build_generator(tconfig.BGGanConfig(**_cfg_kw(variant)))
    load_jax_tree(model, _np_tree(params))
    return variant, jcfg, gen, params, model.eval()


@pytest.fixture(scope="module", params=list(VARIANTS))
def generators(request):
    return _build(request.param)


def _outputs(result):
    return result if isinstance(result, tuple) else (result,)


def test_generator_matches_flax(generators):
    variant, _, gen, params, model = generators
    x = _rand((1, 64, 64, 3), 8)
    tokens = np.array([[0, 3, 5, 7]], np.int32)
    want = _outputs(gen.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(tokens)))
    tokens_t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        got = _outputs(model(torch.from_numpy(x), tokens_t))
        exact = _outputs(copy.deepcopy(model).double()(
            torch.from_numpy(x).double(), tokens_t))
    assert len(got) == len(want) == (1 if variant == "pix2pix" else 2)
    for g, w, e in zip(got, want, exact):
        assert g.shape == w.shape
        if variant == "residual_multi":
            for f32 in (np.asarray(w), g.numpy()):
                np.testing.assert_allclose(f32.astype(np.float64), e.numpy(),
                                           rtol=0, atol=EXACT_ATOL)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=GEN_ATOL)


def test_bridge_round_trip_is_exact(generators):
    _, _, _, params, model = generators
    want = flatten_tree(_np_tree(params))
    got = flatten_tree(export_jax_tree(model))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype and \
            np.array_equal(got[path], arr), path


def test_golden_statistics_through_the_bridge():
    """``tests/test_goldens.py::test_bg_generator_golden`` on the port."""
    jcfg = BGGanConfig(**_cfg_kw("residual"))
    gen, _ = build_models(jcfg)
    params = gen.init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3)),
                      jnp.ones((1, 4), jnp.int32))["params"]
    sk = np.array(jax.random.uniform(jax.random.PRNGKey(3), (1, 64, 64, 3),
                                     jnp.float32, -1, 1))
    model = load_jax_tree(
        bg_gan.build_generator(tconfig.BGGanConfig(**_cfg_kw("residual"))),
        _np_tree(params))
    with torch.no_grad():
        out, reg = model(torch.from_numpy(sk), torch.ones(1, 4,
                                                          dtype=torch.long))
    np.testing.assert_allclose(float(out.mean()), -0.011200271546840668,
                               rtol=GOLDEN_RTOL)
    np.testing.assert_allclose(float(reg.mean()), 0.3448888957500458,
                               rtol=GOLDEN_RTOL)


@pytest.mark.parametrize("variant", ["residual", "pix2pix"])
def test_engine_matches_jax_engine(variant):
    _, jcfg, gen, params, model = _build(variant)
    vocab = {w: i for i, w in enumerate(
        ["<pad>", "<unk>", "the", "sky", "is", "blue", "ground", "green"])}
    jeng = JBGColorizeEngine(jcfg, params, vocab)
    teng = BGColorizeEngine(tconfig.BGGanConfig(**_cfg_kw(variant)), model,
                            vocab, device="cpu")
    image = np.random.RandomState(9).randint(0, 256, (64, 64, 3)) \
        .astype(np.uint8)
    text = "the sky is blue"
    want, want_labels = jeng.colorize(image, text)
    got, labels = teng.colorize(image, text)
    assert got.dtype == np.uint8 and got.shape == want.shape == (64, 64, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert labels.dtype == np.uint8 and labels.shape == (64, 64)
    if variant == "pix2pix":
        assert not labels.any() and not want_labels.any()
    else:
        x = image[None].astype(np.float32) / 255.0 * 2.0 - 1.0
        tokens = np.asarray(colorization_encode(text, vocab, jcfg.max_len),
                            np.int32)[None]
        _, logits = gen.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(tokens))
        top2 = np.sort(np.asarray(logits)[0], axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 2 * GEN_ATOL
        assert clear.mean() > 0.5
        np.testing.assert_array_equal(labels[clear], want_labels[clear])
    rgb, none = teng.colorize(image, text, want_region=False)
    assert none is None and np.array_equal(rgb, got)

