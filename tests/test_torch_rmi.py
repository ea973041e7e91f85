"""Port parity of the RMI matching model at the golden config of
``tests/test_goldens.py``: JAX ``rmi.init_params`` weights go through the
bridge into ``sketchyscenecolorization_torch.models.rmi.RMI``, and both
models see the same seeded image and end-padded words.  Tolerance 1e-5
absolute on the ``up`` logits (|up| <= 0.54; 101 f32 conv layers summed in
another order; measured max-abs difference 4.0e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchyscenecolorization_tpu.config import MatchingConfig
from sketchyscenecolorization_tpu.models import rmi as j_rmi
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.models.rmi import RMI
from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                         flatten_tree,
                                                         load_jax_tree)

CFG_KW = dict(vf_h=6, vf_w=6, H=48, W=48, vocab_size=12, w_emb_dim=16,
              v_emb_dim=16, m_rnn_size=8, w_rnn_size=16, max_len=5)
CFG = MatchingConfig(**CFG_KW)
TCFG = tconfig.MatchingConfig(**CFG_KW)


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(np.asarray,
                          j_rmi.init_params(jax.random.PRNGKey(0), CFG))
    model = load_jax_tree(RMI(TCFG), params).eval()
    return params, model


def test_bridge_round_trips_leaf_by_leaf(models):
    params, model = models
    want = flatten_tree(params)
    got = flatten_tree(export_jax_tree(model))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)


def test_bridge_refuses_missing_and_extra_leaves(models):
    params, _ = models
    text = dict(params["text_sketchyscene"])
    del text["embedding"]
    with pytest.raises(ValueError, match="missing"):
        load_jax_tree(RMI(TCFG), {**params, "text_sketchyscene": text})
    with pytest.raises(ValueError, match="extra"):
        load_jax_tree(RMI(TCFG), {**params, "stray": {"w": np.zeros(2)}})


def test_up_logits_match_jax(models):
    params, model = models
    rng = np.random.RandomState(1)
    image = rng.uniform(-120, 130, (1, 48, 48, 3)).astype(np.float32)
    words = np.array([[2, 3, 4, 0, 0], [5, 1, 7, 9, 11]], np.int32)
    lens = np.array([3, 5], np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    visual = j_rmi.extract_visual(jparams, CFG, jnp.asarray(image))
    want = j_rmi.apply_fused(jparams, CFG, visual, jnp.asarray(words),
                             jnp.asarray(lens)).up
    with torch.no_grad():
        got = model.apply_fused(model.extract_visual(torch.from_numpy(image)),
                                torch.from_numpy(words).long(),
                                torch.from_numpy(lens).long()).up
    assert got.shape == (2, 48, 48, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


VARIANTS = {"use_attn": dict(use_attn=True),
            "recur_attn": dict(fusion_type="RecurAttn")}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    """The word-attention and RecurAttn fusions at the golden config's
    sizes (RecurAttn sets its four widths to 256 itself)."""
    kw = {**CFG_KW, **VARIANTS[request.param]}
    cfg, tcfg = MatchingConfig(**kw), tconfig.MatchingConfig(**kw)
    params = jax.tree.map(np.asarray,
                          j_rmi.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, params, load_jax_tree(RMI(tcfg), params).eval()


def test_variant_bridge_round_trips_with_attention_leaves(variant):
    cfg, params, model = variant
    want = flatten_tree(params)
    new = ("text_sketchyscene/attn_fc/DW" if cfg.use_attn
           else "text_sketchyscene/h_proj/DW")
    assert new in want
    got = flatten_tree(export_jax_tree(model))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)


def test_variant_up_logits_match_jax(variant):
    """``up`` of the word-attention and RecurAttn fusions against JAX
    ``rmi.apply``; tolerance 1e-5 absolute, as for the default fusion."""
    cfg, params, model = variant
    rng = np.random.RandomState(1)
    image = rng.uniform(-120, 130, (1, 48, 48, 3)).astype(np.float32)
    words = np.array([[2, 3, 4, 0, 0], [5, 1, 7, 9, 11]], np.int32)
    lens = np.array([3, 5], np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    want = j_rmi.apply(jparams, cfg, jnp.asarray(image[[0, 0]]),
                       jnp.asarray(words), jnp.asarray(lens)).up
    with torch.no_grad():
        got = model.apply_fused(model.extract_visual(torch.from_numpy(image)),
                                torch.from_numpy(words).long(),
                                torch.from_numpy(lens).long()).up
    assert got.shape == (2, 48, 48, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_unported_backbones_and_unknown_fusions_are_refused():
    """Every backbone of the JAX package is ported
    (``tests/test_torch_backbones.py``); another name is refused."""
    with pytest.raises(ValueError, match="backbone"):
        RMI(tconfig.MatchingConfig(**CFG_KW, backbone="vgg16"))
    with pytest.raises(ValueError, match="fusion_type"):
        RMI(tconfig.MatchingConfig(**CFG_KW, fusion_type="Concat"))


def test_variant_serves_through_the_matching_engine(variant):
    """Both fusions serve through the port's ``MatchingEngine`` (the
    counterpart of ``tests/test_backbones.py:84-102``): per-instance
    occupancy scores of two instructions against the JAX engine's, from
    the same weights, within 1e-9."""
    from sketchyscenecolorization_tpu.pipeline.engines import \
        MatchingEngine as JaxEngine
    from sketchyscenecolorization_torch.pipeline.engines import MatchingEngine
    cfg, params, model = variant
    vocab = {"<pad>": 0, "<unk>": 1, "the": 2, "bus": 3, "car": 4}
    sketch = np.full((48, 48, 3), 255, np.uint8)
    sketch[10:30, 10:40] = 0
    sketch[32:44, 5:20] = 0
    masks = np.zeros((2, 48 * 48), np.float32)
    masks[0].reshape(48, 48)[8:32, 8:42] = 1
    masks[1].reshape(48, 48)[30:46, 3:22] = 1
    image = (sketch.astype(np.float32) - 128.0)[None]
    engine = MatchingEngine(cfg, model, vocab, device="cpu")
    words, lens = engine.encode_texts(["the bus", "the car the bus"])
    bin_drawing = engine.binarize_drawing(sketch).astype(np.float32)
    got = engine.score_instances(torch.from_numpy(image), words, lens,
                                 torch.from_numpy(masks),
                                 masks.sum(1), torch.from_numpy(bin_drawing))
    jengine = JaxEngine(cfg, jax.tree.map(jnp.asarray, params), vocab)
    want = jengine.score_instances(jnp.asarray(image), words, lens,
                                   jnp.asarray(masks), masks.sum(1),
                                   jnp.asarray(bin_drawing))
    assert got.shape == (2, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
