"""Port parity of the alternative matching backbones
(``sketchyscenecolorization_torch/models/backbones.py``) against the JAX
package's ``models/backbones.py``, at S = 64 as ``tests/test_backbones.py``
runs them.  The weights are full width (FCN-8s' fc6 alone is 102.8M
parameters), so each backbone's JAX tree is built once, for the module,
and freed after; torch runs on one thread.

Tolerances, with the max-abs differences measured on the CPU:
- both exits of each backbone, against JAX ``apply``: 1e-4 of the output's
  largest magnitude (measured: FCN-8s 8.7e-7 / 1.2e-6, SegNet 2.8e-5 at
  the intermediate exit, DeepLab-v3+ 1.4e-6 / 1.5e-6).  SegNet's full head
  runs the decoder on the pooling decisions of the encoder; f32 rounding
  in another summation order can flip a near-tied window's argmax (one of
  16384 at enc_3 on this input with torch on four threads), which moves
  one value to another pixel of the unpooled map.  Its full exit is therefore compared with the
  port's pooling held to JAX's indices, and every window whose index
  differs must be a near tie (its two maxima within 1e-4 of the pooled
  map's largest magnitude; measured 6.1e-5 with no flip on one thread);
- ``max_pool_argmax_2x2``/``unpool_2x2``: equal values and indices,
  tied windows included (first maximum in row-major window order);
- ``RMI`` with each backbone at the sizes of ``tests/test_backbones.py:69``:
  ``up`` within 1e-5 absolute, the 1e-9-thresholded mask equal; the
  bridge round-trips every tree bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchyscenecolorization_tpu.config import MatchingConfig
from sketchyscenecolorization_tpu.models import backbones as jb
from sketchyscenecolorization_tpu.models import rmi as j_rmi
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.models import backbones as tb
from sketchyscenecolorization_torch.models.rmi import RMI
from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                         flatten_tree,
                                                         load_jax_tree)

S = 64
EXIT_REL = 1e-4
UP_ATOL = 1e-5
THRESH = 1e-9
JAX_MODULES = {"fcn_8s": jb.fcn8s, "segnet": jb.segnet,
               "deeplab_v3plus": jb.deeplab_v3plus}
CFG_KW = dict(vf_h=S // 8, vf_w=S // 8, H=S, W=S, vocab_size=12,
              w_emb_dim=16, v_emb_dim=16, m_rnn_size=8, w_rnn_size=16,
              max_len=5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=sorted(JAX_MODULES))
def backbone(request):
    """(name, JAX RMI tree as NumPy, the port's RMI loaded from it).  The
    backbone subtree is ``init_params`` of the JAX backbone with its
    default 47 classes (the full heads); the text subtree is JAX
    ``rmi.init_params``' own."""
    name = request.param
    jmod = JAX_MODULES[name]
    cfg = MatchingConfig(**CFG_KW, backbone=name)
    key = jax.random.PRNGKey(0)
    tree = {jmod.SCOPE: jax.jit(jmod.init_params)(key)[jmod.SCOPE],
            "text_sketchyscene": jax.jit(
                lambda k: j_rmi.init_params(k, cfg)["text_sketchyscene"])(
                    key)}
    tree = jax.tree.map(np.asarray, tree)
    tcfg = tconfig.MatchingConfig(**CFG_KW, backbone=name)
    model = load_jax_tree(RMI(tcfg), tree).eval()
    yield name, tree, model
    del tree, model


def _image(seed=0, n=1):
    rng = np.random.RandomState(seed)
    return rng.uniform(-120, 130, (n, S, S, 3)).astype(np.float32)


def _segnet_jax_indices(params, image):
    """The flat argmax indices of each of JAX SegNet's five pools."""
    p = params[jb.segnet.SCOPE]
    x, inds = jnp.asarray(image), []
    for name, chans in jb.SEGNET_ENC:
        for i in range(len(chans)):
            x = jb.segnet._conv_bn_relu(x, p[name][f"conv{i + 1}"])
        x, ind = jb._max_pool_argmax_2x2(x)
        inds.append(np.asarray(ind))
    return inds


@pytest.mark.parametrize("intermediate", [True, False])
def test_backbone_exits_match_jax(backbone, intermediate, monkeypatch):
    name, tree, model = backbone
    jmod = JAX_MODULES[name]
    image = _image()
    params = jax.tree.map(jnp.asarray, {jmod.SCOPE: tree[jmod.SCOPE]})
    want = np.asarray(jmod.apply(params, jnp.asarray(image),
                                 intermediate=intermediate))
    if name == "segnet" and not intermediate:
        held = iter(_segnet_jax_indices(params, image))
        pool = tb.max_pool_argmax_2x2
        flips = []

        def pool_at_jax_indices(x):
            vals, ind = pool(x)
            jind = torch.from_numpy(np.array(next(held)))
            n = x.shape[0]
            held_vals = torch.gather(x.reshape(n, -1), 1,
                                     jind.reshape(n, -1)).reshape(vals.shape)
            differ = ind != jind
            gap = (vals - held_vals)[differ].abs()
            flips.append((int(differ.sum()), float(gap.max()) if gap.numel()
                          else 0.0, float(vals.abs().max())))
            return held_vals, jind
        monkeypatch.setattr(tb, "max_pool_argmax_2x2", pool_at_jax_indices)
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(image),
                             intermediate=intermediate).numpy()
    assert got.shape == want.shape
    if intermediate:
        assert got.shape == (1, S // 8, S // 8, tb.BACKBONES[name][1])
    else:
        assert got.shape == (1, S, S, 47)
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"{name} intermediate={intermediate}: max-abs / max |ref| = "
          f"{err:.3g}")
    assert err <= EXIT_REL
    if name == "segnet" and not intermediate:
        print("argmax flips (count, |max gap|, pooled max) per pool:", flips)
        for count, gap, top in flips:
            assert gap <= EXIT_REL * top


def test_argmax_pool_and_unpool_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 6, 3).astype(np.float32)
    x[0, 2:4, 0:2, 1] = 1.5           # a window of four tied maxima
    x[1, 0:2, 2:4, 2] = [[-0.5, 2.0], [2.0, -1.0]]   # two tied maxima
    j_vals, j_idx = jb._max_pool_argmax_2x2(jnp.asarray(x))
    t_vals, t_idx = tb.max_pool_argmax_2x2(torch.from_numpy(x))
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(j_vals))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert int(t_idx[0, 1, 0, 1]) == (2 * 6 + 0) * 3 + 1   # first of four
    assert int(t_idx[1, 0, 1, 2]) == (0 * 6 + 3) * 3 + 2   # first of two
    j_up = jb._unpool_2x2(j_vals, j_idx, 8, 6)
    t_up = tb.unpool_2x2(t_vals, t_idx, 8, 6)
    np.testing.assert_array_equal(t_up.numpy(), np.asarray(j_up))


def test_rmi_with_backbone_matches_jax(backbone):
    name, tree, model = backbone
    cfg = MatchingConfig(**CFG_KW, backbone=name)
    image = _image(1)
    words = np.array([[2, 3, 4, 0, 0], [5, 1, 7, 9, 11]], np.int32)
    lens = np.array([3, 5], np.int32)
    want = np.asarray(j_rmi.apply(jax.tree.map(jnp.asarray, tree), cfg,
                                  jnp.asarray(image[[0, 0]]),
                                  jnp.asarray(words), jnp.asarray(lens)).up)
    with torch.no_grad():
        got = model.apply_fused(model.extract_visual(torch.from_numpy(image)),
                                torch.from_numpy(words).long(),
                                torch.from_numpy(lens).long()).up.numpy()
    assert got.shape == (2, S, S, 1)
    print(f"{name}: RMI up max-abs {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=UP_ATOL)
    np.testing.assert_array_equal(got >= THRESH, want >= THRESH)


def test_bridge_round_trips_each_tree(backbone):
    _, tree, model = backbone
    want = flatten_tree(tree)
    got = flatten_tree(export_jax_tree(model))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)


def test_cli_matching_inference_with_segnet(tmp_path, capsys, monkeypatch):
    """``cli_matching --mode inference --backbone segnet --device cpu`` on
    fresh weights (no snapshot in the run dir) writes the overlay of the
    engine's prediction from the same seeded model."""
    import os

    from PIL import Image

    from sketchyscenecolorization_torch import cli_matching
    from sketchyscenecolorization_torch.data import matching_dataset as md
    from sketchyscenecolorization_torch.data.fixtures import \
        load_sketch_image
    from sketchyscenecolorization_torch.pipeline.engines import \
        MatchingEngine
    from sketchyscenecolorization_torch.text import load_vocab
    from sketchyscenecolorization_torch.utils import visualization as t_viz
    monkeypatch.setattr(md, "IMAGE_SIZE", md.IMAGE_SIZE)        # restored
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    vocab_path = os.path.join(root, "data", "match_vocab.txt")
    gt = tmp_path / "val" / "DRAWING_GT"
    gt.mkdir(parents=True)
    sketch = np.full((S, S, 3), 255, np.uint8)
    sketch[10:40, 12:50:3] = 0
    Image.fromarray(sketch).save(gt / "L0_sample1.png")
    run_dir = str(tmp_path / "run")
    assert cli_matching.main([
        "--mode", "inference", "--backbone", "segnet", "--data_base_dir",
        str(tmp_path), "--vocab_path", vocab_path, "--run_dir", run_dir,
        "--image_size", str(S), "--model_scale", "0.016", "--image_id", "1",
        "--instruction", "the bus", "--device", "cpu", "--seed", "2"]) == 0
    assert "restored" not in capsys.readouterr().out
    cfg = tconfig.MatchingConfig(
        backbone="segnet", H=S, W=S, vf_h=S // 8, vf_w=S // 8,
        w_emb_dim=16, v_emb_dim=16, m_rnn_size=8, w_rnn_size=16)
    model = RMI(cfg, torch.Generator().manual_seed(2)).eval()
    engine = MatchingEngine(cfg, model, load_vocab(vocab_path), device="cpu")
    image = load_sketch_image(str(gt / "L0_sample1.png"), dtype=np.uint8,
                              size=S)
    want = t_viz.semantic_overlay(image, engine.predict_mask(image,
                                                             "the bus"))
    got = np.array(Image.open(os.path.join(run_dir, "visualize",
                                           "L0_sample1_pred.png")))
    np.testing.assert_array_equal(got, want)
