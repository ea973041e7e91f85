"""Serving the matching weights that the port's own trainer writes, and the
matching engine's mask prediction.

- A session built on a ``train_matching`` run dir (``match_ckpt_dir =
  <run_dir>/snapshots``) gives the trained module's ``up`` logits bit for
  bit on the CPU; snapshots it cannot read raise, naming their ROADMAP
  item; an empty directory gives the fresh weights.
- ``cli_matching --mode inference --device cpu`` restores the run dir and
  writes the overlay of the trained module's mask to ``_pred.png``.
- ``MatchingEngine.predict_masks`` on N texts equals N ``predict_mask``
  calls (as ``tests/test_pipeline.py:289`` holds for JAX), and agrees with
  the JAX engine on bridged weights: ``up`` logits within 1e-5 max-abs
  (measured 6.0e-7), masks equal wherever |logit - threshold| > 1e-6.
- The port's copy of ``visualize_sem_seg`` equals the JAX package's."""
import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sketchyscenecolorization_tpu.pipeline.engines import PIXEL_MU
from sketchyscenecolorization_tpu.pipeline.factory import \
    build_session as jax_build_session
from sketchyscenecolorization_tpu.utils import visualization as j_viz
from sketchyscenecolorization_torch import cli_matching
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.data import MatchingTrainDataset
from sketchyscenecolorization_torch.data import matching_dataset as md
from sketchyscenecolorization_torch.data.fixtures import load_sketch_image
from sketchyscenecolorization_torch.models.rmi import RMI
from sketchyscenecolorization_torch.pipeline.engines import MatchingEngine
from sketchyscenecolorization_torch.pipeline.factory import build_session
from sketchyscenecolorization_torch.text import load_vocab
from sketchyscenecolorization_torch.train import train_matching
from sketchyscenecolorization_torch.utils import visualization as t_viz
from sketchyscenecolorization_torch.utils.bridge import load_jax_tree
from test_data_and_harness import _write_matching_corpus
from test_pipeline import small_config, write_fixtures
from test_torch_session import port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, "data", "match_vocab.txt")
SIZE, SCALE = 48, 0.016
LOGIT_ATOL = 1e-5
THRESH_MARGIN = 1e-6
# the MatchingConfig that ``cli_matching --image_size 48 --model_scale
# 0.016`` builds
CLI_CFG = tconfig.MatchingConfig(
    H=SIZE, W=SIZE, vf_h=SIZE // 8, vf_w=SIZE // 8,
    w_emb_dim=int(1000 * SCALE), v_emb_dim=int(1000 * SCALE),
    m_rnn_size=int(500 * SCALE), w_rnn_size=int(1000 * SCALE))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two ``train_matching`` steps on the CPU into a run dir; returns
    (tmp dir, run dir, the trained module)."""
    tmp = tmp_path_factory.mktemp("trained")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(md, "IMAGE_SIZE", SIZE)
        base, cap_path = _write_matching_corpus(tmp)
        ds = MatchingTrainDataset(base, cap_path, load_vocab(VOCAB),
                                  max_len=CLI_CFG.max_len)
        run_dir = str(tmp / "run")
        state = train_matching(CLI_CFG, ds,
                               RMI(CLI_CFG, torch.Generator().manual_seed(3)),
                               run_dir, max_iters=2, device="cpu")
    assert state.step == 2
    return tmp, run_dir, state.model.eval()


def _framework(tmp, match_ckpt_dir="", fg_ckpt_dir="", bg_ckpt_dir=""):
    cfg = port_config(small_config(tmp))
    return dataclasses.replace(
        cfg, matching=CLI_CFG, pipeline=dataclasses.replace(
            cfg.pipeline, device_compositing=False,
            match_ckpt_dir=str(match_ckpt_dir), fg_ckpt_dir=str(fg_ckpt_dir),
            bg_ckpt_dir=str(bg_ckpt_dir)))


def _up(model, seed=0):
    rng = np.random.RandomState(seed)
    image = torch.from_numpy(
        (rng.randn(1, SIZE, SIZE, 3) * 50).astype(np.float32))
    words = torch.tensor([[2, 5, 9] + [0] * (CLI_CFG.max_len - 3)])
    with torch.no_grad():
        return model(image, words, torch.tensor([3])).up


def test_session_serves_trained_matching_weights(trained):
    tmp, run_dir, model = trained
    session = build_session(
        _framework(tmp, os.path.join(run_dir, "snapshots")), device="cpu")
    fresh = RMI(CLI_CFG, torch.Generator().manual_seed(0))
    assert not torch.equal(_up(fresh), _up(model))
    assert torch.equal(_up(session.matching.model), _up(model))


def test_unreadable_snapshots_raise(trained, tmp_path):
    tmp, run_dir, _ = trained
    fg = tmp_path / "fg"
    (fg / "step_3").mkdir(parents=True)          # a GAN step without state.pt
    with pytest.raises(ValueError, match="orbax_to_torch"):
        build_session(_framework(tmp, fg_ckpt_dir=fg), device="cpu")
    with pytest.raises(ValueError, match="orbax_to_torch"):
        build_session(_framework(tmp, bg_ckpt_dir=fg), device="cpu")
    with pytest.raises(ValueError, match="generator"):   # not a GAN run's
        build_session(_framework(tmp, fg_ckpt_dir=os.path.join(
            run_dir, "snapshots")), device="cpu")
    orbax = tmp_path / "orbax"
    shutil.copytree(os.path.join(run_dir, "snapshots"), orbax)
    (orbax / "step_7" / "default").mkdir(parents=True)   # no state.pt
    with pytest.raises(ValueError, match="orbax_to_torch"):
        build_session(_framework(tmp, match_ckpt_dir=orbax), device="cpu")


def test_empty_checkpoint_dir_gives_fresh_weights(trained, tmp_path):
    tmp, _, _ = trained
    empty = tmp_path / "empty"
    empty.mkdir()
    got = build_session(_framework(tmp, match_ckpt_dir=empty), device="cpu")
    want = build_session(_framework(tmp), device="cpu")
    for key, value in want.matching.model.state_dict().items():
        assert torch.equal(got.matching.model.state_dict()[key], value), key


def test_cli_matching_inference_writes_prediction(trained, capsys):
    tmp, run_dir, model = trained
    val = tmp / "val" / "DRAWING_GT"
    val.mkdir(parents=True, exist_ok=True)
    shutil.copy(tmp / "train" / "DRAWING_GT" / "L0_sample1.png", val)
    argv = ["--mode", "inference", "--data_base_dir", str(tmp),
            "--vocab_path", VOCAB, "--run_dir", run_dir, "--image_size",
            str(SIZE), "--model_scale", str(SCALE), "--image_id", "1",
            "--instruction", "the bus", "--device", "cpu"]
    assert cli_matching.main(argv) == 0
    assert "restored step 2" in capsys.readouterr().out
    out = os.path.join(run_dir, "visualize", "L0_sample1_pred.png")
    sketch = load_sketch_image(str(val / "L0_sample1.png"), dtype=np.uint8,
                               size=SIZE)
    engine = MatchingEngine(CLI_CFG, model, load_vocab(VOCAB), device="cpu")
    want = t_viz.semantic_overlay(sketch, engine.predict_mask(sketch,
                                                              "the bus"))
    np.testing.assert_array_equal(np.array(Image.open(out)), want)
    # as in JAX, only --mode train reads --pretrained_npz (no such file here)
    with pytest.raises(SystemExit, match="needs --image_id"):
        cli_matching.main(["--mode", "inference", "--pretrained_npz",
                           "tf_vars.npz", "--image_size", str(SIZE),
                           "--model_scale", str(SCALE), "--vocab_path", VOCAB,
                           "--device", "cpu"])


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX and the port's matching engine on the same weights, and the
    sketch of ``write_fixtures``."""
    tmp = tmp_path_factory.mktemp("engines")
    write_fixtures(str(tmp / "examples"))
    cfg = small_config(tmp)
    jeng = jax_build_session(cfg, seed=0).matching
    tcfg = port_config(cfg)
    model = load_jax_tree(RMI(tcfg.matching),
                          jax.tree.map(np.asarray, jeng.params))
    teng = MatchingEngine(tcfg.matching, model, jeng.vocab,
                          tcfg.pipeline.score_thresh, device="cpu")
    sketch = load_sketch_image(str(tmp / "examples" / "sketches" / "7.png"),
                               dtype=np.uint8, size=cfg.pipeline.image_size)
    return jeng, teng, sketch


TEXTS = ["the bus", "the bus is yellow", "the grass"]


def test_predict_masks_batched_matches_single(engines):
    _, teng, sketch = engines
    batched = teng.predict_masks(sketch, TEXTS)
    assert batched.shape == (3, *sketch.shape[:2])
    assert batched.dtype == np.float32
    for i, text in enumerate(TEXTS):
        np.testing.assert_array_equal(batched[i],
                                      teng.predict_mask(sketch, text))


def test_predict_masks_match_jax(engines):
    jeng, teng, sketch = engines
    image = (sketch.astype(np.float32) - PIXEL_MU).astype(np.float32)[None]
    words, lens = jeng.encode_texts(TEXTS)
    want_up = np.asarray(jeng._fuse(jeng.params,
                                    jeng._extract(jeng.params, image),
                                    words, lens))[..., 0]
    with torch.no_grad():
        got_up = teng.model.apply_fused(
            teng.model.extract_visual(torch.from_numpy(image)),
            torch.from_numpy(words).long(),
            torch.from_numpy(lens).long()).up[..., 0].numpy()
    np.testing.assert_allclose(got_up, want_up, rtol=0, atol=LOGIT_ATOL)
    want = np.asarray(jeng.predict_masks(sketch, TEXTS))
    got = teng.predict_masks(sketch, TEXTS)
    clear = np.abs(want_up - jeng.score_thresh) > THRESH_MARGIN
    np.testing.assert_array_equal(got[clear], want[clear])


def test_visualize_sem_seg_copy_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    image = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    mask = (rng.rand(20, 30) > 0.5).astype(np.float32)
    want = j_viz.visualize_sem_seg(image, mask, "x", str(tmp_path / "j.png"))
    got = t_viz.visualize_sem_seg(image, mask, "x", str(tmp_path / "t.png"))
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
