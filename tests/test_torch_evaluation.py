"""The port's evaluation (``sketchyscenecolorization_torch/evaluation``,
``train/harness.py:eval_matching``, ``cli_matching --mode eval``) against
the JAX package on the CPU.

- Mirrors of ``tests/test_evaluation.py`` (all 9) on the port.
- The metrics on seeded random masks, boxes and scores, and
  ``MatchingEvaluator`` with the instance mAP over seeded predictions and
  ``seg_data`` files, and ``inception_score``: equal to JAX's numbers
  (exact; both are the same NumPy).
- ``acgan_class_probs`` on the FG discriminator with JAX's ``params`` and
  ``sn`` bridged: 1e-6 max-abs on the posteriors (measured 7.5e-9).
- ``eval_matching`` end to end at a 48^2 ``MatchingConfig`` on a synthetic
  val split (``write_val_split``): JAX's and the port's ``MatchingEngine``
  on bridged weights, with and without ``predict_batch_fn``, mask AP on:
  every predicted mask equal and the results equal; the oracle and empty
  predictors of ``tests/test_procedures.py:69`` on the port, the oracle
  with AP too (mAP 1).
- ``cli_matching --mode eval --device cpu`` restores a run and appends
  the summary to its result file, with and without ``--no_mask_ap``.
"""
import json
import os

import jax
import numpy as np
import pytest
import scipy.io
import torch
from PIL import Image

from sketchyscenecolorization_tpu import evaluation as jev
from sketchyscenecolorization_tpu.config import FGGanConfig, MatchingConfig
from sketchyscenecolorization_tpu.data import matching_dataset as j_md
from sketchyscenecolorization_tpu.models import rmi as j_rmi
from sketchyscenecolorization_tpu.pipeline.engines import \
    MatchingEngine as JMatchingEngine
from sketchyscenecolorization_tpu.train import eval_matching as j_eval_matching
from sketchyscenecolorization_tpu.train.fg_gan import create_fg_gan_state
from sketchyscenecolorization_torch import cli_matching
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch import evaluation as tev
from sketchyscenecolorization_torch.data import matching_dataset as t_md
from sketchyscenecolorization_torch.models.fg_gan import build_discriminator
from sketchyscenecolorization_torch.models.rmi import RMI
from sketchyscenecolorization_torch.pipeline.engines import MatchingEngine
from sketchyscenecolorization_torch.text import load_vocab
from sketchyscenecolorization_torch.train import eval_matching
from sketchyscenecolorization_torch.utils.bridge import load_jax_tree
from sketchyscenecolorization_torch.utils.checkpoint import save_checkpoint
from test_torch_train_fg_gan import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, "data", "match_vocab.txt")
SIZE, SCALE = 48, 0.016
PROBS_ATOL = 1e-6
# (46-category id, caption noun, box as fractions (y1, x1, y2, x2))
INSTANCES = [(7, "bus", (0.10, 0.08, 0.45, 0.55)),
             (12, "car", (0.15, 0.62, 0.40, 0.92)),
             (3, "house", (0.52, 0.55, 0.75, 0.85)),
             (27, "grass", (0.80, 0.05, 0.92, 0.50))]
# the MatchingConfig that ``cli_matching --image_size 48 --model_scale
# 0.016`` builds
CLI_KW = dict(H=SIZE, W=SIZE, vf_h=SIZE // 8, vf_w=SIZE // 8,
              w_emb_dim=int(1000 * SCALE), v_emb_dim=int(1000 * SCALE),
              m_rnn_size=int(500 * SCALE), w_rnn_size=int(1000 * SCALE))


def write_val_split(base, size=SIZE, image_ids=(1, 2), split="val"):
    """A split in the layouts ``load_data_gt`` and ``load_seg_data`` read:
    ``<base>/<split>/DRAWING_GT`` (the instances' box outlines),
    ``INSTANCE_GT``/``CLASS_GT`` .mat (sparse instance ids),
    ``seg_data/<id>_datas.npz`` (each instance's box as a predicted
    instance, plus a decoy box over two of them) and
    ``<base>/sentence_instance_<split>.json`` with five captions an
    image.  Returns the GT instance masks {image id: [H, W, n]}."""
    root = os.path.join(base, split)
    for sub in ("DRAWING_GT", "INSTANCE_GT", "CLASS_GT", "seg_data"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    captions, gt = [], {}
    for image_id in image_ids:
        shift = int(0.04 * size) * (image_id - 1)
        sketch = np.full((size, size, 3), 255, np.uint8)
        inst = np.zeros((size, size), np.uint8)
        cls = np.zeros((size, size), np.uint8)
        boxes, masks = [], []
        for i, (cat, _, frac) in enumerate(INSTANCES):
            y1, x1, y2, x2 = (int(f * size) for f in frac)
            x1, x2 = x1 + shift, x2 + shift
            box = sketch[y1:y2 + 1, x1:x2 + 1]
            box[0], box[-1], box[:, 0], box[:, -1] = 0, 0, 0, 0
            inst[y1:y2 + 1, x1:x2 + 1] = 2 * i + 3
            cls[y1:y2 + 1, x1:x2 + 1] = cat
            boxes.append([y1, x1, y2, x2])
            masks.append(np.ones((y2 - y1 + 1, x2 - x1 + 1), np.uint8))
        y1, x1 = boxes[0][0], boxes[0][1]          # the decoy: bus and car
        y2, x2 = boxes[1][2], boxes[1][3]
        boxes.append([y1, x1, y2, x2])
        masks.append(np.ones((y2 - y1 + 1, x2 - x1 + 1), np.uint8))
        pred_masks = np.empty(len(masks), dtype=object)
        pred_masks[:] = masks
        np.savez(os.path.join(root, "seg_data", f"{image_id}_datas.npz"),
                 pred_masks=pred_masks,
                 pred_class_ids=np.array([c for c, _, _ in INSTANCES]
                                         + [7]),
                 pred_boxes=np.array(boxes, np.int32))
        Image.fromarray(sketch).save(os.path.join(
            root, "DRAWING_GT", f"L0_sample{image_id}.png"))
        scipy.io.savemat(os.path.join(
            root, "INSTANCE_GT", f"sample_{image_id}_instance.mat"),
            {"INSTANCE_GT": inst})
        scipy.io.savemat(os.path.join(
            root, "CLASS_GT", f"sample_{image_id}_class.mat"),
            {"CLASS_GT": cls})
        caps = {f"the {name}": [i] for i, (_, name, _) in enumerate(INSTANCES)}
        caps["the bus and the car"] = [0, 1]
        captions.append({"key": image_id, "sen_instIdx_map": caps})
        gt[image_id] = np.stack([inst == 2 * i + 3
                                 for i in range(len(INSTANCES))], 2)
    with open(os.path.join(base, f"sentence_instance_{split}.json"),
              "w") as f:
        json.dump(captions, f)
    return gt


# ------------------------------------------------ mirrors of test_evaluation

def test_bbox_iou():
    a = [0, 0, 9, 9]
    b = [5, 5, 14, 14]
    np.testing.assert_allclose(tev.compute_bbox_iou(a, b), [25 / 175])
    np.testing.assert_allclose(tev.compute_bbox_iou(a, a), [1.0])


def test_mask_iu():
    m = np.zeros((8, 8), bool)
    t = np.zeros((8, 8), bool)
    m[:4] = True
    t[2:6] = True
    i, u = tev.compute_mask_IU(m, t)
    assert i == 16 and u == 48


def test_overlaps_masks():
    m1 = np.zeros((4, 4, 2))
    m2 = np.zeros((4, 4, 1))
    m1[:2, :, 0] = 1
    m1[2:, :, 1] = 1
    m2[1:3, :, 0] = 1
    np.testing.assert_allclose(tev.compute_overlaps_masks(m1, m2),
                               [[4 / 12], [4 / 12]])


def test_compute_ap_perfect_and_miss():
    gt = np.zeros((8, 8, 1))
    gt[2:6, 2:6, 0] = 1
    ap, _, _, _ = tev.compute_ap(gt, np.array([0.9]), gt.copy(),
                                 iou_threshold=0.5)
    assert ap == 1.0
    miss = np.zeros((8, 8, 1))
    miss[0:1, 0:1, 0] = 1
    ap, _, _, _ = tev.compute_ap(gt, np.array([0.9]), miss,
                                 iou_threshold=0.5)
    assert ap == 0.0


def test_compute_ap_greedy_matching_order():
    gt = np.zeros((8, 8, 1))
    gt[2:6, 2:6, 0] = 1
    preds = np.stack([gt[..., 0], gt[..., 0]], axis=2)
    ap, _, recalls, _ = tev.compute_ap(gt, np.array([0.9, 0.8]), preds)
    assert ap == 1.0
    assert recalls[-2] == 1.0


def test_evaluator_accumulates():
    ev = tev.MatchingEvaluator(compute_mask_ap=False)
    m = np.zeros((8, 8))
    t = np.zeros((8, 8))
    m[:4] = 1
    t[:4] = 1
    assert ev.add(m, t) == 1.0
    m2 = np.zeros((8, 8))
    m2[:1] = 1
    t2 = np.zeros((8, 8))
    t2[:4] = 1
    ev.add(m2, t2)
    res = ev.result()
    assert res.num_samples == 2
    assert res.precision_at[0.5] == 0.5
    np.testing.assert_allclose(res.cum_iou, (32 + 8) / (32 + 32))
    assert "overall IoU" in res.summary()


def test_inception_score_bounds():
    mean, _ = tev.inception_score(np.full((100, 10), 0.1), splits=5)
    np.testing.assert_allclose(mean, 1.0, rtol=1e-6)
    mean, _ = tev.inception_score(np.eye(10)[np.arange(100) % 10], splits=5)
    np.testing.assert_allclose(mean, 10.0, rtol=1e-5)
    mean, _ = tev.inception_score(np.tile(np.eye(10)[0], (100, 1)),
                                  splits=5)
    np.testing.assert_allclose(mean, 1.0, rtol=1e-6)


FG_KW = dict(batch_size=1, image_size=64, vocab_size=10, max_len=4,
             base_channels=4, noise_dim=8)


def test_acgan_class_probs_shapes():
    disc = build_discriminator(tconfig.FGGanConfig(**FG_KW),
                               torch.Generator().manual_seed(0))
    imgs = np.random.RandomState(0).uniform(-1, 1, (5, 64, 64, 3)) \
        .astype(np.float32)
    probs = tev.acgan_class_probs(disc, imgs, batch_size=3)
    assert probs.shape == (5, 25)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)


def test_inception_v4_class_probs_and_score():
    from sketchyscenecolorization_torch.models.inception_v4 import \
        InceptionV4
    model = InceptionV4(num_classes=9, create_aux_logits=False,
                        generator=torch.Generator().manual_seed(0))
    imgs = np.random.RandomState(0).uniform(-1, 1, (3, 64, 64, 3))
    probs = tev.inception_v4_class_probs(model, imgs, batch_size=2)
    assert probs.shape == (3, 9)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)
    mean, _ = tev.inception_score(probs, splits=1)
    assert 1.0 <= mean <= 9.0 + 1e-6


# ------------------------------------------------ against the JAX package

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.RandomState(seed)
    boxes = np.sort(rng.randint(0, 40, (6, 2, 2)), axis=1).reshape(6, 4)
    for b in boxes:
        assert np.array_equal(tev.compute_bbox_iou(boxes, b),
                              jev.compute_bbox_iou(boxes, b))
    gt = rng.rand(16, 16, 3) > 0.6
    pred = (rng.rand(16, 16, 5) > 0.5).astype(np.uint8)
    pred[..., 0] = gt[..., 1]                      # one exact match
    scores = rng.rand(5)
    assert tev.compute_mask_IU(pred[..., 0], gt[..., 0]) == \
        jev.compute_mask_IU(pred[..., 0], gt[..., 0])
    assert np.array_equal(tev.compute_overlaps_masks(pred, gt),
                          jev.compute_overlaps_masks(pred, gt))
    for thr in tev.MAP_IOU_THRESHOLDS:
        got, want = (mod.compute_ap(gt, scores, pred, iou_threshold=thr)
                     for mod in (tev, jev))
        for g, w in zip(got, want):
            assert np.array_equal(g, w), thr
    assert np.array_equal(tev.MAP_IOU_THRESHOLDS, jev.MAP_IOU_THRESHOLDS)


def test_inception_score_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(37, 11) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for splits in (1, 4, 10):
        assert tev.inception_score(probs, splits) == \
            jev.inception_score(probs, splits)


def test_evaluator_with_mask_ap_matches_jax(tmp_path):
    """Seeded predictions that cover most of some GT boxes, scored with the
    instance mAP over the split's ``seg_data``: every result equal."""
    gt = write_val_split(str(tmp_path))
    seg_dir = tmp_path / "val" / "seg_data"
    rng = np.random.RandomState(5)
    port, ref = tev.MatchingEvaluator(), jev.MatchingEvaluator()
    for image_id, masks in gt.items():
        for k in range(6):
            chosen = rng.rand(masks.shape[2]) < 0.5
            pred = (masks[..., chosen].any(-1) & (rng.rand(SIZE, SIZE) < 0.8)
                    | (rng.rand(SIZE, SIZE) < 0.05)).astype(np.float32)
            target_ids = [k % masks.shape[2]]
            target = masks[..., target_ids].any(-1).astype(np.int32)
            cap_gt = masks[..., target_ids].astype(np.int32)
            npz = str(seg_dir / f"{image_id}_datas.npz")
            assert port.add(pred, target, cap_gt, npz) == \
                ref.add(pred, target, cap_gt, npz)
    got, want = port.result(), ref.result()
    assert got.summary() == want.summary()
    assert np.array_equal(got.map_list, want.map_list)
    assert got.mean_ap == want.mean_ap and 0 < got.mean_ap < 1


def test_acgan_class_probs_match_jax():
    cfg = FGGanConfig(**FG_KW)
    state = create_fg_gan_state(jax.random.PRNGKey(0), cfg)
    disc = load_jax_tree(build_discriminator(tconfig.FGGanConfig(**FG_KW)),
                         jax.tree.map(np.asarray, state.d_params),
                         sn=jax.tree.map(np.asarray, state.d_sn))
    u_before = [b.clone() for b in disc.buffers()]
    imgs = np.random.RandomState(0).uniform(-1, 1, (5, 64, 64, 3)) \
        .astype(np.float32)
    want = jev.acgan_class_probs(cfg, state.d_params, state.d_sn, imgs,
                                 batch_size=3)
    got = tev.acgan_class_probs(disc, imgs, batch_size=3)
    assert got.shape == want.shape == (5, 25)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_ATOL)
    assert all(torch.equal(a, b) for a, b in zip(u_before, disc.buffers()))


# ------------------------------------------------ eval_matching

@pytest.fixture
def small_images(monkeypatch):
    """Both packages' matching loaders at SIZE."""
    monkeypatch.setattr(j_md, "IMAGE_SIZE", SIZE)
    monkeypatch.setattr(t_md, "IMAGE_SIZE", SIZE)


def test_eval_matching_loop_with_stub_predictor(tmp_path, small_images):
    """Mirror of ``tests/test_procedures.py:69`` with the oracle predictor
    also scored with the instance mAP."""
    gt = write_val_split(str(tmp_path), image_ids=(1,))[1]
    base = str(tmp_path / "val")
    caps = str(tmp_path / "caps.json")
    with open(caps, "w") as f:
        json.dump([{"key": 1, "sen_instIdx_map": {"the bus": [0]}}], f)
    gt_mask = gt[..., 0].astype(np.float32)
    result = eval_matching(lambda im, cap: gt_mask.copy(), base, caps,
                           compute_mask_ap=False, augment=False,
                           result_path=str(tmp_path / "res.txt"))
    assert result.cum_iou == 1.0
    assert result.precision_at[0.9] == 1.0
    assert os.path.isfile(tmp_path / "res.txt")
    result = eval_matching(lambda im, cap: np.zeros_like(gt_mask), base,
                           caps, compute_mask_ap=False, augment=False)
    assert result.cum_iou == 0.0
    result = eval_matching(
        None, base, caps, compute_mask_ap=False, augment=False,
        predict_batch_fn=lambda im, captions: np.stack(
            [gt_mask.copy() for _ in captions]))
    assert result.cum_iou == 1.0
    result = eval_matching(lambda im, cap: gt_mask.copy(), base, caps,
                           seg_data_base_dir=base, augment=False)
    assert result.mean_ap == 1.0 and result.map_list.tolist() == [1.0] * 10


def _recorded(fn, record):
    def call(*args):
        out = fn(*args)
        record.append(np.array(out))
        return out
    return call


@pytest.fixture(scope="module")
def engines():
    """JAX's and the port's ``MatchingEngine`` on the same fresh weights,
    at the CLI's 48^2 scale-0.016 config."""
    cfg = MatchingConfig(**CLI_KW)
    params = jax.jit(lambda k: j_rmi.init_params(k, cfg))(
        jax.random.PRNGKey(0))
    vocab = load_vocab(VOCAB)
    model = load_jax_tree(RMI(tconfig.MatchingConfig(**CLI_KW)),
                          jax.tree.map(np.asarray, params))
    return (JMatchingEngine(cfg, params, vocab),
            MatchingEngine(tconfig.MatchingConfig(**CLI_KW), model, vocab,
                           device="cpu"))


@pytest.mark.parametrize("batched", [True, False])
def test_eval_matching_matches_jax(tmp_path, small_images, engines, batched):
    jeng, teng = engines
    write_val_split(str(tmp_path))
    base = str(tmp_path / "val")
    caps = str(tmp_path / "sentence_instance_val.json")
    results, masks = [], []
    for eng, fn in ((jeng, j_eval_matching), (teng, eval_matching)):
        record = []
        kw = dict(seg_data_base_dir=base, compute_mask_ap=True)
        if batched:
            kw["predict_batch_fn"] = _recorded(eng.predict_masks, record)
            single = None
        else:
            single = _recorded(eng.predict_mask, record)
        results.append(fn(single, base, caps, **kw))
        masks.append(np.concatenate([m.reshape(-1, SIZE, SIZE)
                                     for m in record]))
    (want, got), (want_masks, got_masks) = results, masks
    assert got_masks.shape == (10, SIZE, SIZE)
    np.testing.assert_array_equal(got_masks, want_masks)
    assert got.summary() == want.summary()
    assert got.num_samples == want.num_samples == 10
    assert np.array_equal(got.map_list, want.map_list)


def test_cli_matching_eval_writes_result(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(t_md, "IMAGE_SIZE", t_md.IMAGE_SIZE)  # restored
    write_val_split(str(tmp_path))
    run_dir = tmp_path / "run"
    cfg = tconfig.MatchingConfig(**CLI_KW)
    save_checkpoint(str(run_dir / "snapshots"), 3, {
        "model": RMI(cfg, torch.Generator().manual_seed(1)).state_dict(),
        "step": 3})
    argv = ["--mode", "eval", "--data_base_dir", str(tmp_path),
            "--captions_base_dir", str(tmp_path), "--seg_data_base_dir",
            str(tmp_path), "--vocab_path", VOCAB, "--run_dir", str(run_dir),
            "--image_size", str(SIZE), "--model_scale", str(SCALE),
            "--device", "cpu"]
    assert cli_matching.main(argv) == 0
    out = capsys.readouterr().out
    assert "restored step 3" in out and "mAP" in out
    path = run_dir / "eval_results" / "deeplab_val_result.txt"
    text = path.read_text()
    assert "overall IoU" in text and "mAP_list" in text
    assert cli_matching.main(argv + ["--no_mask_ap"]) == 0
    second = path.read_text()[len(text):]
    assert "overall IoU" in second and "mAP" not in second
