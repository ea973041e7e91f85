"""Port parity of matching training (``sketchyscenecolorization_torch/train``)
at the small config of ``tests/test_train.py``: JAX ``rmi.init_params``
weights go through the bridge, and one and then two steps of
``make_matching_train_step`` run on both sides on the same seeded batch.

Compared after each step, with the tolerances stated:
- ``cost``, ``cls_loss``, ``reg_loss``: relative 1e-5 (the loss is a SUM
  over 48x48 pixels; measured 1.5e-7);
- ``lr``: exact (both evaluate the schedule in float32);
- the gradient of every ``text_sketchyscene`` leaf: max-abs difference
  <= 1e-4 of the leaf's largest gradient magnitude (measured 3.2e-6);
- the updated leaves: absolute 1e-2 * lr, i.e. 2.5e-6.  Adam divides by
  sqrt(nu) + 1e-8, so where a gradient element is near 1e-8 a difference
  of 1e-9 in it moves the update by a sizeable part of lr (measured
  3.8e-7, in ``visual_feat_projection/DW`` after the second step; 1.5e-8
  after the first);
- ``ResNet``: bit-unchanged.
The same comparison runs for one step of the word-attention and RecurAttn
fusions, whose text leaves include ``attn_fc`` and ``h_proj``.  One leaf is
held differently: ``attn_fc/biases`` adds the same logit to every word
before a softmax, which cannot see it, so its gradient is zero up to
rounding on both sides (|grad| <= 1e-6; measured 6e-8 and 1.8e-7) and its
Adam update is driven by that rounding: it is held to |update| <= lr.  The
RecurAttn step has more gradient elements near Adam's eps than the default
fusion (15 of 1.2M below 5e-8 differ in their update by up to 1.1e-5, 4%
of lr); in the variant test an element whose JAX gradient is below
``NEAR_EPS`` = 1e-6 is held to Adam's first-step bound, |update
difference| <= 2 lr, and every other element to 1e-2 lr as above.

Also the harness (synthetic corpus, snapshots, resume; mirrors
``tests/test_data_and_harness.py:139-175``) and ``cli_matching --mode
train`` for 2 steps at 48x48 with ``--device cpu``."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchyscenecolorization_tpu.config import MatchingConfig
from sketchyscenecolorization_tpu.models import rmi as j_rmi
from sketchyscenecolorization_tpu.train import matching as j_matching
from sketchyscenecolorization_torch import cli_matching
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.data import MatchingTrainDataset
from sketchyscenecolorization_torch.data import matching_dataset as md
from sketchyscenecolorization_torch.models.rmi import RMI
from sketchyscenecolorization_torch.train import (create_matching_state,
                                                  make_matching_train_step,
                                                  train_matching)
from sketchyscenecolorization_torch.utils.bridge import (flatten_tree,
                                                         load_jax_tree)
from sketchyscenecolorization_torch.utils.checkpoint import latest_checkpoint
from test_data_and_harness import _write_matching_corpus

SMALL_KW = dict(vf_h=6, vf_w=6, H=48, W=48, vf_dim=2048, vocab_size=12,
                w_emb_dim=16, v_emb_dim=16, m_rnn_size=8, w_rnn_size=16,
                max_len=5, lr_decay_step=100)
SMALL = MatchingConfig(**SMALL_KW)
TSMALL = tconfig.MatchingConfig(**SMALL_KW)

# leaves whose true gradient is zero (a bias under a softmax)
SHIFT_INVARIANT = {"text_sketchyscene.attn_fc.biases"}
ZERO_GRAD_ATOL = 1e-6
NEAR_EPS = 1e-6           # 100x Adam's eps
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
UPDATE_ATOL = 1e-2 * SMALL.start_lr


@pytest.fixture(scope="module")
def jax_env():
    params = jax.jit(lambda k: j_rmi.init_params(k, SMALL))(
        jax.random.PRNGKey(0))
    step = j_matching.make_matching_train_step(SMALL, donate=False)
    return params, step, _jax_grad_fn(SMALL)


def _batch(cfg, seed=0):
    """``tests/test_train.py:_matching_batch`` as NumPy."""
    rng = np.random.RandomState(seed)
    img = rng.randn(1, cfg.H, cfg.W, 3).astype(np.float32) * 50
    words = rng.randint(1, cfg.vocab_size, (1, cfg.max_len)).astype(np.int32)
    seq_len = np.full((1,), 3, np.int32)
    target = (rng.rand(1, cfg.H, cfg.W, 1) > 0.5).astype(np.float32)
    return {"image": img, "words": words, "seq_len": seq_len,
            "target_mask": target}


def _jax_layout(tensor):
    """A port parameter or gradient in the JAX tree's layout."""
    arr = tensor.detach().numpy()
    return arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr


def _jax_grad_fn(cfg):
    def loss(trainable, frozen, batch):
        return j_matching.matching_loss_fn(trainable, frozen, cfg, batch)
    return jax.jit(jax.grad(loss, has_aux=True))


def _check_steps_match_jax(cfg, tcfg, params, jstep, jgrad, n_steps,
                           near_eps=0.0):
    """``n_steps`` train steps on both sides from the same weights and
    batch, compared after each step as the module docstring states; an
    update element whose JAX gradient is below ``near_eps`` is held to
    Adam's first-step bound.  Returns the port's model."""
    np_params = jax.tree.map(np.asarray, params)
    initial = flatten_tree(np_params)
    model = load_jax_tree(RMI(tcfg), np_params)
    resnet_before = {k: v.clone() for k, v in
                     model.ResNet.state_dict().items()}
    state = create_matching_state(model, tcfg)
    step = make_matching_train_step(tcfg)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jstate = j_matching.create_matching_state(params, cfg)

    for n_step in range(1, n_steps + 1):
        trainable = {"text_sketchyscene": jstate.params["text_sketchyscene"]}
        frozen = {"ResNet": jstate.params["ResNet"]}
        jgrads, _ = jgrad(trainable, frozen, jbatch)
        jgrads = flatten_tree(jax.tree.map(np.asarray, jgrads))
        jstate, jmetrics = jstep(jstate, jbatch)
        state, metrics = step(state, tbatch)
        assert state.step == n_step == int(jstate.step)

        for key in ("cost", "cls_loss", "reg_loss"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(jmetrics[key]), rtol=LOSS_RTOL,
                                       err_msg=key)
        assert np.float32(metrics["lr"]) == np.float32(jmetrics["lr"])

        grads = {n: _jax_layout(p.grad) for n, p in
                 model.named_parameters() if p.requires_grad}
        assert sorted(k.replace(".", "/") for k in grads) == sorted(jgrads)
        for name, got in grads.items():
            want = jgrads[name.replace(".", "/")]
            if name in SHIFT_INVARIANT:
                assert max(np.abs(got).max(), np.abs(want).max()) \
                    <= ZERO_GRAD_ATOL, name
                continue
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got - want).max()) <= GRAD_REL * scale, name

        jleaves = flatten_tree(jax.tree.map(np.asarray, jstate.params))
        for name, p in model.named_parameters():
            if name.startswith("ResNet."):
                continue
            key = name.replace(".", "/")
            got = _jax_layout(p)
            if name in SHIFT_INVARIANT:
                for moved in (got, jleaves[key]):
                    assert np.abs(moved - initial[key]).max() \
                        <= cfg.start_lr * (1 + 1e-6), name
                continue
            near = np.abs(jgrads[key]) < near_eps
            assert (np.abs(got - jleaves[key])[near]
                    <= 2 * cfg.start_lr * (1 + 1e-6)).all(), name
            np.testing.assert_allclose(got[~near], jleaves[key][~near],
                                       rtol=0, atol=UPDATE_ATOL, err_msg=name)
            assert not np.array_equal(got, initial[key]), name

    for key, value in model.ResNet.state_dict().items():
        assert torch.equal(value, resnet_before[key]), key
        assert not model.ResNet.get_parameter(key).requires_grad
    return model


def test_train_steps_match_jax(jax_env):
    params, jstep, jgrad = jax_env
    _check_steps_match_jax(SMALL, TSMALL, params, jstep, jgrad, 2)


@pytest.mark.parametrize("variant", [dict(use_attn=True),
                                     dict(fusion_type="RecurAttn")],
                         ids=["use_attn", "recur_attn"])
def test_variant_train_step_matches_jax(variant):
    """One train step of the word-attention and RecurAttn fusions against
    JAX ``make_matching_train_step``: cost, the gradient of every text leaf
    (``attn_fc`` and ``h_proj`` included) and the updated leaves, with the
    tolerances of the module docstring."""
    cfg = MatchingConfig(**SMALL_KW, **variant)
    tcfg = tconfig.MatchingConfig(**SMALL_KW, **variant)
    params = jax.jit(lambda k: j_rmi.init_params(k, cfg))(
        jax.random.PRNGKey(0))
    jstep = j_matching.make_matching_train_step(cfg, donate=False)
    model = _check_steps_match_jax(cfg, tcfg, params, jstep,
                                   _jax_grad_fn(cfg), 1, near_eps=NEAR_EPS)
    new = model.text_sketchyscene.attn_fc if cfg.use_attn \
        else model.text_sketchyscene.h_proj
    assert float(new.DW.grad.abs().sum()) > 0


def _small_dataset(tmp_path, monkeypatch, augment=True):
    monkeypatch.setattr(md, "IMAGE_SIZE", 48)
    base, cap_path = _write_matching_corpus(tmp_path)
    vocab = {"<pad>": 0, "<unk>": 1, "the": 2, "bus": 3, "cat": 4}
    return MatchingTrainDataset(base, cap_path, vocab, max_len=6,
                                augment=augment)


def test_train_matching_harness_with_resume(tmp_path, monkeypatch):
    cfg = tconfig.MatchingConfig(vf_h=6, vf_w=6, H=48, W=48, vocab_size=16,
                                 w_emb_dim=16, v_emb_dim=16, m_rnn_size=8,
                                 w_rnn_size=16, max_len=6,
                                 snapshot_interval=2)
    ds = _small_dataset(tmp_path, monkeypatch)
    assert len(ds) == 2
    run_dir = str(tmp_path / "run")
    state = train_matching(cfg, ds, RMI(cfg, torch.Generator().manual_seed(0)),
                           run_dir, log_every=2, max_iters=4, device="cpu")
    assert state.step == 4
    found = latest_checkpoint(os.path.join(run_dir, "snapshots"))
    assert found is not None and found[0] == 4
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [2, 4]
    assert all(np.isfinite(r["cls_loss"]) for r in rows)

    # resume: a fresh harness with other initial weights starts from the
    # step-4 snapshot and runs to 6
    trained = {k: v.clone() for k, v in state.model.state_dict().items()}
    fresh = RMI(cfg, torch.Generator().manual_seed(1))
    state2 = train_matching(cfg, _small_dataset(tmp_path, monkeypatch),
                            fresh, run_dir, log_every=2, max_iters=6,
                            device="cpu")
    assert state2.step == 6
    assert latest_checkpoint(os.path.join(run_dir, "snapshots"))[0] == 6
    for key, value in state2.model.ResNet.state_dict().items():
        assert torch.equal(value, trained["ResNet." + key]), key


def test_cli_matching_trains_two_steps(tmp_path, monkeypatch):
    monkeypatch.setattr(md, "IMAGE_SIZE", md.IMAGE_SIZE)   # restored after
    _write_matching_corpus(tmp_path)
    os.replace(tmp_path / "caps.json",
               tmp_path / "sentence_instance_train.json")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = ["--mode", "train", "--data_base_dir", str(tmp_path),
            "--captions_base_dir", str(tmp_path),
            "--vocab_path", os.path.join(root, "data", "match_vocab.txt"),
            "--image_size", "48", "--model_scale", "0.016",
            "--run_dir", str(tmp_path / "run"), "--device", "cpu"]
    assert cli_matching.main(args + ["--max_iteration", "2"]) == 0
    assert latest_checkpoint(str(tmp_path / "run" / "snapshots"))[0] == 2
    assert md.IMAGE_SIZE == 48
    # the run evaluates on a val split (here a copy of the train split)
    shutil.copytree(tmp_path / "train", tmp_path / "val")
    shutil.copy(tmp_path / "sentence_instance_train.json",
                tmp_path / "sentence_instance_val.json")
    assert cli_matching.main(["--mode", "eval", "--no_mask_ap"]
                             + args[2:]) == 0
    assert "overall IoU" in (tmp_path / "run" / "eval_results" /
                             "deeplab_val_result.txt").read_text()
    assert cli_matching.make_parser().parse_args([]).device == "cuda"
