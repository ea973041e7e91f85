"""Data and pixel parallelism of matching training in the port, on CPU
ranks over gloo (``tests/torch_parallel_ranks.py``), against the JAX
package's unsharded model and step on the same weights (the port's seeded
models, bridged) and the same global batch of 4, as JAX's own tests tie
its sharded steps to the unsharded ones (``tests/test_train.py:153,
312-412``).

- Data-parallel step at data=4 (four ranks, one row each): ``cls_loss``
  of two steps against JAX's, rtol 2e-4 (2e-4 and 5e-4 at the second step,
  which depends on the first step's update); every text leaf after each
  step within rtol 1e-4, atol 1e-6 (``tests/test_train.py:366-369``);
  every rank's leaves bit-equal.
- Pixel-sharded forward (``shard_mlstm_pixels``) of all three fusions at
  model=2 (two ranks, the whole batch) and on the 2x2 mesh (four ranks,
  two rows per 'data' rank, 36 pixels split 18/18): ``up`` against JAX
  ``rmi.apply`` unsharded, rtol/atol 1e-5; the 'model' ranks bit-equal.
- Pixel-sharded training on the 2x2 mesh: two steps of the default fusion
  (losses and the text leaves as above, ``mLSTM.w`` included: it holds
  W_h, whose cotangent the sharded backward sums over 'model') and one of
  each variant fusion (loss, rtol 2e-4).
- Without a mesh ``shard_mlstm_pixels`` raises.
Each test prints the largest differences it measured (on this CPU: DP
losses 1.5e-7 relative, leaves 2.6e-7; ``up`` 5.8e-7 default, 2.5e-7
word attention, 4.9e-8 RecurAttn; TP losses 7.6e-8, leaves 3.7e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from torch_parallel_launch import join_ranks, start_ranks
from sketchyscenecolorization_tpu.config import MatchingConfig
from sketchyscenecolorization_tpu.models import rmi as j_rmi
from sketchyscenecolorization_tpu.train import matching as j_matching
from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                         flatten_tree)

LOSS_RTOL, LOSS_RTOL_2 = 2e-4, 5e-4
LEAF_RTOL, LEAF_ATOL = 1e-4, 1e-6
UP_TOL = 1e-5


def _jax_side(fusion):
    """JAX's unsharded ``up`` on the global batch and, for each step the
    ranks take, its metrics and text leaves (port names, port layout)."""
    cfg = MatchingConfig(**ranks.MATCH_KW, **ranks.FUSIONS[fusion])
    tcfg, model = ranks.rmi(fusion)
    params = jax.tree.map(jnp.asarray, export_jax_tree(model))
    batch = {k: jnp.asarray(v) for k, v in
             ranks.matching_batch(tcfg, 4).items()}
    up = jax.jit(lambda p: j_rmi.apply(p, cfg, batch["image"],
                                       batch["words"], batch["seq_len"]).up)(
        params)
    step = j_matching.make_matching_train_step(cfg, donate=False)
    state = j_matching.create_matching_state(params, cfg)
    steps = []
    for _ in range(2 if fusion == "default" else 1):
        state, metrics = step(state, batch)
        model.load_state_dict({
            k.replace("/", "."): torch.from_numpy(np.array(v)) if v.ndim != 4
            else torch.from_numpy(np.array(v).transpose(3, 2, 0, 1))
            for k, v in flatten_tree(jax.tree.map(
                np.asarray, state.params)).items()
            if k.startswith("text_sketchyscene/")}, strict=False)
        steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                      "text": ranks.text_leaves(model)})
    return np.asarray(up), steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("matching")
    contexts = [start_ranks(fn, world, f"file://{out}/rendezvous_{world}",
                            args=(str(out),), threads=1)
                for fn, world in ((ranks.matching_dp, 4),
                                  (ranks.matching_model2, 2))]
    jax_side = {fusion: _jax_side(fusion) for fusion in ranks.FUSIONS}
    for context in contexts:
        join_ranks(context)
    return (jax_side,
            [ranks.load(str(out), "matching", r) for r in range(4)],
            [ranks.load(str(out), "model2", r) for r in range(2)])


def _check_steps(got_steps, want_steps, label):
    """Losses and text leaves of each step; returns the largest relative
    loss difference and the largest leaf difference."""
    worst_loss = worst_leaf = 0.0
    for i, (got, want) in enumerate(zip(got_steps, want_steps)):
        rtol = LOSS_RTOL if i == 0 else LOSS_RTOL_2
        for key in ("cost", "cls_loss", "reg_loss"):
            g, w = float(got["metrics"][key]), want["metrics"][key]
            worst_loss = max(worst_loss, abs(g - w) / abs(w))
            np.testing.assert_allclose(g, w, rtol=rtol,
                                       err_msg=f"{label} step {i + 1} {key}")
        assert float(got["metrics"]["lr"]) == pytest.approx(
            want["metrics"]["lr"], rel=1e-6)
        for name, w in want["text"].items():
            g = got["text"][name]
            worst_leaf = max(worst_leaf, float((g - w).abs().max()))
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), rtol=LEAF_RTOL, atol=LEAF_ATOL,
                err_msg=f"{label} step {i + 1} {name}")
    return worst_loss, worst_leaf


def _bit_equal(steps_by_rank, label):
    for steps in steps_by_rank[1:]:
        for got, first in zip(steps, steps_by_rank[0]):
            for name, value in first["text"].items():
                assert torch.equal(got["text"][name], value), (label, name)


def test_data_parallel_steps_match_jax(runs):
    jax_side, dp, _ = runs
    loss, leaf = _check_steps(dp[0]["dp"], jax_side["default"][1], "dp")
    _bit_equal([r["dp"] for r in dp], "dp")
    moved = (dp[0]["dp"][0]["text"]["text_sketchyscene.mLSTM.w"]
             - ranks.text_leaves(ranks.rmi("default")[1])[
                 "text_sketchyscene.mLSTM.w"]).abs().max()
    assert float(moved) > 0.0
    print(f"DP data=4: loss rel {loss:.2e}, leaves max-abs {leaf:.2e}")


@pytest.mark.parametrize("fusion", sorted(ranks.FUSIONS))
def test_pixel_sharded_forward_matches_jax(runs, fusion):
    jax_side, dp, model2 = runs
    want = jax_side[fusion][0]
    got2 = model2[0][fusion]
    assert torch.equal(model2[1][fusion], got2)
    np.testing.assert_allclose(got2.numpy(), want, rtol=UP_TOL, atol=UP_TOL)
    # 2x2: 'data' rank d holds rows 2d, 2d + 1; its two 'model' ranks agree
    got4 = torch.cat([dp[0]["tp_up"][fusion], dp[2]["tp_up"][fusion]])
    for r in (1, 3):
        assert torch.equal(dp[r]["tp_up"][fusion], dp[r - 1]["tp_up"][fusion])
    np.testing.assert_allclose(got4.numpy(), want, rtol=UP_TOL, atol=UP_TOL)
    print(f"{fusion}: model=2 max-abs "
          f"{float(np.abs(got2.numpy() - want).max()):.2e}, 2x2 "
          f"{float(np.abs(got4.numpy() - want).max()):.2e}")


def test_pixel_sharded_training_matches_jax(runs):
    jax_side, dp, _ = runs
    loss, leaf = _check_steps(dp[0]["tp_default"], jax_side["default"][1],
                              "tp")
    _bit_equal([r["tp_default"] for r in dp], "tp")
    for fusion in ("attn", "recur"):
        got = float(dp[0][f"tp_{fusion}"][0]["metrics"]["cls_loss"])
        want = jax_side[fusion][1][0]["metrics"]["cls_loss"]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=fusion)
        loss = max(loss, abs(got - want) / abs(want))
        _bit_equal([r[f"tp_{fusion}"] for r in dp], fusion)
    print(f"TP 2x2: loss rel {loss:.2e}, default leaves max-abs {leaf:.2e}")


def test_pixel_sharding_needs_a_mesh(runs):
    assert "needs a mesh" in runs[2][0]["no_mesh"]
