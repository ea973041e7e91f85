"""The port's process mesh (``sketchyscenecolorization_torch/parallel/``)
on four CPU ranks over gloo, against single-process evaluations on the
global batch (``tests/torch_parallel_ranks.py:mesh_and_ops``).

- The helpers, as ``tests/test_train.py:259`` holds JAX's: mesh sizes and
  coordinates at data=4 and on the 2x2 mesh, the refusals, this rank's
  rows, ``replicate`` (every rank holds rank 0's bits),
  ``reduce_gradients`` (sums over 'data', the first 'model' rank's
  broadcast over 'model') and ``reduce_metrics`` (sums over 'data').
- Batch-stats BN under a data-parallel mesh (8 rows, 2 a rank): the
  outputs and the gradients of x against one process normalizing the
  global batch, and the summed gradients of offset and scale; tolerance
  1e-5 relative to each tensor's largest magnitude (measured 2.3e-7).  Per-sample statistics are unchanged under a mesh (equal).
- Every loss of ``train/losses.py`` (one row a rank; the BG labels leave
  a different number of non-FG pixels on each rank, one rank none): the
  ranks' shares add up to the global batch's loss, and their gradients
  are the global loss's, rtol 1e-5 (measured 1.5e-7).
- ``mesh_batches``: every rank gets the first rank's batches, its own
  rows of each, and the first rank's failure.
The ranks rendezvous through a ``file://`` path in ``tmp_path`` and run
one torch thread each."""
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from torch_parallel_launch import run_ranks
from sketchyscenecolorization_torch.ops.norm import batch_stats_norm

WORLD = 4
REL = 1e-5


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    run_ranks(ranks.mesh_and_ops, WORLD, f"file://{out}/rendezvous",
              args=(str(out),), threads=1)
    return [ranks.load(str(out), "mesh", r) for r in range(WORLD)]


def _rel(got, want):
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def test_mesh_helpers(results):
    for rank, res in enumerate(results):
        # (data size, model size, data index, model index, local batch of 8)
        assert res["sizes"] == [(4, 1, rank, 0, 2),
                                (2, 2, rank // 2, rank % 2, 4)]
        errors = res["errors"]
        assert "needs 8 ranks, have 4" in errors["too_many"]
        assert "not divisible by model=3" in errors["indivisible"]
        assert "leaves ranks out" in errors["subset"]
        assert "not divisible by data axis 4" in errors["batch"]
        np.testing.assert_array_equal(
            res["rows"], np.arange(24).reshape(8, 3)[4 * (rank // 2):
                                                     4 * (rank // 2) + 4])
        first = results[0]["replicated"]
        for key, value in res["replicated"].items():
            assert torch.equal(value, first[key]), key
        assert int(res["replicated"]["count"]) == 0
        # reduce_gradients on the 2x2 mesh sums over 'data' (ranks m and
        # 2 + m hold rank + 1), then every 'model' rank takes the first
        # one's sum: that of ranks 0 and 2
        factor = 1 + 3
        assert torch.equal(res["reduced"]["a"], torch.full((2, 3),
                                                           float(factor)))
        assert torch.equal(res["reduced"]["b"], torch.arange(4.0) * factor)
        assert float(res["metrics"]["loss"]) == 10.0
        assert res["metrics"]["lr"] == 0.5


def test_batch_norm_takes_global_moments(results):
    want = ranks.bn_run(ranks.bn_inputs())
    worst = 0.0
    for name in ("plain", "cond"):
        for key in ("y", "x"):
            got = torch.cat([r["bn"][name][key] for r in results])
            worst = max(worst, _rel(got, want[name][key]))
            assert _rel(got, want[name][key]) <= REL, (name, key)
        for key in ("offset", "scale"):
            got = sum(r["bn"][name][key] for r in results)
            worst = max(worst, _rel(got, want[name][key]))
            assert _rel(got, want[name][key]) <= REL, (name, key)
    print(f"global-batch BN: worst relative error {worst:.2e}")
    x = ranks.tensors(ranks.bn_inputs())["x"]
    single = batch_stats_norm(x, torch.zeros(3), torch.ones(3),
                              per_sample=True)
    for res in results:
        assert torch.equal(res["per_sample"], single)


def test_loss_shares_add_up_to_global_losses(results):
    want, want_grads = ranks.loss_shares(ranks.loss_inputs())
    worst = 0.0
    for key, value in want.items():
        got = sum(r["losses"][0][key] for r in results)
        err = abs(float(got) - float(value)) / max(abs(float(value)), 1e-30)
        worst = max(worst, err)
        assert err <= REL, (key, float(got), float(value))
    for key, value in want_grads.items():
        got = torch.cat([r["losses"][1][key] for r in results])
        worst = max(worst, _rel(got, value))
        assert _rel(got, value) <= REL, key
    # the region L1's ranks hold 0 to 36 non-FG pixels: its shares differ
    shares = [float(r["losses"][0]["masked_l1"]) for r in results]
    assert shares[1] == 0.0 and len(set(shares)) == WORLD
    print(f"loss shares: worst relative error {worst:.2e}")


def test_mesh_batches_come_from_the_first_rank(results):
    for rank, res in enumerate(results):
        assert len(res["batches"]) >= 1
        for step, rows in enumerate(res["batches"]):
            # the first rank made [4, 2] filled with 10 * step + 0; each
            # rank holds its one row
            assert torch.equal(rows, torch.full((1, 2), 10.0 * step))
        assert res["batch_error"] == "batch 3 failed on rank 0"
