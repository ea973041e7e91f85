"""The control on the card: the plain reference with TF32 on, in the
program's place, at each cell's full size, on three seeds: every seed
fails at least one of the cell's compared numbers.  Card only (the cells'
sizes and TF32 exist only there):

    python3 -m pytest benchmark/tests/test_bench_control.py
"""
import pytest

from benchmark import control, harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_the_control_is_not_correct(cuda_device, cell):
    limits = harness.load_json("limits", f"{cell}.json")
    for seed in (41, 42, 43):
        values = control.control(cell, seed, cuda_device)
        assert any(values[k] > limits[k] for k in values), values
