"""A configuration brings its own driver, control and reference model as
new files: ``control.control`` finds the control through the
configuration's driver, ``reference.build`` and ``reference.skeleton`` a
kind outside ``MODELS`` through ``reference/<kind>.py``, and
``work.count_flops`` counts its parts.  The modules here are registered by
the test alone; no file of the benchmark names them."""
import sys
import types

import pytest
import torch
from torch import nn

from benchmark import control, harness, reference, work
from benchmark.drivers import serve_session, train_matching
from benchmark.tests.tiny import (tiny_serve_config, tiny_traffic,
                                  tiny_train_config)


class _Dense(nn.Module):
    """A reference model of one dense layer, seeded through ``Init``."""

    def __init__(self, sizes, init):
        super().__init__()
        self.w = init.glorot((sizes["d_in"], sizes["d_out"]))
        self.b = init.const((sizes["d_out"],), 0.0)

    def forward(self, x):
        return x @ self.w + self.b


SIZES = {"d_in": 6, "d_out": 5}


def _own_control(cell, config, traffic, seed, device, precision):
    sizes = config["framework"]["own"]
    model, _ = reference.build("own_dense", sizes, seed, device)
    x = torch.ones(traffic["rows"], sizes["d_in"], device=device)
    skeleton = reference.skeleton("own_dense", sizes)
    flops = work.count_flops(lambda: skeleton(
        torch.empty(traffic["rows"], sizes["d_in"], device="meta")))
    return {"out_sum": float(model(x).sum()), "flops": flops,
            "seed": seed, "precision": precision}


def _register(monkeypatch, driver: str, config: dict, **functions):
    module = types.ModuleType(f"benchmark.drivers.{driver}")
    for name, fn in functions.items():
        setattr(module, name, fn)
    monkeypatch.setitem(sys.modules, module.__name__, module)
    cell = {"name": f"{driver}_cell", "config": driver, "traffic": "own",
            "chips": 1}
    files = {cell["name"]: (cell, config, {"kind": "own", "rows": 3})}
    monkeypatch.setattr(harness, "cell_files", lambda name: files[name])
    return cell["name"]


def _register_kind(monkeypatch, kind: str, stream: int):
    module = types.ModuleType(f"benchmark.reference.{kind}")
    module.MODEL, module.STREAM = _Dense, stream
    monkeypatch.setitem(sys.modules, module.__name__, module)


def test_a_configuration_of_its_own_runs_through_the_dispatch(monkeypatch):
    _register_kind(monkeypatch, "own_dense", 7)
    name = _register(monkeypatch, "own_driver",
                     {"driver": "own_driver", "framework": {"own": SIZES}},
                     run=lambda **kw: None, control=_own_control)
    got = control.control(name, 12345678901, "cpu", "float32")
    model, state = reference.build("own_dense", SIZES, 12345678901, "cpu")
    assert got == {"out_sum": float(model(torch.ones(3, 6)).sum()),
                   "flops": 2.0 * 3 * 6 * 5, "seed": 12345678901,
                   "precision": "float32"}
    assert float(state["w"].abs().max()) > 0
    skeleton = reference.skeleton("own_dense", SIZES)
    assert skeleton.w.device.type == "meta"
    assert tuple(skeleton.w.shape) == (6, 5)
    # its own stream: weights unlike those another stream draws
    _register_kind(monkeypatch, "own_dense_too", 8)
    _, other = reference.build("own_dense_too", SIZES, 12345678901, "cpu")
    assert not torch.equal(state["w"], other["w"])


def test_a_driver_without_control_is_named(monkeypatch):
    name = _register(monkeypatch, "bare_driver", {"driver": "bare_driver"},
                     run=lambda **kw: None)
    with pytest.raises(SystemExit, match=r"benchmark/drivers/bare_driver\.py"
                                         r" has no control"):
        control.control(name, 1, "cpu")


def test_the_kinds_seed_streams_are_distinct(monkeypatch):
    streams = {kind: s for kind, (_, s) in reference.MODELS.items()}
    # the streams every cell's weights are drawn from, as they were
    assert streams == {"matching": 0, "fg_gan": 1, "bg_gan": 2}
    _register_kind(monkeypatch, "own_taken", 1)
    with pytest.raises(ValueError, match="STREAM 1 is taken"):
        reference.build("own_taken", SIZES, 3, "cpu")


@pytest.mark.parametrize("cell,driver", [
    ("fg_interactive", serve_session), ("bg_interactive", serve_session),
    ("matching_train", train_matching)])
def test_the_dispatched_control_is_the_drivers_own(monkeypatch, cell, driver):
    if driver is train_matching:
        config = tiny_train_config()
        traffic = tiny_traffic(cell, pool_batches=8)
    else:
        config, traffic = tiny_serve_config(), tiny_traffic(cell)
    entry = {"name": cell, "config": config["name"], "traffic": cell,
             "chips": 1}
    monkeypatch.setattr(harness, "cell_files",
                        lambda name: (entry, config, traffic))
    seed = 2718281828459
    got = control.control(cell, seed, "cpu", "float32")
    want = driver.control(entry, config, traffic, seed, "cpu", "float32")
    assert got == want
    # at the configuration's own precision the reference in the program's
    # place is correct
    limits = harness.load_json("limits", f"{cell}.json")
    assert set(got) <= set(limits)
    assert all(got[k] <= limits[k] for k in got), got
