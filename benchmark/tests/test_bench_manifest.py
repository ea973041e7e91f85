"""BENCHMARK.json against the contract's form: names and units of the
allowed characters, every name found by its files, every cell reporting
set-up, another end-to-end metric and a per-layer metric whose end-to-end
metric it also reports."""
import json
import os
import re

import pytest

from benchmark.harness import BENCH_DIR, ROOT, cell_metrics, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_shape_and_characters():
    man = manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert all(TEXT.match(w) for w in man["command"])
    for p in man["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
    names = [c["name"] for c in man["configs"]] + \
        [w["name"] for w in man["workloads"]] + \
        [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in man["configs"])) == len(man["configs"])
    assert len(set(w["name"] for w in man["workloads"])) == len(man["workloads"])
    metrics = man["end_to_end"] + man["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and TEXT.match(w["why"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}


def test_every_name_is_found_by_its_files():
    man = manifest()
    for c in man["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
        assert c["file"].startswith(man["paths"][0] + "/")
    for w in man["workloads"]:
        for sub, key in (("configs", "config"), ("traffic", "traffic")):
            assert os.path.isfile(os.path.join(BENCH_DIR, sub,
                                               f"{w[key]}.json"))
        assert os.path.isfile(os.path.join(BENCH_DIR, "limits",
                                           f"{w['name']}.json"))
    for m in man["end_to_end"] + man["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics",
                                           f"{m['name']}.py"))


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    man = manifest()
    w = {x["name"]: x for x in man["workloads"]}[cell]
    e2e = {m["name"] for m in cell_metrics(w, man, trace=False)}
    layer = cell_metrics(w, man, trace=True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer)
