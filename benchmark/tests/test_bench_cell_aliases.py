"""A per-layer metric named ``<metric>.<cell>`` is another metric's
quantity in one cell, under a name of its own because there it moves
another end-to-end metric: it lists that cell alone, reads exactly what
its metric reads (None included), and moves an end-to-end metric the
cell reports."""
import pytest

from benchmark import harness
from benchmark.record import Run
from benchmark.tests.test_bench_spans import fg_run
from sketchyscenecolorization_torch.utils.tracing import Span

MAN = harness.manifest()
CELLS = {w["name"] for w in MAN["workloads"]}
METRICS = {m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]}
ALIASES = [(m["name"], base, cell) for m in MAN["per_layer"]
           for base, _, cell in [m["name"].rpartition(".")]
           if cell in CELLS and base in METRICS]


def traced_fg_run():
    """The spans' synthetic FG run with the fields the rate, the idle
    share, the FLOP share, the generator's events and the PNG share
    read."""
    run = fg_run()
    run.stages.append(Span("save+records", 1.9, 2.0, 12, 1, 1,
                           {"png_writes": 1, "png_banded": 1}))
    run.module_ms = {"fg_generator": [12.0, 30.0]}
    run.window_s = run.traced_window_s = 10.0
    run.busy_s = 7.2
    run.work = {"flops": 3.0e12}
    return run


def test_the_rate_of_fg_interactive_is_a_per_layer_metric_there():
    assert ("commands_per_s.fg_interactive", "commands_per_s",
            "fg_interactive") in ALIASES


@pytest.mark.parametrize("name,base,cell", ALIASES)
def test_an_alias_reads_what_its_metric_reads(name, base, cell):
    entry = {m["name"]: m for m in MAN["per_layer"]}[name]
    assert entry["workloads"] == [cell]
    w = {x["name"]: x for x in MAN["workloads"]}[cell]
    reported = {m["name"] for m in harness.cell_metrics(w, MAN, trace=False)}
    assert entry["moves"] in reported
    base_entry = {m["name"]: m for m in MAN["end_to_end"]
                  + MAN["per_layer"]}[base]
    assert cell not in base_entry.get("workloads", CELLS)   # read once
    alias, reader = harness.metric_reader(name), harness.metric_reader(base)
    assert alias(traced_fg_run()) is not None
    for run in (traced_fg_run(), Run()):
        assert alias(run) == reader(run)
