"""``png_banded_share`` on synthetic runs: None where the program counts
no PNG write (a parent commit's plain ``(label, t0, t1)`` tuples
included), else the banded writes over all writes, each counted once
whichever span carries it."""
import pytest

from benchmark import harness
from benchmark.record import Run
from benchmark.tests.test_bench_spans import fg_run
from sketchyscenecolorization_torch.utils.tracing import Span


def read(run):
    return harness.metric_reader("png_banded_share")(run)


def test_banded_share_counts_each_png_write_once():
    run = fg_run()
    assert read(run) is None                    # spans, but no write counted
    run.stages += [
        Span("save+records", 1.9, 2.0, 12, 1, 1,
             {"png_writes": 1, "png_banded": 1}),
        Span("png_encode", 4.0, 4.2, 13, 2, 8,
             {"png_writes": 1, "png_banded": 0})]
    assert read(run) == pytest.approx(50.0)


def test_banded_share_reads_nothing_from_plain_tuples():
    run = Run(stages=[("save+records", 0.0, 1.0), ("bg_save", 1.0, 2.0)],
              kernels=[("k", 0.0, 1.0)], window=(0.0, 4.0), walls_s=[3.0],
              kinds=["bg"], counts=[1])
    assert read(run) is None
