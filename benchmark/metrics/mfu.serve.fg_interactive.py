"""mfu.serve.fg_interactive: ``mfu.serve``, read by its own reader
(``metrics/mfu.serve.py``), in ``fg_interactive``, where it moves
``command_p95_ms``: that cell's rate spreads past the widest bound
allowed and is no end-to-end metric there (PERF.md, section 2)."""
from benchmark.harness import metric_reader

read = metric_reader("mfu.serve")
