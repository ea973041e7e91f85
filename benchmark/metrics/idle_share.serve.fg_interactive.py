"""idle_share.serve.fg_interactive: ``idle_share.serve``, read by its own reader
(``metrics/idle_share.serve.py``), in ``fg_interactive``, where it moves
``command_p95_ms``: that cell's rate spreads past the widest bound
allowed and is no end-to-end metric there (PERF.md, section 2)."""
from benchmark.harness import metric_reader

read = metric_reader("idle_share.serve")
