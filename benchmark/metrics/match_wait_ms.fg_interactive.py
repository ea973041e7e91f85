"""match_wait_ms.fg_interactive: ``match_wait_ms``, read by its own reader
(``metrics/match_wait_ms.py``), in ``fg_interactive``, where it moves
``command_p95_ms``: that cell's rate spreads past the widest bound
allowed and is no end-to-end metric there (PERF.md, section 2)."""
from benchmark.harness import metric_reader

read = metric_reader("match_wait_ms")
