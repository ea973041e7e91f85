"""png_banded_share.fg_interactive: ``png_banded_share``, read by its own reader
(``metrics/png_banded_share.py``), in ``fg_interactive``, where it moves
``command_p95_ms``: that cell's rate spreads past the widest bound
allowed and is no end-to-end metric there (PERF.md, section 2)."""
from benchmark.harness import metric_reader

read = metric_reader("png_banded_share")
