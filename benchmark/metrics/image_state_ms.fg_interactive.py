"""image_state_ms.fg_interactive: ``image_state_ms``, read by its own reader
(``metrics/image_state_ms.py``), in ``fg_interactive``, where it moves
``command_p95_ms``: that cell's rate spreads past the widest bound
allowed and is no end-to-end metric there (PERF.md, section 2)."""
from benchmark.harness import metric_reader

read = metric_reader("image_state_ms")
