"""png_banded_share (layer: session and IO): the program's PNG writes
deflated in row bands on its thread pool, in %: the ``png_banded``
counters of its spans over their ``png_writes`` counters (one a write,
counted on the span that waits for it or on a write-behind job's
``png_encode``).  None where the program counts no PNG write."""
from benchmark.spans import program_spans


def read(run):
    spans = program_spans(run)
    writes = sum(s.counts.get("png_writes", 0) for s in spans)
    if not writes:
        return None
    return 100.0 * sum(s.counts.get("png_banded", 0) for s in spans) / writes
