"""d_update_ms (layer: FG GAN train step): host time of the program's
``d_update`` spans (the no-grad fakes, both discriminator passes and the
loss, its gradient, Adam) over the D updates the ``step`` roots counted
(``d_updates``), per D update."""
from benchmark.spans import program_spans


def read(run):
    spans = program_spans(run)
    n = sum(s.counts.get("d_updates", 0) for s in spans if s[0] == "step")
    total = sum(t1 - t0 for label, t0, t1 in spans if label == "d_update")
    return total * 1e3 / n if n and total > 0 else None
