"""g_update_ms (layer: FG GAN train step): host time of the program's
``g_update`` span (the generator forward, both discriminator passes, the
loss, its gradient through both, Adam), mean per train step (``step``
root)."""
from benchmark.spans import program_spans


def read(run):
    spans = program_spans(run)
    steps = sum(1 for s in spans if s[0] == "step")
    total = sum(t1 - t0 for label, t0, t1 in spans if label == "g_update")
    return total * 1e3 / steps if steps and total > 0 else None
