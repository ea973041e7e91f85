"""idle_named_share.train (layer: device): share of the traced window's
device idle time during which the host was inside one of the train
step's spans other than its root (``step``), in %: how much of the idle
time the step's own stages name."""
from benchmark.spans import idle_named_share


def read(run):
    return idle_named_share(run)
