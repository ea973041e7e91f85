"""idle_share.train (layer: device): share of the traced window in which
no kernel, copy or memset ran, from the profiler's timeline, in %."""


def read(run):
    if run.traced_window_s <= 0 or not run.kernels:
        return None
    return 100.0 * (1.0 - run.busy_s / run.traced_window_s)
