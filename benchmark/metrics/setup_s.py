"""setup_s: process start to the first timed command or step (imports,
kernel load, weights, scenes, warm-up).  Host clock."""


def read(run):
    return run.setup_s
