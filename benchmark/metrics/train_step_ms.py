"""train_step_ms: the whole window over the train steps completed in it;
the window ends on a synchronize.  Host clock."""


def read(run):
    if not run.steps:
        return None
    return run.window_s / run.steps * 1e3
