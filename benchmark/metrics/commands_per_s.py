"""commands_per_s: every command completed in the window (colour,
withdraw, a queue counting each of its instructions) over the whole
window, host clock.  None in a cell that issues no commands."""


def read(run):
    if not run.kinds or run.window_s <= 0:
        return None
    return run.instructions() / run.window_s
