"""command_p95_ms (the FG cell): the 95th percentile of every command's
wall in the window (call to return, host clock); a failed command counts
as missing (infinitely late), so more than 5% failed reads nothing."""


def read(run):
    return run.p95_ms()
