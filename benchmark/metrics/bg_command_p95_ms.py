"""bg_command_p95_ms: ``command_p95_ms`` of the BG cell, a metric of its
own because BG runs spread far wider than FG runs (PERF.md §6, PR 18),
so the two take different bounds."""


def read(run):
    return run.p95_ms()
