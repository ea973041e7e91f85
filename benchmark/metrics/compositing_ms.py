"""compositing_ms (layer: device compositing): the session's stage trace,
``comp_dispatch`` + ``patch_wait`` + ``reconstruct`` per instruction (the
queued path records them; a single ``colorize`` records none)."""


def read(run):
    return run.stage_ms_per_command(["comp_dispatch", "patch_wait",
                                     "reconstruct"])
