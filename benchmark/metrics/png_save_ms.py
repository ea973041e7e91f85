"""png_save_ms (layer: session and IO): the session's stage trace, the
save and record stages (``save+records``, ``bg_save``, ``png_*``) per
command."""


def read(run):
    return run.stage_ms_per_command(["save+records", "bg_save", "png_*"])
