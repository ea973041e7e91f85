"""bg_gradient_ms (layer: BG device gradient): the session's stage trace,
``bg_band_fetch`` + ``bg_ramp_host`` + ``bg_finish_dispatch`` per command
(the generator's enqueue, ``bg_dispatch``, stays out)."""


def read(run):
    return run.stage_ms_per_command(
        ["bg_band_fetch", "bg_ramp_host", "bg_finish_dispatch"])
