"""disc_device_ms (layer: FG discriminator): CUDA events around the
discriminator's forwards (two in the D update, two in the G update),
summed per train step."""


def read(run):
    ms = run.module_ms.get("discriminator")
    return sum(ms) / run.steps if ms and run.steps else None
