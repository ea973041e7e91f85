"""fg_generator_device_ms (layer: FG engine and generator): CUDA events
around the FG generator's forwards, summed per FG instruction."""


def read(run):
    ms = run.module_ms.get("fg_generator")
    n = run.instructions({"fg", "stream"})
    return sum(ms) / n if ms and n else None
