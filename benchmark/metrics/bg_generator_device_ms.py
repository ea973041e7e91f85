"""bg_generator_device_ms (layer: BG engine and generator): CUDA events
around the BG generator's forward, mean per call (one per BG command)."""


def read(run):
    ms = run.module_ms.get("bg_generator")
    return sum(ms) / len(ms) if ms else None
