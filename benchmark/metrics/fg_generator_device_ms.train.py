"""fg_generator_device_ms.train (layer: FG engine and generator): CUDA
events around the FG generator's forwards in training (the D update's
fakes and the G update's), summed per train step."""


def read(run):
    ms = run.module_ms.get("generator")
    return sum(ms) / run.steps if ms and run.steps else None
