"""backbone_device_ms.train (layer: DeepLab-v2): CUDA events around the
frozen backbone's forward, mean per train step."""


def read(run):
    ms = run.module_ms.get("backbone")
    return sum(ms) / len(ms) if ms else None
