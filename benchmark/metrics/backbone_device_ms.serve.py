"""backbone_device_ms.serve (layer: DeepLab-v2): CUDA events around the
backbone's forward, mean per call (once per new image)."""


def read(run):
    ms = run.module_ms.get("backbone")
    return sum(ms) / len(ms) if ms else None
