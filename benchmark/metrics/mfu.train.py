"""mfu.train (layer: whole step): the model FLOPs of the train steps
completed in the traced window, forward and backward (convolutions,
matrix products and the recurrences' needed products, counted on the
plain reference: ``benchmark/work.py``), over the window's wall times the f32-accurate
peak, 165 TFLOP/s, in %."""
from benchmark.work import F32_ACCURATE_PEAK


def read(run):
    flops = run.work.get("flops")
    if not flops or run.traced_window_s <= 0:
        return None
    return 100.0 * flops / (run.traced_window_s * F32_ACCURATE_PEAK)
