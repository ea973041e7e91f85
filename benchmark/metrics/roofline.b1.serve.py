"""roofline.b1.serve (layer: kernel B1): the 3xTF32 bound of every B1
call in the traced window (``benchmark/work.py:fwd_bound_s``, from the
cell's shapes and each text's valid length) over B1's device time by
kernel name, its table and layout launches included, in %."""
from benchmark.trace import attributed_seconds

OWN = ("mlstm_stage_kernel<1>",)
SHARED = ("lstm_slots_kernel", "lstm_layout_kernel")
OTHERS = ("mlstm_stage_kernel<0>", "mlstm_stage_kernel<2>", "recur_")


def read(run):
    bound = run.work.get("b1_bound_s")
    t = attributed_seconds(run.kernels, OWN, SHARED, OTHERS, *run.window)
    return 100.0 * bound / t if bound and t > 0 else None
