"""roofline.b2.train (layer: kernel B2): the 3xTF32 bound of every B2
call in the traced window (``benchmark/work.py:bwd_bound_s``, from the
cell's shapes and each caption's valid length) over B2's device time by
kernel name (staging forward, sweep, d_W_h product and sums, step sums),
its table and layout launches included, in %."""
from benchmark.trace import attributed_seconds

OWN = ("mlstm_stage_kernel<0>", "mlstm_bwd_", "lstm_rows_product",
       "lstm_weight_sum")
SHARED = ("lstm_slots_kernel", "lstm_layout_kernel")
OTHERS = ("mlstm_stage_kernel<1>", "mlstm_stage_kernel<2>", "recur_")


def read(run):
    bound = run.work.get("b2_bound_s")
    t = attributed_seconds(run.kernels, OWN, SHARED, OTHERS, *run.window)
    return 100.0 * bound / t if bound and t > 0 else None
