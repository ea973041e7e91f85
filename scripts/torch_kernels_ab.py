"""Compare B1 and B3-B6 of two checkouts of the PyTorch port on one card.

    python scripts/torch_kernels_ab.py <checkout A> <checkout B>

Runs the checkouts in the order A, B, B, A, each in a process of its own
started from that checkout's root, so that each builds and loads its own
kernels (its `build/kernels`).  Each process uses that checkout's own
`chip_smoke.py`: `check_kernel` (B1 against its plain version at SHAPES),
`check_variant_kernels("attn")` (B3/B4 at ATTN_SHAPES) and
`check_variant_kernels("recur")` (B5/B6 at RECUR_SHAPES): errors, bitwise
repeatability, CUDA-event times.  Then it times one call each of B3 at the
RMI shape (ATTN_SHAPES[0]) and of B5 and B6 at the RecurAttn shape
(RECUR_SHAPES[0]) by kernel name under torch.profiler, whatever the
checkout's kernels are called.  Prints the card's name and power limit
first.  Needs one card; exits non-zero if a run fails.
"""
import os
import subprocess
import sys

CHILD = r"""
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from sketchyscenecolorization_torch.ops import mlstm, recur_attn

mlstm.build()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
cs.check_kernel(mlstm)
cs.check_variant_kernels("attn")
cs.check_variant_kernels("recur")
for label, kind in (("B3", "attn"), ("B5", "recur"), ("B6", "recur")):
    name, n, p, hid, t, rows = (cs.ATTN_SHAPES if kind == "attn"
                                else cs.RECUR_SHAPES)[0]
    args, dout = cs.variant_inputs(kind, n, p, hid, t, rows)
    call = {"B3": lambda: mlstm.mlstm_attn_cuda(*args),
            "B5": lambda: recur_attn.recur_attn_cuda(*args),
            "B6": lambda: recur_attn.recur_attn_bwd_cuda(*args, dout)}[label]
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            kernels.append((us / 1e3, ev.count, ev.key))
    print(f"{label} at {name} by kernel (torch.profiler, one call, device "
          f"{sum(ms for ms, _, _ in kernels):.3f} ms):")
    for ms, count, key in sorted(kernels, reverse=True):
        print(f"  {ms:.3f} ms / {count} launches  {key[:120]}")
    del args, dout
    torch.cuda.empty_cache()
"""


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (os.path.abspath(d) for d in sys.argv[1:])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in (a, b, b, a):
        print(f"== {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                              env={**os.environ, "PYTHONPATH": root})
        if proc.returncode:
            print(f"run in {root} failed: exit {proc.returncode}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
