"""How far a rounding-level change of the data moves the GAN steps'
gradients in the PyTorch port on one card.

    python scripts/torch_gan_moment_sensitivity.py

For the default ``FGGanConfig`` and ``BGGanConfig(batch_size=2)`` (768^2),
from one fresh state and on the seeded batches of ``chip_smoke.py``'s
``train_fg_dp2`` and ``train_bg_dp2`` paths, one single-process train step
is taken as the base, then again unchanged, then with the float inputs
and, separately, the G and D weights multiplied elementwise by
1 + eps * U(-1, 1) (eps 1e-7, about one f32 rounding; two draws each).
Prints, for D's and G's Adam first moments after the step (the gradients:
the FG GAN's b1 is 0), the worst leaf's difference from the base over the
leaf's largest magnitude (floored at 1e-3 of the model's largest, as
``chip_smoke.py``'s ``_moment_error``) and the whole model's L2 ratio.
The data-parallel paths of ``chip_smoke.py`` print the same measures of
the mesh's step against the single-process step: where a rounding-level
change moves a moment as far, the comparison cannot hold it at the CPU
tests' tolerance.  Prints the card's name and power limit first.  Needs
one card.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from sketchyscenecolorization_torch.config import (  # noqa: E402
    BGGanConfig, FGGanConfig)
from sketchyscenecolorization_torch.ops import mlstm  # noqa: E402
from sketchyscenecolorization_torch.ops.conv import \
    apply_compute_dtype  # noqa: E402
from sketchyscenecolorization_torch.train import (  # noqa: E402
    create_bg_gan_state, create_fg_gan_state, make_bg_gan_train_step,
    make_fg_gan_train_step)

EPS = 1e-7
# (label, what is perturbed, seed of the perturbation)
RUNS = (("again", None, 0), ("inputs a", "inputs", 1),
        ("inputs b", "inputs", 2), ("weights a", "weights", 1),
        ("weights b", "weights", 2))


def perturbed(tensor, seed):
    g = torch.Generator(device=tensor.device).manual_seed(seed)
    noise = torch.rand(tensor.shape, generator=g, device=tensor.device)
    return tensor * (1 + EPS * (2 * noise - 1))


def moments_after_step(state0, step, batches, what, seed, device):
    state = copy.deepcopy(state0)
    if what == "weights":
        with torch.no_grad():
            for module in (state.generator, state.discriminator):
                for p in module.parameters():
                    p.copy_(perturbed(p, seed))
    args = []
    for batch in batches:
        args.append({})
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if what == "inputs" and t.dtype == torch.float32:
                t = perturbed(t, seed)
            args[-1][k] = t
    state, _ = step(state, *args)
    return {"g": {k: v.clone() for k, v in state.g_opt.mu.items()},
            "d": {k: v.clone() for k, v in state.d_opt.mu.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    mlstm.build()
    device = torch.device("cuda:0")
    fg, bg = FGGanConfig(), BGGanConfig(batch_size=2)
    apply_compute_dtype(fg, bg)
    rng = np.random.RandomState(0)        # the batches of chip_smoke.py
    fg_batches = (cs.fg_small_batch(rng, fg), cs.fg_small_batch(rng, fg))
    bg_batches = (cs.bg_batch(rng, bg),)
    for name, state0, step, batches in (
            ("FG", create_fg_gan_state(fg, seed=0, device=device),
             make_fg_gan_train_step(fg, seed=1), fg_batches),
            ("BG", create_bg_gan_state(bg, seed=0, device=device),
             make_bg_gan_train_step(bg), bg_batches)):
        base = moments_after_step(state0, step, batches, None, 0, device)
        for label, what, seed in RUNS:
            got = moments_after_step(state0, step, batches, what, seed,
                                     device)
            for side in ("d", "g"):
                err, leaf, leaf_max, top = cs._moment_error(got[side],
                                                            base[side])
                print(f"{name} {side} {label} (eps {EPS:g}): worst leaf "
                      f"{err:.3e} at {leaf} (leaf {leaf_max:.2e}, model "
                      f"{top:.2e}); whole model (L2) "
                      f"{cs._moment_norm_error(got[side], base[side]):.3e}",
                      flush=True)
        del state0, base
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
