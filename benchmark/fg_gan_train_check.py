"""The output check of the FG GAN training cell, and its work counts.

The plain reference (``reference/fg_gan_step.py``) takes each of the
program's first three steps from the state the program held before it
(weights, spectral-norm vectors, Adam's moments and counts), on the same
batches and noise: each comparison is then of one step's rounding, where
a free-running pair of GAN steps would drift apart (Adam with b1 = 0
moves every element by about +-lr, so an element whose gradient is near
its rounding moves the other way on the other side).  Compared, each the
worst over the three steps:

- ``loss_gap``: the step's D loss and G loss, relative to the
  reference's;
- ``grad_gap``: each leaf's gradient as Adam got it (with b1 = 0 Adam's
  first moment after an update is its gradient), the distance between
  the program's and the reference's over the larger of that leaf's norm
  and its model's median leaf norm (a gradient that is zero up to
  rounding, as a conv bias's under a batch norm, reads against its
  model's scale): the worst leaf, so that a wrong gradient of a small
  leaf (the ACGAN head, a PReLU's slopes) shows;
- ``change_gap``: each leaf's move in the step against the reference's
  Adam update from the same state with the program's own gradient, the
  distance over the larger of that leaf's norm and its model's median
  leaf norm: the optimizer's arithmetic alone (its learning rate, bias
  correction, eps), since a gradient that is zero up to rounding (a conv
  bias under a batch norm, a gate's bias under a min-max normalization)
  is moved by +-lr whatever its size, and by its sign, which rounding
  sets; a step that leaves the state unchanged reads 1;
- ``sn_gap``: the largest distance between a spectral-norm vector the
  program stored in the step and one power iteration of the reference,
  in float64, from the vector the program held before it on its
  discriminator's weights after the step's D update (unit vectors: the
  distance is relative): the commit alone, as ``change_gap`` is the
  update alone, since the reference's own D update moves the kernels by
  +-lr where rounding sets a gradient's sign.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .reference.fg_disc import power_iteration
from .reference.fg_gan_step import Adam, lr_at

MODELS = ("g", "d")


def leaf_distances(got: Dict[str, torch.Tensor],
                   want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's |got - want| over the larger of |want| and the median
    leaf's |want|."""
    norms = {n: float(torch.linalg.vector_norm(v.double()))
             for n, v in want.items()}
    floor = float(np.median(list(norms.values())))
    return {n: float(torch.linalg.vector_norm(
        got[n].double().cpu() - want[n].double())) / max(norms[n], floor)
        for n in want}


def leaf_distance(got: Dict[str, torch.Tensor],
                  want: Dict[str, torch.Tensor]) -> float:
    return max(leaf_distances(got, want).values())


def adam_moves(f: dict, start: dict, grads: dict) -> dict:
    """{"g", "d"}: each leaf's move under the reference's Adam from the
    state ``start`` with the gradients ``grads`` (one D update a step)."""
    if max(f["disc_steps"], 1) != 1:
        raise ValueError("the check replays one D update a step")
    out = {}
    for m, base in (("g", f["lr_g"]), ("d", f["lr_d"])):
        before = start["params"][m]
        params = {n: v.clone() for n, v in before.items()}
        opt = Adam(params)
        opt.mu, opt.nu = dict(start["mu"][m]), dict(start["nu"][m])
        opt.count = start["count"][m]
        opt.update(params, {n: g.to(params[n].dtype)
                            for n, g in grads[m].items()},
                   lr_at(base, opt.count, f["max_iters"]))
        out[m] = {n: params[n] - before[n] for n in params}
    return out


def sn_iterates(start: dict, change_d: dict) -> Dict[str, torch.Tensor]:
    """{'<layer>.u': one power iteration, in float64, from the stored
    vector of ``start`` on the layer's kernel moved by ``change_d``}."""
    out = {}
    for name, u in start["u"].items():
        key = name[:-len(".u")] + ".weights"
        w = start["params"]["d"][key].double() + change_d[key].double()
        w2 = w.reshape(w.shape[0], -1).T if w.ndim == 4 else w
        out[name] = power_iteration(w2, u.double())[1]
    return out


def gaps(prog: dict, want: dict, f: dict) -> Dict[str, float]:
    """The four compared numbers of the program's per-step outputs
    (``losses``, ``grads``, ``change``, ``sn`` and the ``starts`` each
    step took) against the reference's (``reference_steps``): its losses
    and gradients from the same states, its Adam and power iteration on
    the program's own gradients and weights."""
    steps = range(len(want["grads"]))
    moves = [adam_moves(f, prog["starts"][k], prog["grads"][k])
             for k in steps]
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], want["losses"])),
        "grad_gap": max(leaf_distance(prog["grads"][k][m],
                                      want["grads"][k][m])
                        for k in steps for m in MODELS),
        "change_gap": max(leaf_distance(prog["change"][k][m], moves[k][m])
                          for k in steps for m in MODELS),
        "sn_gap": max(float(torch.linalg.vector_norm(
            prog["sn"][k][n].double().cpu() - u))
            for k in steps for n, u in sn_iterates(
                prog["starts"][k], prog["change"][k]["d"]).items())}


def checks(prog: dict, want: dict, f: dict, limits: dict) -> List[dict]:
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in gaps(prog, want, f).items()]


def kept(tokens) -> List[int]:
    """Valid steps of each front-padded caption row."""
    return [int((row != 0).sum()) for row in tokens]


def gan_flops(f: dict) -> Dict[str, float]:
    """Forward FLOPs of one instance through the generator (without its
    recurrence) and through the discriminator, counted on the plain
    reference on the meta device."""
    import json
    from . import reference
    from .work import count_flops, model_flops
    s = f["image_size"]
    disc = reference.skeleton("fg_disc", f)
    with torch.no_grad():
        d = count_flops(lambda: disc(torch.empty(1, s, s, 3, device="meta")))
    return {"g": model_flops("fg_gan", json.dumps(f, sort_keys=True), "row"),
            "d": d}


def train_work(f: dict, batches, first: int, steps: int) -> Dict[str, float]:
    """Model FLOPs and B1's and B2's bounds of the window's ``steps``
    steps, which take the batch pairs after the first ``first``.

    FLOPs are the products a step needs: the D update's generator forward
    (no gradient), two discriminator forwards and their backward, weights
    and inputs (twice the forward); the G update's generator forward and
    backward (three times), two discriminator forwards and the backward of
    the one over the fakes, inputs only (once); the recurrence as its
    needed products, its backward twice its forward.  B1 runs once in
    each generator forward, B2 once in the G update's backward."""
    from .work import bwd_bound_s, fwd_bound_s, recurrence_flops
    per = gan_flops(f)
    b = f["batch_size"]
    p = (f["image_size"] // 32) ** 2
    hid, t = 8 * f["base_channels"], f["max_len"]
    flops = b1 = b2 = 0.0
    for i in range(first, first + steps):
        bd, bg = batches[i % len(batches)]
        kd, kg = kept(bd["tokens"]), kept(bg["tokens"])
        flops += b * (4 * per["g"] + 9 * per["d"])
        flops += sum(recurrence_flops(p, hid, k) for k in kd)
        flops += 3 * sum(recurrence_flops(p, hid, k) for k in kg)
        b1 += fwd_bound_s(b, p, hid, t, kd) + fwd_bound_s(b, p, hid, t, kg)
        b2 += bwd_bound_s(b, p, hid, t, kg)
    return {"flops": flops, "b1_bound_s": b1, "b2_bound_s": b2}
