"""The output check of the matcher-training cell, and its work counts.

The plain reference follows the program's first three steps from the same
weights and batches: the RMI forward (frozen ResNet-101 without autograd),
the weighted logistic loss summed over the drawing pixels plus weight
decay on the trainable kernels, the gradient of the fusion's leaves, the
polynomial learning rate and Adam (eps outside the square root, the
biases' gradients doubled).  Compared, by the worst leaf:

- ``loss_gap``: each step's loss, relative to the reference's;
- ``grad_gap``: the norm of the first gradient as the optimizer gets it
  (the program's from its first moment after one step, mu / (1 - b1)),
  the gap between the two norms over the larger of the reference's norm
  of that leaf and of the median leaf;
- ``change_gap``: the norm of each leaf's change over the three steps,
  the same way.  Leaves whose reference gradient is under a thousandth of
  the median leaf's move by round-off alone under Adam and are left out.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import reference
from .reference import ops

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BIAS_MULT = 2.0
QUIET = 1e-3          # leaves under this share of the median gradient


def lr_at(m: dict, step: int) -> float:
    f32 = np.float32
    s = min(f32(step), f32(m["lr_decay_step"]))
    frac = f32(1.0) - s / f32(m["lr_decay_step"])
    return float(f32(m["start_lr"] - m["end_lr"]) * frac ** f32(m["lr_power"])
                 + f32(m["end_lr"]))


def reference_steps(m: dict, batches: List[dict], seed: int, device,
                    precision: str = "float32") -> dict:
    """Losses, first gradients and three steps' change of the reference."""
    model, _ = reference.build("matching", m, seed, device)
    train = {n: p for n, p in model.named_parameters()
             if n.startswith("text_sketchyscene.")}
    for p in train.values():
        p.requires_grad_(True)
    mu = {n: torch.zeros_like(p) for n, p in train.items()}
    nu = {n: torch.zeros_like(p) for n, p in train.items()}
    start = {n: p.detach().clone() for n, p in train.items()}
    losses, grads = [], None
    with ops.precision(precision):
        for step, b in enumerate(batches):
            image = torch.from_numpy(b["image"]).to(device)
            with torch.no_grad():
                feats = model.ResNet(image)
            proj = model.text_sketchyscene.visual_feat_projection
            visual = ops.l2_normalize(ops.conv2d(feats, proj.DW) + proj.biases)
            up = model.fuse(visual,
                            torch.from_numpy(b["words"]).long().to(device),
                            torch.from_numpy(b["seq_len"]).long().to(device)).up
            z = torch.from_numpy(b["target_mask"]).to(device)
            valid = (image[..., 0:1] < 0).float()
            xent = torch.clamp_min(up, 0) - up * z \
                + torch.log1p(torch.exp(-up.abs()))
            loss = torch.sum(xent * valid) + m["weight_decay"] * sum(
                0.5 * torch.sum(p * p) for n, p in train.items()
                if n.endswith(".DW"))
            g = torch.autograd.grad(loss, list(train.values()),
                                    allow_unused=True)
            g = {n: (torch.zeros_like(p) if gi is None else gi)
                 * (BIAS_MULT if n.endswith(".biases") else 1.0)
                 for (n, p), gi in zip(train.items(), g)}
            if grads is None:
                grads = {n: v.detach().cpu() for n, v in g.items()}
            losses.append(float(loss.detach()))
            lr = lr_at(m, step)
            bc1 = 1.0 - ADAM_B1 ** (step + 1)
            bc2 = 1.0 - ADAM_B2 ** (step + 1)
            with torch.no_grad():
                for n, p in train.items():
                    mu[n] = ADAM_B1 * mu[n] + (1 - ADAM_B1) * g[n]
                    nu[n] = ADAM_B2 * nu[n] + (1 - ADAM_B2) * g[n] * g[n]
                    p -= lr * (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2)
                                               + ADAM_EPS)
    change = {n: (p.detach() - start[n]).cpu() for n, p in train.items()}
    return {"losses": losses, "grads": grads, "change": change}


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(v.double())) for n, v in d.items()}


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             keep=None) -> float:
    g, w = _norms(got), _norms(want)
    floor = float(np.median(list(w.values())))
    names = [n for n in w if keep is None or n in keep]
    return max(abs(g[n] - w[n]) / max(w[n], floor) for n in names)


def moving_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(grads)
    med = float(np.median(list(norms.values())))
    return [n for n, v in norms.items() if v >= QUIET * med]


def checks(prog: dict, want: dict, limits: dict) -> List[dict]:
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], want["losses"]))
    values = {"loss_gap": loss_gap,
              "grad_gap": leaf_gap(prog["grads"], want["grads"]),
              "change_gap": leaf_gap(prog["change"], want["change"],
                                     set(moving_leaves(want["grads"])))}
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in values.items()]


def passed(checks_: List[dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks_)


def train_work(m: dict, plan, first: int, steps: int) -> Dict[str, float]:
    """FLOPs (forward of the frozen backbone, forward and backward of the
    fusion: its convolutions and products twice over for the backward)
    and B1's and B2's bounds of the window's ``steps`` steps, which take
    the batches after the first ``first``."""
    from .reference.text import matching_encode
    from .serve_check import vocab
    from .work import (_js, bwd_bound_s, fwd_bound_s, model_flops,
                       recurrence_flops)
    mv = vocab("match_vocab.txt")
    p = m["vf_h"] * m["vf_w"]
    hid, t = m["m_rnn_size"], m["max_len"]
    backbone = model_flops("matching", _js(m), "backbone")
    fusion = model_flops("matching", _js(m), "fusion")
    flops = b1 = b2 = 0.0
    for i in range(first, first + steps):
        _, n = matching_encode(plan[i % len(plan)].caption, mv, t)
        rec = recurrence_flops(p, hid, n)
        flops += backbone + 3 * (fusion + rec)
        b1 += fwd_bound_s(1, p, hid, t, [n])
        b2 += bwd_bound_s(1, p, hid, t, [n])
    return {"flops": flops, "b1_bound_s": b1, "b2_bound_s": b2}
