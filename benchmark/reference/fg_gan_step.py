"""Plain reference of the FG instance-colorization GAN's training step
(``Foreground_Instance_Colorization/obj_lib/graph_single.py`` and
``obj_lib/main_procedure.py:62-242`` of "Language-based Colorization of
Scene Sketches"), with the spectral-norm ACGAN discriminator of
``fg_disc.py`` and the MRU generator of ``fg_gan.py``.

One step is one discriminator update, then one generator update against
the updated discriminator, each on its own batch:

- D update: fakes of the D batch's sketches, captions, classes and noise
  under ``no_grad``; D's passes over the fakes and over the batch's real
  images (``images_d``) read the stored spectral-norm vectors and commit
  none; loss = the WGAN-SN softplus loss + ``coeff_ac`` x the ACGAN focal
  loss on the real images + the dense kernels' weight decay; its gradient
  over D's leaves; Adam.
- G update: fakes of the G batch with their graph; D's pass over them
  reads the stored vectors, its pass over the G batch's real images then
  commits one power iteration from them on the updated D; loss =
  softplus(-D(fake)) + ``coeff_ac`` x 0.5 x the class cross-entropy of
  the fakes + ``coeff_l1`` x smooth-L1 against the colour images + the
  weight decay; its gradient over G's leaves; Adam.
- Adam(b1 = 0, b2 = 0.9, eps = 1e-8, eps outside the square root), the
  learning rate the base rate times max(0.2, 1 - 0.9 count / max_iters)
  at the update count before the update, in float32.
- The noise of each generator pass: a CPU ``torch.Generator`` seeded with
  the first word of ``numpy.random.SeedSequence([seed, step])``, one
  [B, noise_dim] normal draw for the D update, then one for the G update.

Departures from the published code, each also the measured program's:

- NHWC throughout (the published model transposes to NCHW for cuDNN);
- the generator's conditional batch-norm takes the batch's moments
  (``batch_norm`` in training mode) and keeps no running statistics, as
  the published model, built ``is_training=True``, never reads them;
- a spectral-norm vector is committed by the G update's real pass only
  (the published graph runs its ``sn`` update ops with that pass), and D's
  sketch input is ignored (``discriminate_mru`` reads only the image);
- the published loader's queues and its per-step host work are replaced
  by the cell's seeded batches; the perceptual term is off, as published
  (``graph_single.py:557-559``).

The generator swaps ``fg_gan.py``'s per-row statistics (served rows are
independent) for the batch's: ``training_generator``.  TF32 is off in
cuBLAS and cuDNN (``ops.precision``) unless the control asks for it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build, ops
from .fg_disc import settle_u, sn_layers, stored_u
from .fg_gan import CondBN

ADAM_B1, ADAM_B2, ADAM_EPS = 0.0, 0.9, 1e-8
FC_DECAY = 1e-6
F32 = np.float32


class BatchCondBN(CondBN):
    """Conditional batch-norm on the batch's moments (training)."""

    def forward(self, x, labels):
        return ops.conditional_batch_norm(x, labels, self.offset, self.scale,
                                          per_sample=False)


def training_generator(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if type(m) is CondBN:
            m.__class__ = BatchCondBN
    return model


def models(f: dict, seed: int, device):
    """(generator, discriminator) with the seeded weights the program is
    loaded with (their state dicts); D's vectors after one iteration."""
    gen, _ = build("fg_gan", f, seed, device)
    disc, _ = build("fg_disc", f, seed, device)
    settle_u(disc)
    return training_generator(gen), disc


def draws(f: dict, seed: int, step: int) -> Tuple[List[torch.Tensor],
                                                  torch.Tensor]:
    """(noise of each D update, noise of the G update) of ``step``."""
    g = torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))
    shape = (f["batch_size"], f["noise_dim"])
    d = [torch.randn(shape, generator=g)
         for _ in range(max(f["disc_steps"], 1))]
    return d, torch.randn(shape, generator=g)


def lr_at(base: float, count: int, max_iters: int) -> float:
    decay = np.maximum(F32(0.2), F32(1.0) - F32(count) / F32(max_iters)
                       * F32(0.9))
    return float(F32(base) * F32(decay))


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor]):
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, params, grads, lr: float) -> None:
        t = F32(self.count + 1)
        bc1 = float(F32(1.0) - F32(ADAM_B1) ** t)
        bc2 = float(F32(1.0) - F32(ADAM_B2) ** t)
        for n, p in params.items():
            g = grads[n]
            self.mu[n] = (1.0 - ADAM_B1) * g + ADAM_B1 * self.mu[n]
            self.nu[n] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu[n]
            step = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2)
                                         + ADAM_EPS)
            p.add_(step * (-lr))
        self.count += 1


def fc_decay(params: Dict[str, torch.Tensor]):
    """rate x sum(w^2) / 2 over the dense layers' kernels (the 2-D leaves
    named ``weights``; ``mru.py:55-68``)."""
    return sum(FC_DECAY * 0.5 * torch.sum(p * p) for n, p in params.items()
               if n.rpartition(".")[2] == "weights" and p.ndim == 2)


def xent(logits, labels):
    return -torch.gather(F.log_softmax(logits, dim=-1), 1,
                         labels[:, None])[:, 0]


def focal_d(logits, labels, n_classes):
    """``get_acgan_loss_focal``'s D term: (1 - p_true)^2 x xent, mean."""
    p_true = torch.sum(torch.softmax(logits, dim=-1)
                       * F.one_hot(labels, n_classes), dim=1)
    return torch.mean((1.0 - p_true) ** 2 * xent(logits, labels))


def smooth_l1(pred, target):
    diff = torch.abs(target - pred)
    return torch.mean(torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5))


def _tensors(batch: dict, device, dtype) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    for k, v in out.items():
        out[k] = v.long() if k in ("class_id", "class_id_d", "tokens") \
            else v.to(dtype)
    return out


def trainable(model) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters()
            if not n.endswith(".u")}


def to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()}


def snapshot(params: dict, u: Dict[str, torch.Tensor], opts: dict) -> dict:
    """A train state on the host: the leaves of ``params`` ({"g", "d"}),
    the stored spectral-norm vectors ``u`` and each model's Adam in
    ``opts`` (its ``mu``, ``nu`` and ``count``)."""
    return {"params": {m: to_host(ps) for m, ps in params.items()},
            "u": to_host(u),
            "mu": {m: to_host(o.mu) for m, o in opts.items()},
            "nu": {m: to_host(o.nu) for m, o in opts.items()},
            "count": {m: o.count for m, o in opts.items()}}


def record(out: dict, losses, grads: dict, params: dict,
           u: Dict[str, torch.Tensor]) -> None:
    """Append a step's outputs to ``out``, whose last ``starts`` entry
    ``snapshot`` took before the step: its (D, G) ``losses``, the
    ``grads`` of each model's last update, each leaf's move and the
    stored vectors ``u`` after it."""
    before = out["starts"][-1]["params"]
    out["losses"] += [float(v.detach()) for v in losses]
    out["grads"].append({m: to_host(g) for m, g in grads.items()})
    out["change"].append({m: {n: v - before[m][n]
                              for n, v in to_host(ps).items()}
                          for m, ps in params.items()})
    out["sn"].append(to_host(u))


def reference_steps(f: dict, batches: List[Tuple[dict, dict]], seed: int,
                    device, precision: str = "float32",
                    dtype=torch.float32, starts=None) -> dict:
    """One step a batch pair (D batch, G batch) of host arrays, from the
    seeded weights and on (``starts`` None), or each from the state a run
    held before it (``starts``: one a step, {"params": {"g", "d"}, "u",
    "mu": {"g", "d"}, "nu": {"g", "d"}, "count": {"g", "d"}}), which
    leaves each step's comparison at the rounding of that step alone.

    Returns, a step each: ``losses`` (D's, then G's), ``grads`` ({"g",
    "d"}: the gradient of the step's last update of each model),
    ``change`` ({"g", "d"}: each leaf's move), ``sn`` (the stored vectors
    after it) and ``starts`` (the state before it), the form the check
    reads of the program.  ``dtype`` float64 makes the tests' oracle."""
    gen, disc = models(f, seed, device)
    gen, disc = gen.to(dtype), disc.to(dtype)
    par = {"g": trainable(gen), "d": trainable(disc)}
    for ps in par.values():
        for p in ps.values():
            p.requires_grad_(True)
    opt = {m: Adam(ps) for m, ps in par.items()}
    layers = sn_layers(disc)
    n_d = max(f["disc_steps"], 1)
    nc = f["num_classes"]
    out = {k: [] for k in ("losses", "grads", "change", "sn", "starts")}
    with ops.precision(precision):
        for step, (bd, bg) in enumerate(batches):
            if starts is not None:
                _load(starts[step], par, opt, layers, device, dtype)
            out["starts"].append(snapshot(par, stored_u(disc), opt))
            noise_d, noise_g = draws(f, seed, step)
            bd, bg = _tensors(bd, device, dtype), _tensors(bg, device, dtype)
            for k in range(n_d):
                with torch.no_grad():
                    fakes = gen(bd["sketches"], bd["tokens"], bd["class_id"],
                                noise_d[k].to(device, dtype))
                fake_out, _ = disc(fakes)
                real_out, real_logit = disc(bd["images_d"])
                loss_d = (torch.mean(F.softplus(fake_out))
                          + torch.mean(F.softplus(-real_out))
                          + f["coeff_ac"] * focal_d(real_logit,
                                                    bd["class_id_d"], nc)
                          + fc_decay(par["d"]))
                gd = dict(zip(par["d"], torch.autograd.grad(
                    loss_d, list(par["d"].values()))))
                opt["d"].update(par["d"], gd, lr_at(
                    f["lr_d"], opt["d"].count // n_d, f["max_iters"]))
            fakes = gen(bg["sketches"], bg["tokens"], bg["class_id"],
                        noise_g.to(device, dtype))
            fake_out, fake_logit = disc(fakes)
            with torch.no_grad():
                disc(bg["images_d"], commit=True)
            loss_g = (torch.mean(F.softplus(-fake_out))
                      + f["coeff_ac"] * 0.5 * torch.mean(
                          xent(fake_logit, bg["class_id"]))
                      + f["coeff_l1"] * smooth_l1(fakes, bg["images"])
                      + fc_decay(par["g"]))
            gg = dict(zip(par["g"], torch.autograd.grad(
                loss_g, list(par["g"].values()), allow_unused=True)))
            gg = {n: torch.zeros_like(par["g"][n]) if v is None else v
                  for n, v in gg.items()}
            opt["g"].update(par["g"], gg, lr_at(f["lr_g"], opt["g"].count,
                                                f["max_iters"]))
            record(out, (loss_d, loss_g), {"g": gg, "d": gd}, par,
                   stored_u(disc))
    return out


@torch.no_grad()
def _load(state: dict, par, opt, layers, device, dtype) -> None:
    for m, ps in par.items():
        for n, p in ps.items():
            p.copy_(state["params"][m][n])
        opt[m].mu = {n: v.to(device, dtype) for n, v in state["mu"][m].items()}
        opt[m].nu = {n: v.to(device, dtype) for n, v in state["nu"][m].items()}
        opt[m].count = state["count"][m]
    for n, u in state["u"].items():
        layers[n[:-len(".u")]].stored = u.to(device, dtype)
