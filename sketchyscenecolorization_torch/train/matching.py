"""RMI matching training step (``sketchyscenecolorization_tpu/train/matching.py``;
reference ``RMI_model.py:312-372`` + ``matching_main.py:81-241``).

Semantics, as in the JAX step:
- loss = weighted logistic loss SUMMED over drawing pixels only (pixels
  whose mean-subtracted R channel < 0) + weight_decay * l2 over the
  trainable ``DW`` leaves;
- polynomial LR decay 2.5e-4 -> 1e-5 over 75k steps, power 0.9, evaluated
  at the step count before the update;
- Adam (optax's: eps outside the square root), with gradients of the
  ``biases`` leaves multiplied by 2 before the update (the reference's
  per-variable LR multiplier); no weight decay inside Adam;
- only ``text_sketchyscene`` trains by default (``train_fusion_var_only``):
  the backbone's parameters get ``requires_grad=False`` and it runs without
  autograd (``RMI.extract_visual``).

Where the JAX step is a pure function of an immutable state, this one
updates the model and the Adam moments in place and returns the same state.

With a ``mesh`` (``parallel.create_mesh``) the batch is this rank's rows of
the global batch: the loss is the rank's share (``train/losses.py``), the
trainable gradients are summed over 'data' before the update and the
metrics are the global batch's, so every rank applies the global step of
JAX's jitted step on the sharded batch; with ``shard_mlstm_pixels`` the
fusion's pixels are sharded over 'model' (``models/rmi.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from ..config import MatchingConfig
from ..models.rmi import RMI
from ..parallel.mesh import reduce_gradients, reduce_metrics, set_mesh
from .losses import l2_regularization_loss, weighted_logistic_loss
from .optim import AdamState, adam_update
from .schedules import tf1_polynomial_decay

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BIAS_LR_MULT = 2.0


@dataclasses.dataclass
class MatchingTrainState:
    model: RMI                        # trained in place
    mu: Dict[str, torch.Tensor]       # Adam moments of the trainable leaves,
    nu: Dict[str, torch.Tensor]       # keyed by parameter name
    step: int = 0                     # updates applied so far

    def state_dict(self) -> Dict:
        """What a snapshot holds (``utils/checkpoint.py``)."""
        return {"model": self.model.state_dict(), "mu": self.mu,
                "nu": self.nu, "step": self.step}

    def load_state_dict(self, saved: Dict) -> None:
        self.model.load_state_dict(saved["model"])
        for ours, theirs in ((self.mu, saved["mu"]), (self.nu, saved["nu"])):
            if sorted(ours) != sorted(theirs):
                raise ValueError("snapshot trains other leaves: "
                                 f"{sorted(theirs)} vs {sorted(ours)}")
            for name, value in theirs.items():
                ours[name].copy_(value)
        self.step = int(saved["step"])


def trainable_names(model: RMI, cfg: MatchingConfig) -> List[str]:
    """Names of the parameters that train (JAX ``matching.py:39-45``)."""
    names = [name for name, _ in model.named_parameters()]
    if cfg.train_fusion_var_only:
        return [n for n in names if n.startswith("text_sketchyscene.")]
    return names


def create_matching_state(model: RMI, cfg: MatchingConfig
                          ) -> MatchingTrainState:
    """Freeze what does not train and zero the Adam moments of the rest."""
    names = set(trainable_names(model, cfg))
    params = dict(model.named_parameters())
    for name, p in params.items():
        p.requires_grad_(name in names)
    zeros = lambda: {n: torch.zeros_like(params[n])            # noqa: E731
                     for n in sorted(names)}
    return MatchingTrainState(model=model, mu=zeros(), nu=zeros())


def matching_loss_fn(model: RMI, cfg: MatchingConfig,
                     batch: Dict[str, torch.Tensor], trainable: List[str]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(cost, {cls_loss, reg_loss, sigm}) of one batch (JAX
    ``matching.py:68-81``)."""
    image = batch["image"]
    out = model(image, batch["words"].long(), batch["seq_len"])
    valid = ((image[..., 0:1] < 0).float() if cfg.training_ignore_bg
             else None)
    cls_loss = weighted_logistic_loss(out.up, batch["target_mask"],
                                      valid_mask=valid)
    params = dict(model.named_parameters())
    reg_loss = l2_regularization_loss(
        [params[n] for n in trainable if n.endswith(".DW")], cfg.weight_decay)
    return cls_loss + reg_loss, {"cls_loss": cls_loss, "reg_loss": reg_loss,
                                 "sigm": out.sigm}


def make_matching_train_step(cfg: MatchingConfig, mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``, data-parallel
    over ``mesh`` when one is given (the module docstring).

    ``batch``: tensors on the model's device: image [N, H, W, 3]
    mean-subtracted float32, words [N, T] end-padded, seq_len [N],
    target_mask [N, H, W, 1] float32.  After the step each trainable
    parameter's ``.grad`` holds its gradient (before the bias
    multiplier)."""
    schedule = tf1_polynomial_decay(cfg.start_lr, cfg.end_lr,
                                    cfg.lr_decay_step, cfg.lr_power)

    def step(state: MatchingTrainState, batch):
        params = dict(state.model.named_parameters())
        names = list(state.mu)
        for name in names:
            params[name].grad = None
        with set_mesh(mesh):
            cost, aux = matching_loss_fn(state.model, cfg, batch, names)
            cost.backward()
        if mesh is not None:
            reduce_gradients({n: params[n].grad for n in names}, mesh)
        lr = schedule(state.step)
        grads = {n: params[n].grad * BIAS_LR_MULT if n.endswith(".biases")
                 else params[n].grad for n in names}
        adam_update(params, grads, AdamState(state.mu, state.nu, state.step),
                    lr, ADAM_B1, ADAM_B2, ADAM_EPS)
        state.step += 1
        metrics = {"cost": cost.detach(),
                   "cls_loss": aux["cls_loss"].detach(),
                   "reg_loss": aux["reg_loss"].detach(), "lr": lr}
        return state, reduce_metrics(metrics, ("cost", "cls_loss",
                                               "reg_loss"), mesh)

    return step
