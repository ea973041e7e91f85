"""BG colorization GAN training (``sketchyscenecolorization_tpu/train/bg_gan.py``;
reference ``bg_colorization_main.py:585-700``).

As in the JAX step:
- D trains first, on the generator's current outputs (computed without
  gradient, JAX's ``stop_gradient``); G's gradients are then taken against
  the updated D (bg main :671-682), so a step runs the generator forward
  twice and its backward once;
- losses: the log GAN on sigmoid D maps, L1 on non-FG pixels only, the
  region softmax xent; G's total = gan x 1 + L1 x 100 + seg x 100;
- Adam(b1 = ``beta1`` = 0.5, b2 = 0.999) on ``tf1_polynomial_decay(lr,
  lr/10, round(0.75 max_steps), 0.9)``, for D and G each on its own count;
- an EMA(0.99) of the five loss scalars is part of the train state
  (bg main :684-685); the first step sets it;
- ``remat`` recomputes the generator's activations in the backward
  (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``): a step then runs
  the generator forward three times.
The step updates the models and moments in place and returns the state.

With a ``mesh`` the batch is this rank's rows of the global batch: the
losses are the rank's shares (``train/losses.py``; the L1's pixel count
is the global batch's), the batch norms take the global batch's moments
(``ops/norm.py``), each update's gradients are summed over 'data'
(``parallel.reduce_gradients``), and the raw losses, and so the EMAs, are
the global batch's: the single-process step on the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..config import BGGanConfig
from ..models.bg_gan import build_discriminator, build_generator
from ..parallel.mesh import reduce_gradients, reduce_metrics, set_mesh
from .losses import bg_discrim_loss, bg_gan_losses
from .optim import AdamState, adam_update, grads_of
from .schedules import tf1_polynomial_decay

LOSS_KEYS = ("discrim_loss", "gen_loss_GAN", "gen_loss_L1",
             "region_mask_loss", "gen_loss")
ADAM_B2, ADAM_EPS = 0.999, 1e-8


@dataclasses.dataclass
class BGGanTrainState:
    generator: torch.nn.Module
    discriminator: torch.nn.Module
    g_opt: AdamState
    d_opt: AdamState
    ema_losses: Dict[str, torch.Tensor]   # 0-d tensors on the device
    step: int = 0

    def state_dict(self) -> Dict:
        """What a snapshot holds (``utils/checkpoint.py``)."""
        return {"generator": self.generator.state_dict(),
                "discriminator": self.discriminator.state_dict(),
                "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict(),
                "ema_losses": self.ema_losses, "step": self.step}

    def load_state_dict(self, saved: Dict) -> None:
        self.generator.load_state_dict(saved["generator"])
        self.discriminator.load_state_dict(saved["discriminator"])
        self.g_opt.load_state_dict(saved["g_opt"])
        self.d_opt.load_state_dict(saved["d_opt"])
        for k in LOSS_KEYS:
            self.ema_losses[k].copy_(saved["ema_losses"][k])
        self.step = int(saved["step"])


def build_models(cfg: BGGanConfig, seed: int = 0):
    """(generator, discriminator) of ``cfg``, fresh from ``seed``."""
    return (build_generator(cfg, torch.Generator().manual_seed(2 * seed)),
            build_discriminator(cfg,
                                torch.Generator().manual_seed(2 * seed + 1)))


def create_bg_gan_state(cfg: BGGanConfig, seed: int = 0,
                        device="cuda") -> BGGanTrainState:
    gen, disc = build_models(cfg, seed)
    gen, disc = gen.to(device), disc.to(device)
    return BGGanTrainState(
        generator=gen, discriminator=disc,
        g_opt=AdamState.zeros(dict(gen.named_parameters())),
        d_opt=AdamState.zeros(dict(disc.named_parameters())),
        ema_losses={k: torch.zeros((), device=device) for k in LOSS_KEYS})


def make_bg_gan_train_step(cfg: BGGanConfig, mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``, data-parallel
    over ``mesh`` when one is given (the module docstring).

    ``batch``: tensors on the models' device: inputs [B,S,S,3] (the FG
    composite, [-1,1]), targets [B,S,S,3] ([-1,1]), tokens [B,T]
    front-padded, labels [B,S,S] (0 fg, 1 sky, 2 ground).  Metrics (0-d
    tensors): the EMA'd losses ``ema/<key>``, the raw losses and the
    NaN-watchdog flag ``nan``."""
    if not cfg.residual_enc_g:
        raise NotImplementedError("pix2pix generator has no region branch; "
                                  "training requires residual_enc_g=True "
                                  "(matching the reference default)")
    schedule = tf1_polynomial_decay(cfg.lr, cfg.lr / 10.0,
                                    int(round(cfg.max_steps * 0.75)), 0.9)

    def forward_g(gen, batch):
        args = (batch["inputs"], batch["tokens"].long())
        if cfg.remat and torch.is_grad_enabled():
            def run(*a):
                # the recomputation runs in the backward, possibly on
                # autograd's device thread: it sets the mesh itself
                with set_mesh(mesh):
                    return gen(*a)
            return checkpoint(run, *args, use_reentrant=False)
        return gen(*args)

    def optimize(module, loss, opt: AdamState):
        params = dict(module.named_parameters())
        grads = grads_of(loss, params)
        if mesh is not None:
            reduce_gradients(grads, mesh)
        adam_update(params, grads, opt, schedule(opt.count), cfg.beta1,
                    ADAM_B2, ADAM_EPS)

    def step(state: BGGanTrainState, batch):
        gen, disc = state.generator, state.discriminator
        inputs, targets = batch["inputs"], batch["targets"]
        with set_mesh(mesh):
            # ---- D update, on the current G outputs ----
            with torch.no_grad():
                outputs, _ = forward_g(gen, batch)
            d_loss = bg_discrim_loss(disc(inputs, targets),
                                     disc(inputs, outputs))
            optimize(disc, d_loss, state.d_opt)

            # ---- G update against the updated D ----
            outputs, region_logits = forward_g(gen, batch)
            losses = bg_gan_losses(disc(inputs, targets),
                                   disc(inputs, outputs), targets, outputs,
                                   region_logits, batch["labels"],
                                   cfg.gan_weight, cfg.l1_weight,
                                   cfg.seg_weight)
            optimize(gen, losses["gen_loss"], state.g_opt)

        # ---- EMA of the loss scalars ----
        decay = cfg.ema_decay
        raw = {k: v.detach() for k, v in losses.items()}
        raw["discrim_loss"] = d_loss.detach()
        raw = reduce_metrics(raw, LOSS_KEYS, mesh)
        for k in LOSS_KEYS:
            new = raw[k] if state.step == 0 else \
                decay * state.ema_losses[k] + (1 - decay) * raw[k]
            state.ema_losses[k].copy_(new)
        state.step += 1
        metrics = {f"ema/{k}": state.ema_losses[k].clone() for k in LOSS_KEYS}
        metrics.update(raw)
        metrics["nan"] = torch.isnan(raw["discrim_loss"]) | torch.isnan(
            raw["gen_loss"])
        return state, metrics

    return step
