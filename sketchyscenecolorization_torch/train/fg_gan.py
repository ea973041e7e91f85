"""FG instance-colorization GAN training
(``sketchyscenecolorization_tpu/train/fg_gan.py``; reference
``obj_lib/graph_single.py`` + ``obj_lib/main_procedure.py:62-242``).

One step = ``cfg.disc_steps`` discriminator updates, then one generator
update against the updated discriminator, each on its own batch, as in the
JAX step:
- the loss menu of ``graph_single.py:515-521``: with spectral norm the
  WGAN-SN softplus loss, else WGAN-GP (``wgan``) or the DRAGAN local GP,
  with the reference's clipping (global 50/100, per tensor 5/10); the
  ACGAN focal term unless ``proj_d``; the generator adds 100 x smooth-L1,
  and, given a perceptual module and ``coeff_perceptual > 0``, that
  coefficient x the Inception-v4 perceptual loss of its fakes against the
  real images (JAX ``train/fg_gan.py:223-226``); both add the dense
  layers' weight decay;
- the D updates differentiate only D: their fakes come from the generator
  under ``torch.no_grad``;
- spectral norm: every D pass of the D updates reads the stored u and
  commits nothing; the G update's real-image pass commits one power
  iteration from the stored u on the updated D weights (JAX
  ``capture_sn``, ``train/fg_gan.py:175-219``), its fake pass uses the
  stored u;
- Adam(b1=0, b2=0.9, eps=1e-8) with the linear decay floored at 0.2, taken
  at the count before the update; D's count is divided by ``disc_steps``.

The random draws of a step (the noise of every generator pass, the GP's
uniforms) come from a ``torch.Generator`` seeded by (seed, step), on the
host, so a resumed run and a run on another device draw the same; a caller
can pass them instead (``draws``), as the tests do with JAX's.  Where the
JAX step is a pure function, this one updates the models and moments in
place and returns the same state.

With a ``mesh`` the batches are this rank's rows of the global batches;
the draws stay the global batch's (from (seed, step), or as passed) and
the rank takes its rows of them.  The losses are the rank's shares
(``train/losses.py``), the batch norms take the global batch's moments
(``ops/norm.py``), each update's gradients are summed over 'data' before
the clipping and Adam (``parallel.reduce_gradients``), and the metrics are
the global batch's; the spectral-norm vectors are computed from the
replicated weights, so every rank commits the same ones.  A step is then
the single-process step on the global batch.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..config import FGGanConfig
from ..models.fg_gan import build_discriminator, build_generator
from ..models.gan_layers import commit_sn
from ..models.inception_v4 import InceptionV4, perceptual_loss
from ..parallel.mesh import (reduce_gradients, reduce_metrics, set_mesh,
                             shard_batch)
from ..utils.tracing import command, span
from .losses import (acgan_focal_loss, dragan_losses, fc_weight_decay_loss,
                     smooth_l1, wgan_gp_losses, wgan_sn_losses)
from .optim import (AdamState, adam_update, clip_by_global_norm,
                    clip_by_tensor_norm, grads_of)
from .schedules import fg_gan_lr_decay

ADAM_B1, ADAM_B2, ADAM_EPS = 0.0, 0.9, 1e-8
# (global, per-tensor) gradient clipping without spectral norm
G_CLIP, D_CLIP = (50.0, 5.0), (100.0, 10.0)


@dataclasses.dataclass
class FGGanTrainState:
    generator: torch.nn.Module
    discriminator: torch.nn.Module   # its buffers are the sn vectors
    g_opt: AdamState
    d_opt: AdamState
    step: int = 0

    def state_dict(self) -> Dict:
        """What a snapshot holds (``utils/checkpoint.py``)."""
        return {"generator": self.generator.state_dict(),
                "discriminator": self.discriminator.state_dict(),
                "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict(), "step": self.step}

    def load_state_dict(self, saved: Dict) -> None:
        self.generator.load_state_dict(saved["generator"])
        self.discriminator.load_state_dict(saved["discriminator"])
        self.g_opt.load_state_dict(saved["g_opt"])
        self.d_opt.load_state_dict(saved["d_opt"])
        self.step = int(saved["step"])


def build_models(cfg: FGGanConfig, seed: int = 0):
    """(generator, discriminator) of ``cfg``, fresh from ``seed``: the MRU
    pair (with ``num_blocks`` cells a stage and, without ``lstm_hybrid``,
    no text fusion) or the Pix2Pix or Residual variant by
    ``cfg.block_type`` (JAX ``train/fg_gan.py:45-75``).  The variants'
    discriminators take no ``proj_d`` and always return class logits; their
    one spectral-normed layer is ``ac_logits``, whose ``u`` the G update
    commits as for MRU."""
    return (build_generator(cfg, torch.Generator().manual_seed(2 * seed)),
            build_discriminator(cfg,
                                torch.Generator().manual_seed(2 * seed + 1)))


def create_fg_gan_state(cfg: FGGanConfig, seed: int = 0,
                        device="cuda") -> FGGanTrainState:
    gen, disc = build_models(cfg, seed)
    gen, disc = gen.to(device), disc.to(device)
    return FGGanTrainState(
        generator=gen, discriminator=disc,
        g_opt=AdamState.zeros(dict(gen.named_parameters())),
        d_opt=AdamState.zeros(dict(disc.named_parameters())))


def fg_gan_draws(cfg: FGGanConfig, seed: int, step: int,
                 device) -> Dict:
    """The random draws of step ``step``, for each D update (``"d"``, a
    list) and the G update (``"g"``): ``noise`` [B, noise_dim] and,
    without spectral norm, the GP's ``alpha`` [B, 1, 1, 1] and DRAGAN's
    ``perturb`` [B, S, S, 3] (the G update's GP moves no G loss; it is
    computed, as in JAX)."""
    g = torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))
    b, s = cfg.batch_size, cfg.image_size

    def draw():
        d = {"noise": torch.randn(b, cfg.noise_dim, generator=g)}
        if not cfg.spectral_norm:
            if not cfg.wgan:
                d["perturb"] = torch.rand(b, s, s, 3, generator=g)
            d["alpha"] = torch.rand(b, 1, 1, 1, generator=g)
        return {k: v.to(device) for k, v in d.items()}
    return {"d": [draw() for _ in range(max(cfg.disc_steps, 1))],
            "g": draw()}


def _optimize(params, grads, opt: AdamState, base_lr: float, per_step: int,
              max_iters: int, clip, mesh, trace=None) -> None:
    if mesh is not None:
        reduce_gradients(grads, mesh)
    with span(trace, "adam"):
        if clip is not None:
            grads = clip_by_tensor_norm(clip_by_global_norm(grads, clip[0]),
                                        clip[1])
        lr = float(np.float32(base_lr) * np.float32(
            fg_gan_lr_decay(opt.count // per_step, max_iters)))
        adam_update(params, grads, opt, lr, ADAM_B1, ADAM_B2, ADAM_EPS)


def make_fg_gan_train_step(cfg: FGGanConfig, seed: int = 0,
                           perceptual: Optional[InceptionV4] = None,
                           mesh=None, trace=None):
    """Returns ``step(state, batch_d, batch_g, draws=None) -> (state,
    metrics)``, data-parallel over ``mesh`` when one is given (the module
    docstring), traced into ``trace`` (a ``utils.tracing.Tracer``) when
    one is given: a root ``step`` (``req`` the state's step, counter
    ``d_updates``) over ``draws``, one ``d_update`` per D update (over
    ``d_forward``, ``d_backward``, ``adam``) and one ``g_update`` (over
    ``g_forward``, ``g_backward``, ``adam``).  Spans time the host; none
    waits for the device.

    ``perceptual`` (an ``InceptionV4`` through at least ``Mixed_5b``, on
    the models' device) adds the perceptual term when
    ``cfg.coeff_perceptual > 0``.  It is frozen: its parameters take no
    gradient and no Adam moments and are not part of the state, while the
    gradient flows through it to the generator.

    Each batch: tensors on the models' device: images [B,S,S,3] in
    [-1,1], sketches [B,S,S,3], images_d [B,S,S,3], class_id [B],
    class_id_d [B], tokens [B,T] (front-padded).  ``draws`` as
    ``fg_gan_draws`` gives them (default: drawn from ``seed`` and the
    state's step).  Metrics are 0-d tensors: loss_d (of the last D
    update), loss_g, recon_l1 and the NaN-watchdog flag ``nan``."""
    if perceptual is not None and cfg.coeff_perceptual > 0:
        perceptual.requires_grad_(False)
    else:
        perceptual = None
    n_d = max(cfg.disc_steps, 1)
    max_iters = cfg.max_iters

    def generate(gen, batch, noise):
        return gen(batch["sketches"], batch["tokens"].long(),
                   batch["class_id"].long(), noise)

    def gan_losses(disc, fakes, batch, draw, capture_sn=False):
        """(G's GAN loss, D's GAN loss).  The G-batch sketches go with both
        the D-batch real images and the fakes (``graph_single.py:269-273``;
        the MRU discriminator ignores them).  The fake pass reads the stored
        u; the real pass then commits its iteration with ``capture_sn``."""
        sketches, real = batch["sketches"], batch["images_d"]
        fake_out, fake_logit = disc(sketches, fakes, batch["class_id"])
        with commit_sn(disc) if capture_sn else contextlib.nullcontext():
            real_out, real_logit = disc(sketches, real, batch["class_id_d"])
        if cfg.spectral_norm:
            loss_g, loss_d = wgan_sn_losses(fake_out, real_out)
        else:
            def disc_fn(x):
                return disc(sketches, x, batch["class_id_d"])[0]
            if cfg.wgan:
                loss_g, loss_d = wgan_gp_losses(
                    disc_fn, fake_out, real_out, fakes, real, draw["alpha"],
                    ld=cfg.ld)
            else:
                loss_g, loss_d = dragan_losses(
                    disc_fn, fake_out, real_out, real, draw["perturb"],
                    draw["alpha"], ld=cfg.ld)
        if not cfg.proj_d:
            loss_g_ac, loss_d_ac = acgan_focal_loss(
                real_logit, batch["class_id_d"], fake_logit,
                batch["class_id"], cfg.num_classes)
            loss_g = loss_g + cfg.coeff_ac * loss_g_ac
            loss_d = loss_d + cfg.coeff_ac * loss_d_ac
        return loss_g, loss_d

    def d_loss_fn(gen, disc, batch, draw):
        with torch.no_grad():
            fakes = generate(gen, batch, draw["noise"])
        _, loss_d = gan_losses(disc, fakes, batch, draw)
        return loss_d + fc_weight_decay_loss(dict(disc.named_parameters()))

    def g_loss_fn(gen, disc, batch, draw):
        fakes = generate(gen, batch, draw["noise"])
        loss_g, _ = gan_losses(disc, fakes, batch, draw,
                               capture_sn=cfg.spectral_norm)
        recon = smooth_l1(fakes, batch["images"])
        loss_g = loss_g + cfg.coeff_l1 * recon + fc_weight_decay_loss(
            dict(gen.named_parameters()))
        if perceptual is not None:
            loss_g = loss_g + cfg.coeff_perceptual * perceptual_loss(
                perceptual, batch["images"], fakes)
        return loss_g, recon

    def step(state: FGGanTrainState, batch_d, batch_g,
             draws: Optional[Dict] = None):
        with command(trace, "step", req=state.step) as root:
            gen, disc = state.generator, state.discriminator
            if draws is None:
                with span(trace, "draws"):
                    draws = fg_gan_draws(cfg, seed, state.step,
                                         next(gen.parameters()).device)
            if mesh is not None:
                draws = {"d": [shard_batch(d, mesh) for d in draws["d"]],
                         "g": shard_batch(draws["g"], mesh)}
            d_params = dict(disc.named_parameters())
            with set_mesh(mesh):
                for k in range(n_d):
                    with span(trace, "d_update"):
                        with span(trace, "d_forward"):
                            loss_d = d_loss_fn(gen, disc, batch_d,
                                               draws["d"][k])
                        with span(trace, "d_backward"):
                            grads = grads_of(loss_d, d_params)
                        _optimize(d_params, grads, state.d_opt, cfg.lr_d,
                                  n_d, max_iters,
                                  None if cfg.spectral_norm else D_CLIP,
                                  mesh, trace)
                    root.count("d_updates")

                g_params = dict(gen.named_parameters())
                with span(trace, "g_update"):
                    with span(trace, "g_forward"):
                        loss_g, recon = g_loss_fn(gen, disc, batch_g,
                                                  draws["g"])
                    with span(trace, "g_backward"):
                        grads = grads_of(loss_g, g_params)
                    _optimize(g_params, grads, state.g_opt, cfg.lr_g, 1,
                              max_iters,
                              None if cfg.spectral_norm else G_CLIP,
                              mesh, trace)
            state.step += 1
            metrics = reduce_metrics(
                {"loss_d": loss_d.detach(), "loss_g": loss_g.detach(),
                 "recon_l1": recon.detach()},
                ("loss_d", "loss_g", "recon_l1"), mesh)
            metrics["nan"] = torch.isnan(metrics["loss_d"]) | torch.isnan(
                metrics["loss_g"])
            return state, metrics

    return step
