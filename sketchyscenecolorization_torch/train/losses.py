"""Losses (``sketchyscenecolorization_tpu/train/losses.py``).

Matching: ``Instance_Matching/utils/loss.py``.  FG GAN
(``obj_lib/graph_single.py:330-581``): WGAN-SN softplus (the active one
under spectral norm), WGAN-GP, the DRAGAN-style one-sided local GP, ACGAN
focal, smooth-L1, and the dense layers' weight decay.  BG GAN
(``bg_colorization_main.py:585-700``): the log GAN on sigmoid maps, L1 on
non-FG pixels only, region softmax xent.  The GP losses take their
uniform draws as arguments, so a caller can feed the JAX package's.

Under a mesh with several 'data' ranks (a data-parallel step holds it with
``parallel.set_mesh``) each loss is this rank's share of the global
batch's loss, so that the gradients summed over 'data'
(``parallel.reduce_gradients``) are the global batch's.  Each function
says which case it is: a sum over the batch is a share as it stands; a
mean over the batch is the shard's mean over the number of shards
(``shard_mean``); a term of the replicated weights is counted on the first
'data' rank only (``count_once``); a statistic of the whole batch (the BG
L1's pixel count, DRAGAN's standard deviation) is summed over 'data'
first (``global_sum``).  Without a mesh each is the plain loss.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import count_once, data_axis, global_sum, shard_mean


def sigmoid_xent_with_logits(logits: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """tf.nn.sigmoid_cross_entropy_with_logits:
    max(x, 0) - x*z + log1p(exp(-|x|))."""
    return (torch.clamp_min(logits, 0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def weighted_logistic_loss(scores: torch.Tensor, labels: torch.Tensor,
                           pos_loss_mult: float = 1.0,
                           neg_loss_mult: float = 1.0,
                           valid_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """A plain SUM over all elements (the reference's
    ``reduce_mean(reduce_sum(...))``); ``valid_mask`` is the ignore-background
    gather as a masked sum.  A sum: the shards' losses add up to the
    global one."""
    loss_mult = labels * (pos_loss_mult - neg_loss_mult) + neg_loss_mult
    xent = sigmoid_xent_with_logits(scores, labels) * loss_mult
    if valid_mask is not None:
        xent = xent * valid_mask
    return torch.sum(xent)


def l2_regularization_loss(variables: Iterable[torch.Tensor],
                           weight_decay: float) -> torch.Tensor:
    """``weight_decay * sum(l2_loss(v))`` with l2_loss = sum(v^2)/2.  Of
    the replicated weights: counted once over 'data'."""
    return count_once(weight_decay * sum(0.5 * torch.sum(torch.square(v))
                                         for v in variables))


# ---------------------------------------------------------------- fg GAN

def smooth_l1(pred, target):
    """``graph_single.py:551-555``: elementwise smooth-L1, mean over all
    (a shard's share)."""
    diff = torch.abs(target - pred)
    return shard_mean(torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5))


def sparse_softmax_xent(logits, labels):
    return -torch.gather(F.log_softmax(logits, dim=-1), 1,
                         labels[:, None].long())[:, 0]


def acgan_focal_loss(real_logits, real_labels, fake_logits, fake_labels,
                     num_classes: int, ld1=1.0, ld2=0.5, ld_focal=2.0):
    """``get_acgan_loss_focal`` (``graph_single.py:340-353``): focal-weighted
    xent on real for D; plain xent on fake for G; batch means (shares).
    Returns (G, D)."""
    p_true = torch.sum(torch.softmax(real_logits, dim=-1) * F.one_hot(
        real_labels.long(), num_classes), dim=1)
    xent_real = sparse_softmax_xent(real_logits, real_labels)
    loss_ac_d = ld1 * shard_mean((1.0 - p_true) ** ld_focal * xent_real)
    loss_ac_g = ld2 * shard_mean(sparse_softmax_xent(fake_logits,
                                                     fake_labels))
    return loss_ac_g, loss_ac_d


def wgan_sn_losses(fake_out, real_out):
    """``get_loss_wgan_sn`` (``graph_single.py:388-419``), the active loss;
    batch means (shares).  Returns (G, D)."""
    loss_g = shard_mean(F.softplus(-fake_out))
    loss_d = shard_mean(F.softplus(fake_out)) + shard_mean(
        F.softplus(-real_out))
    return loss_g, loss_d


def _input_slopes(disc_fn: Callable, interp):
    """|d sum(D(x)) / dx| per sample at ``interp``, kept differentiable
    (double backward) so the penalty trains D."""
    interp = interp.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(torch.sum(disc_fn(interp)), interp,
                                   create_graph=True)
    return torch.sqrt(torch.sum(torch.square(grads), dim=(1, 2, 3)))


def wgan_gp_losses(disc_fn: Callable, fake_out, real_out, fake_data,
                   real_data, alpha, ld=10.0):
    """``get_loss_wgan_global_gp`` (``graph_single.py:355-386``); ``alpha``
    [B, 1, 1, 1] uniform in [0, 1); batch means (shares).  Returns
    (G, D)."""
    loss_g = -shard_mean(fake_out)
    loss_d = shard_mean(fake_out) - shard_mean(real_out)
    interp = real_data + alpha * (fake_data - real_data)
    gp = shard_mean((_input_slopes(disc_fn, interp) - 1.0) ** 2)
    return loss_g, loss_d + ld * gp


def _global_var(x: torch.Tensor) -> torch.Tensor:
    """The variance of all elements of the global batch (two passes over
    'data': the mean, then the squared deviations)."""
    axis = data_axis()
    if axis is None:
        return torch.var(x, correction=0)
    count = x.numel() * axis[1]
    mean = global_sum(torch.sum(x)) / count
    return global_sum(torch.sum(torch.square(x - mean))) / count


def dragan_losses(disc_fn: Callable, fake_out, real_out, real_data,
                  perturb, alpha, ld=10.0):
    """``get_loss_original_gan_local_gp_one_side_multi``
    (``graph_single.py:421-465``): log GAN + one-sided local GP around
    perturbed real data; ``perturb`` [B, S, S, 3] and ``alpha``
    [B, 1, 1, 1] uniform in [0, 1).  Batch means (shares); the real data's
    standard deviation is the global batch's.  Returns (G, D)."""
    sum_dims = tuple(range(1, fake_out.ndim))
    ones, zeros = torch.ones_like(fake_out), torch.zeros_like(fake_out)
    loss_d_fake = shard_mean(torch.sum(sigmoid_xent_with_logits(
        fake_out, zeros), dim=sum_dims))
    loss_d_real = shard_mean(torch.sum(sigmoid_xent_with_logits(
        real_out, torch.ones_like(real_out)), dim=sum_dims))
    loss_g = shard_mean(torch.sum(sigmoid_xent_with_logits(fake_out, ones),
                                  dim=sum_dims))
    loss_d = (loss_d_fake + loss_d_real) / 2.0
    std = torch.sqrt(_global_var(real_data))
    perturbed = real_data + 0.5 * std * perturb
    interp = real_data + alpha * (perturbed - real_data)
    slopes = _input_slopes(disc_fn, interp)
    gp = shard_mean(torch.clamp_min(slopes - 1.0, 0.0) ** 2)
    return loss_g, loss_d + ld * gp


def fc_weight_decay_loss(params: Mapping[str, torch.Tensor],
                         rate: float = 1e-6) -> torch.Tensor:
    """TF-slim regularization (``mru.py:55-68``): only the dense layers'
    weight matrices carry an l2 regularizer, rate * sum(w^2) / 2.  Those
    are the 2-D leaves named ``weights`` (``SNDense``); conv kernels are
    4-D, and embeddings and the text LSTM's matrices have other names.
    Of the replicated weights: counted once over 'data'."""
    total = None
    for name, leaf in params.items():
        if name.rpartition(".")[2] == "weights" and leaf.ndim == 2:
            term = rate * 0.5 * torch.sum(torch.square(leaf))
            total = term if total is None else total + term
    if total is None:
        device = next(iter(params.values())).device
        return torch.zeros((), device=device)
    return count_once(total)


# ---------------------------------------------------------------- bg GAN

def masked_l1_loss(targets, outputs, labels):
    """L1 only on non-FG pixels (``bg_colorization_main.py:648-654``): the
    mean over the [K, C] rows of the pixels whose label is not 0.  The
    shard's sum over the global batch's count of such rows (a share)."""
    mask = (labels != 0).to(targets.dtype)[..., None]
    abs_diff = torch.abs(targets - outputs) * mask
    denom = torch.clamp_min(global_sum(torch.sum(mask)) * targets.shape[-1],
                            1.0)
    return torch.sum(abs_diff) / denom


def region_softmax_xent(region_logits, labels):
    """``bg_colorization_main.py:593-601``: mean sparse softmax xent (a
    share)."""
    logp = F.log_softmax(region_logits, dim=-1)
    return -shard_mean(torch.gather(logp, -1, labels[..., None].long()))


def bg_discrim_loss(predict_real, predict_fake, eps: float = 1e-12):
    """Non-saturating log D loss on sigmoid maps (bg main :637-641); a
    mean (a share)."""
    return shard_mean(-(torch.log(predict_real + eps)
                        + torch.log(1.0 - predict_fake + eps)))


def bg_gan_losses(predict_real, predict_fake, targets, outputs,
                  region_logits, labels, gan_weight=1.0, l1_weight=100.0,
                  seg_weight=100.0, eps=1e-12) -> Dict[str, torch.Tensor]:
    """The BG loss set (bg main :637-656), on sigmoid probabilities, hence
    ``log(p + eps)`` (``BCEWithLogits`` differs where the sigmoid
    saturates)."""
    discrim_loss = bg_discrim_loss(predict_real, predict_fake, eps)
    gen_loss_gan = shard_mean(-torch.log(predict_fake + eps))
    gen_loss_l1 = masked_l1_loss(targets, outputs, labels)
    region_loss = region_softmax_xent(region_logits, labels)
    gen_loss = (gen_loss_gan * gan_weight + gen_loss_l1 * l1_weight
                + region_loss * seg_weight)
    return {"discrim_loss": discrim_loss, "gen_loss_GAN": gen_loss_gan,
            "gen_loss_L1": gen_loss_l1, "region_mask_loss": region_loss,
            "gen_loss": gen_loss}
