"""Session factory (``sketchyscenecolorization_tpu/pipeline/factory.py``).

Vocabularies load from the configured paths when the files exist; otherwise
index-stable placeholders stand in (``factory.py:25-35``).  Parameters are
freshly initialised from ``seed`` with ``torch.Generator``s, one seed
stream per model.  Each model is restored from the newest snapshot that
the port's own trainer wrote (``utils/checkpoint.py``): the matching model
under ``match_ckpt_dir`` (``train_matching``), the FG and BG generators
under ``fg_ckpt_dir`` and ``bg_ckpt_dir`` (the ``snapshot`` directory of a
``train_fg_gan``/``train_bg_gan`` run; the discriminators and moments in
it are not read).  A missing or empty directory leaves the fresh
parameters, as in JAX.  A step directory without ``state.pt`` (an orbax
snapshot of the JAX package) raises: ``scripts/orbax_to_torch.py``
converts those (on the CPU, with JAX installed).  A JAX parameter tree can
be loaded into the built models with ``utils.bridge.load_jax_tree``.

Serving data parallelism (``serve_gan_data_parallel = n > 1``) gives the FG
engine the first n CUDA devices (``serve_devices_for``, JAX
``serve_mesh_for``); a host with fewer serves on one device, as JAX falls
back, with the same outputs.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ..config import FrameworkConfig
from ..models import bg_gan, fg_gan
from ..models.rmi import RMI
from ..ops.conv import apply_compute_dtype
from ..text import load_vocab
from ..utils.checkpoint import STATE_FILE, latest_checkpoint, restore_checkpoint
from .engines import BGColorizeEngine, FGColorizeEngine, MatchingEngine
from .session import ColorizationSession

# the BG generator's seed stream, apart from the matching model's (2 * seed)
# and the FG generator's (2 * seed + 1)
BG_SEED_OFFSET = 1 << 40


def _load_vocab_or_none(path: str) -> Optional[Dict[str, int]]:
    if path and os.path.isfile(path):
        return load_vocab(path)
    return None


def _placeholder_vocab(size: int) -> Dict[str, int]:
    """'<pad>', '<unk>', then opaque tokens."""
    words = ["<pad>", "<unk>"] + [f"w{i}" for i in range(size - 2)]
    return {w: i for i, w in enumerate(words)}


def _newest_snapshot(ckpt_dir: str):
    """(step, saved mapping) of the newest port snapshot under
    ``ckpt_dir``, or None."""
    found = latest_checkpoint(ckpt_dir) if ckpt_dir else None
    if found is None:
        return None
    if not os.path.isfile(os.path.join(found[1], STATE_FILE)):
        raise ValueError(
            f"{found[1]} has no {STATE_FILE}: if it is an orbax snapshot of "
            "the JAX package, convert it with scripts/orbax_to_torch.py")
    return found[0], restore_checkpoint(found[1], map_location="cpu")


def _restore(module: torch.nn.Module, ckpt_dir: str, key: str,
             trainer: str) -> Optional[int]:
    newest = _newest_snapshot(ckpt_dir)
    if newest is None:
        return None
    step, saved = newest
    if key not in saved:
        raise ValueError(f"the snapshot at step {step} under {ckpt_dir} "
                         f"holds no {key!r}: not a {trainer} snapshot")
    module.load_state_dict(saved[key])
    return step


def restore_matching(model: RMI, ckpt_dir: str) -> Optional[int]:
    """Load the newest ``train_matching`` snapshot under ``ckpt_dir`` into
    ``model``; returns its step, or None when there is none."""
    return _restore(model, ckpt_dir, "model", "train_matching")


def restore_generator(model: torch.nn.Module, ckpt_dir: str
                      ) -> Optional[int]:
    """Load the generator of the newest ``train_fg_gan``/``train_bg_gan``
    snapshot under ``ckpt_dir`` into ``model``; returns its step, or None
    when there is none."""
    return _restore(model, ckpt_dir, "generator", "GAN training")


def serve_devices_for(cfg: FrameworkConfig, device="cuda"):
    """The devices the FG engine splits its generator batches over (JAX
    ``factory.py:38-48``): the first ``serve_gan_data_parallel`` CUDA
    devices when it is above 1, ``device`` is a CUDA one and the host has
    that many; otherwise None, one device (JAX's fallback)."""
    n_dp = cfg.pipeline.serve_gan_data_parallel
    if n_dp > 1 and torch.device(device).type == "cuda" \
            and torch.cuda.device_count() >= n_dp:
        return [torch.device("cuda", i) for i in range(n_dp)]
    return None


def build_session(cfg: FrameworkConfig, seed: int = 0,
                  device="cuda") -> ColorizationSession:
    """Matching, FG and BG engines on ``device``, each model from its
    newest snapshot when there is one, else fresh."""
    apply_compute_dtype(cfg.matching, cfg.fg_gan, cfg.bg_gan)
    m_vocab = (_load_vocab_or_none(cfg.pipeline.match_vocab_path)
               or _placeholder_vocab(cfg.matching.vocab_size))
    f_vocab = (_load_vocab_or_none(cfg.pipeline.fg_vocab_path)
               or _placeholder_vocab(cfg.fg_gan.vocab_size))
    b_vocab = (_load_vocab_or_none(cfg.pipeline.bg_vocab_path)
               or _placeholder_vocab(cfg.bg_gan.vocab_size))
    rmi = RMI(cfg.matching, torch.Generator().manual_seed(2 * seed))
    restore_matching(rmi, cfg.pipeline.match_ckpt_dir)
    fgen = fg_gan.build_generator(
        cfg.fg_gan, torch.Generator().manual_seed(2 * seed + 1))
    restore_generator(fgen, cfg.pipeline.fg_ckpt_dir)
    bgen = bg_gan.build_generator(
        cfg.bg_gan, torch.Generator().manual_seed(BG_SEED_OFFSET + seed))
    restore_generator(bgen, cfg.pipeline.bg_ckpt_dir)
    return ColorizationSession(
        cfg,
        MatchingEngine(cfg.matching, rmi, m_vocab, cfg.pipeline.score_thresh,
                       device=device),
        FGColorizeEngine(cfg.fg_gan, fgen, f_vocab, seed=seed, device=device,
                         serve_devices=serve_devices_for(cfg, device)),
        BGColorizeEngine(cfg.bg_gan, bgen, b_vocab, device=device),
    )
