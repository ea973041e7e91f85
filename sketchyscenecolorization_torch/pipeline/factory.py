"""Session factory (``sketchyscenecolorization_tpu/pipeline/factory.py``).

Vocabularies load from the configured paths when the files exist; otherwise
index-stable placeholders stand in (``factory.py:25-35``).  Parameters are
freshly initialised from ``seed`` with ``torch.Generator``s, one seed
stream per model.  The matching model is restored from the newest snapshot
that the port's own trainer wrote under ``match_ckpt_dir``
(``utils/checkpoint.py``); a missing or empty directory leaves the fresh
parameters, as in JAX.  A snapshot the port cannot read raises: an orbax
one of the JAX package (ROADMAP A12), or any under ``fg_ckpt_dir`` or
``bg_ckpt_dir``, since no trainer of the port writes those yet (A9).  A JAX
parameter tree can be loaded into the built models with
``utils.bridge.load_jax_tree``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ..config import FrameworkConfig
from ..models import bg_gan, fg_gan
from ..models.rmi import RMI
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


def _refuse_gan_snapshots(cfg: FrameworkConfig) -> None:
    for name in ("fg_ckpt_dir", "bg_ckpt_dir"):
        ckpt_dir = getattr(cfg.pipeline, name)
        found = latest_checkpoint(ckpt_dir) if ckpt_dir else None
        if found is not None:
            raise NotImplementedError(
                f"{name} holds a snapshot ({found[1]}): restoring GAN weights "
                "comes with GAN training, ROADMAP item A9")


def restore_matching(model: RMI, ckpt_dir: str) -> Optional[int]:
    """Load the newest ``train_matching`` snapshot under ``ckpt_dir`` into
    ``model``; returns its step, or None when there is none."""
    found = latest_checkpoint(ckpt_dir) if ckpt_dir else None
    if found is None:
        return None
    if not os.path.isfile(os.path.join(found[1], STATE_FILE)):
        raise NotImplementedError(
            f"{found[1]} has no {STATE_FILE}: reading the JAX package's orbax "
            "snapshots is ROADMAP item A12")
    model.load_state_dict(
        restore_checkpoint(found[1], map_location="cpu")["model"])
    return found[0]


def build_session(cfg: FrameworkConfig, seed: int = 0,
                  device="cuda") -> ColorizationSession:
    """Matching, FG and BG engines on ``device``: the matching model from
    its newest snapshot, when there is one, the rest fresh."""
    _refuse_gan_snapshots(cfg)
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
    bgen = bg_gan.build_generator(
        cfg.bg_gan, torch.Generator().manual_seed(BG_SEED_OFFSET + seed))
    return ColorizationSession(
        cfg,
        MatchingEngine(cfg.matching, rmi, m_vocab, cfg.pipeline.score_thresh,
                       device=device),
        FGColorizeEngine(cfg.fg_gan, fgen, f_vocab, seed=seed, device=device),
        BGColorizeEngine(cfg.bg_gan, bgen, b_vocab, device=device),
    )
