"""Train-to-learn evidence for the port's GAN trainers (RUN_SLOW): the
mirrors of ``tests/test_overfit.py:79,113``.  The FG stack (WGAN-SN,
ACGAN focal, smooth-L1, the spectral-norm commits, conditional batch-stats
BN) drives the reconstruction of one batch below 0.75x its first value in
200 steps, and the BG stack (log GAN, masked L1, region xent, EMA) the
masked L1 below 0.55x, at the shapes of the JAX tests, on the CPU."""
import os
import time

import numpy as np
import pytest
import torch

from sketchyscenecolorization_torch.config import BGGanConfig, FGGanConfig
from sketchyscenecolorization_torch.train import (create_bg_gan_state,
                                                  create_fg_gan_state,
                                                  make_bg_gan_train_step,
                                                  make_fg_gan_train_step)

pytestmark = pytest.mark.skipif(
    os.environ.get("RUN_SLOW") != "1",
    reason="overfit-one-batch convergence runs (set RUN_SLOW=1)")


def test_fg_gan_overfits_reconstruction():
    cfg = FGGanConfig(batch_size=2, image_size=64, vocab_size=10, max_len=4,
                      base_channels=8, noise_dim=8, max_iters=2000)
    state = create_fg_gan_state(cfg, device="cpu")
    step = make_fg_gan_train_step(cfg, seed=1)
    rng = np.random.RandomState(0)
    s, b = cfg.image_size, cfg.batch_size
    batch = {
        "images": rng.uniform(-1, 1, (b, s, s, 3)),
        "sketches": rng.uniform(-1, 1, (b, s, s, 3)),
        "images_d": rng.uniform(-1, 1, (b, s, s, 3)),
        "class_id": rng.randint(0, 25, (b,)),
        "class_id_d": rng.randint(0, 25, (b,)),
        "tokens": rng.randint(0, 10, (b, 4)),
    }
    batch = {k: torch.from_numpy(v.astype(np.float32 if v.dtype == np.float64
                                          else np.int64))
             for k, v in batch.items()}
    t0 = time.perf_counter()
    state, m = step(state, batch, batch)
    recon0 = float(m["recon_l1"])
    for _ in range(200):
        state, m = step(state, batch, batch)
        assert not bool(m["nan"])
    recon = float(m["recon_l1"])
    print(f"fg overfit: recon {recon0:.4f}->{recon:.4f} "
          f"({recon / recon0:.2f}x) in {time.perf_counter() - t0:.0f}s")
    assert recon < 0.75 * recon0


def test_bg_gan_overfits_reconstruction():
    cfg = BGGanConfig(batch_size=1, image_size=64, vocab_size=8, max_len=4,
                      ngf=8, ndf=8, multi_residual=False, max_steps=2000)
    state = create_bg_gan_state(cfg, device="cpu")
    step = make_bg_gan_train_step(cfg)
    rng = np.random.RandomState(0)
    s = cfg.image_size
    batch = {
        "inputs": torch.from_numpy(rng.uniform(-1, 1, (1, s, s, 3))
                                   .astype(np.float32)),
        "targets": torch.from_numpy(rng.uniform(-1, 1, (1, s, s, 3))
                                    .astype(np.float32)),
        "tokens": torch.from_numpy(rng.randint(0, 8, (1, 4))),
        "labels": torch.from_numpy(rng.randint(0, 3, (1, s, s))),
    }
    t0 = time.perf_counter()
    state, m = step(state, batch)
    l1_0 = float(m["gen_loss_L1"])
    for _ in range(200):
        state, m = step(state, batch)
    l1 = float(m["gen_loss_L1"])
    print(f"bg overfit: L1 {l1_0:.4f}->{l1:.4f} "
          f"({l1 / l1_0:.2f}x) in {time.perf_counter() - t0:.0f}s")
    assert l1 < 0.55 * l1_0
