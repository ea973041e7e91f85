"""Train-to-learn evidence for the port's trainers (RUN_SLOW): the
mirrors of ``tests/test_overfit.py:39,79,113``.  The matching stack (the
frozen backbone, the ignore-background loss, poly LR, Adam with the
biases' doubled rate, B1/B2's plain versions on the CPU) drives one
caption's mask to IoU > 0.9 in 600 steps from the JAX test's initial
parameters, bridged (measured 0.908, loss 0.13x; from the port's own
seed-0 parameters it reaches 0.809 and 0.23x, from seed 1 0.910 and
0.11x: the bound sits on an init-dependent trajectory).  The FG stack (WGAN-SN,
ACGAN focal, smooth-L1, the spectral-norm commits, conditional batch-stats
BN) drives the reconstruction of one batch below 0.75x its first value in
200 steps, and the BG stack (log GAN, masked L1, region xent, EMA) the
masked L1 below 0.55x, at the shapes of the JAX tests, on the CPU."""
import os
import time

import numpy as np
import pytest
import torch

from sketchyscenecolorization_torch.config import (BGGanConfig, FGGanConfig,
                                                   MatchingConfig)
from sketchyscenecolorization_torch.models.rmi import RMI
from sketchyscenecolorization_torch.utils.bridge import load_jax_tree
from sketchyscenecolorization_torch.train import (create_bg_gan_state,
                                                  create_fg_gan_state,
                                                  create_matching_state,
                                                  make_bg_gan_train_step,
                                                  make_fg_gan_train_step,
                                                  make_matching_train_step)

pytestmark = pytest.mark.skipif(
    os.environ.get("RUN_SLOW") != "1",
    reason="overfit-one-batch convergence runs (set RUN_SLOW=1)")


def test_matching_overfits_one_caption_to_high_iou():
    """600 steps on one (sketch, caption, mask) triple reach IoU > 0.9 and
    cut the loss below 0.2x (JAX: IoU 0.911 at step 600), from the JAX
    test's initial parameters (``init_params(PRNGKey(0))``)."""
    import jax
    from sketchyscenecolorization_tpu.config import MatchingConfig as JCfg
    from sketchyscenecolorization_tpu.models import rmi as j_rmi
    kw = dict(vf_h=12, vf_w=12, H=96, W=96, vocab_size=12, w_emb_dim=16,
              v_emb_dim=16, m_rnn_size=16, w_rnn_size=16, max_len=5,
              lr_decay_step=4000, max_iters=4000)
    cfg = MatchingConfig(**kw)
    params = jax.jit(lambda k: j_rmi.init_params(k, JCfg(**kw)))(
        jax.random.PRNGKey(0))
    state = create_matching_state(
        load_jax_tree(RMI(cfg), jax.tree.map(np.asarray, params)), cfg)
    step = make_matching_train_step(cfg)
    rng = np.random.RandomState(0)
    target = np.zeros((1, 96, 96, 1), np.float32)
    target[0, 20:70, 30:80, 0] = 1
    batch = {
        "image": torch.from_numpy(rng.randn(1, 96, 96, 3).astype(np.float32)
                                  * 50),
        "words": torch.from_numpy(rng.randint(1, 12, (1, 5))
                                  .astype(np.int32)),
        "seq_len": torch.tensor([3], dtype=torch.int32),
        "target_mask": torch.from_numpy(target)}
    t0 = time.perf_counter()
    state, m0 = step(state, batch)
    for _ in range(600):
        state, m = step(state, batch)
    with torch.no_grad():
        up = state.model.eval()(batch["image"], batch["words"].long(),
                                batch["seq_len"].long()).up
    pred = up.numpy()[..., 0] >= 0            # sigmoid > 0.5 <=> up >= 0
    gt = target[..., 0] > 0.5
    iou = (pred & gt).sum() / max((pred | gt).sum(), 1)
    print(f"matching overfit: iou={iou:.3f} cls "
          f"{float(m0['cls_loss']):.0f}->{float(m['cls_loss']):.0f} in "
          f"{time.perf_counter() - t0:.0f}s")
    assert iou > 0.9
    assert float(m["cls_loss"]) < 0.2 * float(m0["cls_loss"])


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
