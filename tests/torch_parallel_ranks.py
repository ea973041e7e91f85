"""What the ranks of the multi-process tests run (``tests/test_torch_parallel*.py``).

These functions are started on spawned ranks by
``tests/torch_parallel_launch.py`` and run the port only:
this module imports torch, NumPy and the port, never ``jax`` or the JAX
package (``tests/test_torch_import.py`` holds it to that).  Each rank
writes what it computed to ``<out>/<name>_<rank>.pt``; the tests compare
those files with the JAX package and with single-process runs.  The
batch builders here are shared with the tests, so both sides build the
same seeded global batches.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch import parallel
from sketchyscenecolorization_torch.parallel import mesh as pmesh

MATCH_KW = dict(vf_h=6, vf_w=6, H=48, W=48, vf_dim=2048, vocab_size=12,
                w_emb_dim=16, v_emb_dim=16, m_rnn_size=8, w_rnn_size=16,
                max_len=5, lr_decay_step=100)
FUSIONS = {"default": {}, "attn": dict(use_attn=True),
           "recur": dict(fusion_type="RecurAttn")}
FG_KW = dict(batch_size=2, image_size=64, vocab_size=10, max_len=4,
             base_channels=4, noise_dim=8, max_iters=100)
FG_DRAGAN = dict(spectral_norm=False, disc_steps=2)
# WGAN-GP through the Pix2Pix discriminator's batch-stats BN: the penalty's
# second-order terms pass through the global moments' all-reduce
FG_PIX2PIX_GP = dict(block_type="Pix2Pix", spectral_norm=False, wgan=True)
BG_KW = dict(batch_size=2, image_size=64, vocab_size=8, max_len=4, ngf=4,
             ndf=4, multi_residual=False, max_steps=100)
MODEL_SEED = 0      # RMI(cfg, torch.Generator().manual_seed(MODEL_SEED))
FG_SEED, BG_SEED = 3, 5


def save(out, name, rank, value):
    torch.save(value, os.path.join(out, f"{name}_{rank}.pt"))


def load(out, name, rank):
    return torch.load(os.path.join(out, f"{name}_{rank}.pt"),
                      weights_only=False)


def tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def matching_batch(cfg, batch, seed=0):
    """``tests/test_train.py:_matching_batch`` with ``batch`` rows."""
    rng = np.random.RandomState(seed)
    img = rng.randn(batch, cfg.H, cfg.W, 3).astype(np.float32) * 50
    words = rng.randint(1, cfg.vocab_size,
                        (batch, cfg.max_len)).astype(np.int32)
    seq_len = np.array([2, 5, 3, 1][:batch], np.int32)
    target = (rng.rand(batch, cfg.H, cfg.W, 1) > 0.5).astype(np.float32)
    return {"image": img, "words": words, "seq_len": seq_len,
            "target_mask": target}


def fg_batch(cfg, seed):
    """``tests/test_train.py:_fg_batch`` as NumPy."""
    rng = np.random.RandomState(seed)
    s, b = cfg.image_size, cfg.batch_size
    return {
        "images": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "sketches": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "images_d": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "class_id": rng.randint(0, cfg.num_classes, (b,)).astype(np.int32),
        "class_id_d": rng.randint(0, cfg.num_classes, (b,)).astype(np.int32),
        "tokens": rng.randint(0, cfg.vocab_size,
                              (b, cfg.max_len)).astype(np.int32)}


def bg_batch(cfg, seed):
    """``tests/test_torch_train_bg_gan.py:_batch``."""
    rng = np.random.RandomState(seed)
    s, b = cfg.image_size, cfg.batch_size
    tokens = rng.randint(1, cfg.vocab_size, (b, cfg.max_len))
    tokens[0, :2] = 0
    return {"inputs": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
            "targets": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
            "tokens": tokens.astype(np.int32),
            "labels": rng.randint(0, 3, (b, s, s)).astype(np.int32)}


def rmi(fusion, shard=False):
    from sketchyscenecolorization_torch.models.rmi import RMI
    cfg = tconfig.MatchingConfig(**MATCH_KW, **FUSIONS[fusion],
                                 shard_mlstm_pixels=shard)
    return cfg, RMI(cfg, torch.Generator().manual_seed(MODEL_SEED))


def text_leaves(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n.startswith("text_sketchyscene.")}


# ------------------------------------------------------------ helpers, ops

def loss_inputs(seed=0):
    """Global batches of the loss checks: 4 rows (one a rank at data=4);
    the BG labels leave a different number of non-FG pixels in each row."""
    rng = np.random.RandomState(seed)
    b, s = 4, 6
    labels = rng.randint(0, 3, (b, s, s)).astype(np.int32)
    labels[1] = 0
    labels[2, :4] = 0
    return {
        "pred": rng.uniform(-2, 2, (b, s, s, 3)).astype(np.float32),
        "target": rng.uniform(-2, 2, (b, s, s, 3)).astype(np.float32),
        "fake_out": rng.randn(b, 3, 3, 1).astype(np.float32),
        "real_out": rng.randn(b, 3, 3, 1).astype(np.float32),
        "logits": rng.randn(b, 5).astype(np.float32),
        "labels5": rng.randint(0, 5, (b,)).astype(np.int32),
        "labels": labels,
        "region": rng.randn(b, s, s, 3).astype(np.float32),
        "p_real": rng.uniform(0.05, 0.95, (b, 3, 3, 1)).astype(np.float32),
        "p_fake": rng.uniform(0.05, 0.95, (b, 3, 3, 1)).astype(np.float32),
        "perturb": rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32),
        "alpha": rng.uniform(0, 1, (b, 1, 1, 1)).astype(np.float32),
    }


def disc_weight():
    return torch.from_numpy(np.random.RandomState(9).randn(6, 6, 3)
                            .astype(np.float32))


def loss_shares(batch):
    """Every loss of ``train/losses.py`` on ``batch`` (rows of
    ``loss_inputs``), and the gradients of some of them with respect to
    their inputs: a rank's shares under a mesh, the global losses
    without."""
    from sketchyscenecolorization_torch.train import losses as L
    t = tensors(batch)
    pred = t["pred"].requires_grad_(True)
    w = disc_weight()

    def disc_fn(x):
        return torch.sum(torch.tanh(x) * w, dim=(1, 2, 3))

    out = {
        "smooth_l1": L.smooth_l1(pred, t["target"]),
        "wgan_sn": L.wgan_sn_losses(t["fake_out"], t["real_out"]),
        "acgan": L.acgan_focal_loss(t["logits"], t["labels5"], t["logits"],
                                    t["labels5"], 5),
        "wgan_gp": L.wgan_gp_losses(disc_fn, t["fake_out"], t["real_out"],
                                    pred, t["target"], t["alpha"]),
        "dragan": L.dragan_losses(disc_fn, t["fake_out"], t["real_out"],
                                  t["target"], t["perturb"], t["alpha"]),
        "masked_l1": L.masked_l1_loss(t["target"], pred, t["labels"]),
        "region": L.region_softmax_xent(t["region"], t["labels"]),
        "bg": L.bg_gan_losses(t["p_real"], t["p_fake"], t["target"], pred,
                              t["region"], t["labels"]),
        "l2": L.l2_regularization_loss([w], 0.1),
        "fc_decay": L.fc_weight_decay_loss({"a.weights": w[0]}),
    }
    flat = {}
    for key, value in out.items():
        if isinstance(value, dict):
            flat.update({f"{key}/{k}": v for k, v in value.items()})
        elif isinstance(value, tuple):
            flat.update({f"{key}/{i}": v for i, v in enumerate(value)})
        else:
            flat[key] = value
    grads = {}
    for key in ("smooth_l1", "masked_l1", "bg/gen_loss"):
        (grads[key],) = torch.autograd.grad(flat[key], pred,
                                            retain_graph=True)
    return ({k: v.detach() for k, v in flat.items()}, grads)


def bn_inputs(seed=1):
    """8 rows of the norm checks."""
    rng = np.random.RandomState(seed)
    return {"x": (rng.randn(8, 5, 5, 3) * 2 + 1).astype(np.float32),
            "w": rng.randn(8, 5, 5, 3).astype(np.float32),
            "labels": rng.randint(0, 4, (8,)).astype(np.int64)}


def bn_run(batch):
    """Both batch-stats norms on ``batch`` (rows of ``bn_inputs``): their
    outputs, and the gradients of sum(y * w) with respect to x, offset
    and scale (per-class tables of 4 classes)."""
    from sketchyscenecolorization_torch.ops.norm import (
        batch_stats_norm, conditional_batch_stats_norm)
    t = tensors(batch)
    rng = np.random.RandomState(2)
    tables = tensors({"offset": rng.randn(4, 3).astype(np.float32),
                      "scale": rng.uniform(0.5, 1.5, (4, 3))
                      .astype(np.float32)})
    out = {}
    for name in ("plain", "cond"):
        x = t["x"].clone().requires_grad_(True)
        offset = tables["offset"].clone().requires_grad_(True)
        scale = tables["scale"].clone().requires_grad_(True)
        if name == "plain":
            y = batch_stats_norm(x, offset[0], scale[0])
        else:
            y = conditional_batch_stats_norm(x, t["labels"], offset, scale)
        gx, go, gs = torch.autograd.grad(torch.sum(y * t["w"]),
                                         (x, offset, scale))
        out[name] = {"y": y.detach(), "x": gx, "offset": go, "scale": gs}
    return out


def mesh_and_ops(rank, out):
    """World 4: the mesh helpers, the global-batch norms and the losses'
    shares at data=4, and the broadcast batches."""
    res = {}
    mesh = parallel.create_mesh(data=4)
    grid = parallel.create_mesh(data=2, model=2)
    res["sizes"] = [(pmesh.data_size(m), m.size(1), pmesh.data_index(m),
                     m.get_local_rank("model"), parallel.local_batch_size(8, m))
                    for m in (mesh, grid)]
    errors = {}
    for name, call in (("too_many", lambda: parallel.create_mesh(data=8)),
                       ("indivisible", lambda: parallel.create_mesh(model=3)),
                       ("subset", lambda: parallel.create_mesh(data=2)),
                       ("batch", lambda: parallel.local_batch_size(7, mesh))):
        try:
            call()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    res["errors"] = errors
    res["rows"] = parallel.shard_batch(
        {"x": np.arange(24).reshape(8, 3)}, grid)["x"]

    torch.manual_seed(rank)
    module = torch.nn.Linear(3, 2)
    module.register_buffer("count", torch.tensor([rank], dtype=torch.int64))
    parallel.replicate(module, mesh)
    res["replicated"] = {k: v.clone() for k, v in module.state_dict().items()}
    grads = {"a": torch.full((2, 3), float(rank + 1)),
             "b": torch.arange(4.0) * (rank + 1)}
    res["reduced"] = parallel.reduce_gradients(grads, grid)
    res["metrics"] = parallel.reduce_metrics(
        {"loss": torch.tensor(float(rank + 1)), "lr": 0.5}, ["loss"], mesh)

    with parallel.set_mesh(mesh):
        res["losses"] = loss_shares(parallel.shard_batch(loss_inputs(), mesh))
        res["bn"] = bn_run(parallel.shard_batch(bn_inputs(), mesh))
    # serving's per-sample statistics take no collective under a mesh
    from sketchyscenecolorization_torch.ops.norm import batch_stats_norm
    x = tensors(bn_inputs())["x"]
    with parallel.set_mesh(mesh):
        res["per_sample"] = batch_stats_norm(
            x, torch.zeros(3), torch.ones(3), per_sample=True)

    def make_batch(step):
        if step == 3:
            raise RuntimeError(f"batch {step} failed on rank {rank}")
        return {"x": np.full((4, 2), 10 * step + dist.get_rank(),
                             np.float32)}
    seen, error = [], None
    gen = parallel.mesh_batches(make_batch, 4, mesh, num_workers=1)
    try:
        for batch in parallel.prefetch_to_device(gen, "cpu", mesh=mesh):
            seen.append(batch["x"].clone())
    except RuntimeError as e:
        error = str(e)
    finally:
        gen.close()
    res["batches"], res["batch_error"] = seen, error
    save(out, "mesh", rank, res)


# ------------------------------------------------------------- matching

def matching_dp(rank, out):
    """World 4.  At data=4: two data-parallel train steps of the default
    fusion on the global batch of 4.  On the 2x2 mesh: the pixel-sharded
    forward of each fusion, two train steps of the default fusion and one
    of each variant."""
    from sketchyscenecolorization_torch.train import (create_matching_state,
                                                      make_matching_train_step)
    res = {}
    mesh = parallel.create_mesh(data=4)
    grid = parallel.create_mesh(data=2, model=2)
    cfg, model = rmi("default")
    state = create_matching_state(model, cfg)
    step = make_matching_train_step(cfg, mesh)
    batch = tensors(parallel.shard_batch(matching_batch(cfg, 4), mesh))
    res["dp"] = []
    for _ in range(2):
        state, metrics = step(state, batch)
        res["dp"].append({"metrics": metrics, "text": text_leaves(model)})

    res["tp_up"] = {}
    for fusion in FUSIONS:
        cfg, model = rmi(fusion, shard=True)
        batch = tensors(parallel.shard_batch(matching_batch(cfg, 4), grid))
        with torch.no_grad(), parallel.set_mesh(grid):
            res["tp_up"][fusion] = model(batch["image"], batch["words"].long(),
                                         batch["seq_len"]).up
        state = create_matching_state(model, cfg)
        step = make_matching_train_step(cfg, grid)
        steps = []
        for _ in range(2 if fusion == "default" else 1):
            state, metrics = step(state, batch)
            steps.append({"metrics": metrics, "text": text_leaves(model)})
        res[f"tp_{fusion}"] = steps
    save(out, "matching", rank, res)


def matching_model2(rank, out):
    """World 2, data=1, model=2: the pixel-sharded forward of each fusion
    on the whole batch, and without a mesh the refusal."""
    res = {}
    mesh = parallel.create_mesh(data=1, model=2)
    for fusion in FUSIONS:
        cfg, model = rmi(fusion, shard=True)
        batch = tensors(matching_batch(cfg, 4))
        args = (batch["image"], batch["words"].long(), batch["seq_len"])
        with torch.no_grad(), parallel.set_mesh(mesh):
            res[fusion] = model(*args).up
    try:
        with torch.no_grad():
            model(*args)
        res["no_mesh"] = None
    except ValueError as e:
        res["no_mesh"] = str(e)
    save(out, "model2", rank, res)


# ---------------------------------------------------------------- GANs

def _gan_state(state):
    return {"g": {k: v.clone() for k, v in
                  state.generator.state_dict().items()},
            "d": {k: v.clone() for k, v in
                  state.discriminator.state_dict().items()},
            "mu_g": {k: v.clone() for k, v in state.g_opt.mu.items()},
            "mu_d": {k: v.clone() for k, v in state.d_opt.mu.items()}}


def gan_dp(rank, out, fg_draws):
    """World 2, data=2: two FG steps at the default config on JAX's draws
    (``fg_draws``, global), two DRAGAN FG steps and two Pix2Pix WGAN-GP FG
    steps on the step's own draws, two BG steps; the state after each
    step."""
    from sketchyscenecolorization_torch.train import (
        create_bg_gan_state, create_fg_gan_state, make_bg_gan_train_step,
        make_fg_gan_train_step)
    mesh = parallel.create_mesh(data=2)
    res = {}
    for name, kw in (("fg", {}), ("dragan", FG_DRAGAN),
                     ("pix2pix_gp", FG_PIX2PIX_GP)):
        cfg = tconfig.FGGanConfig(**FG_KW, **kw)
        state = create_fg_gan_state(cfg, seed=FG_SEED, device="cpu")
        step = make_fg_gan_train_step(cfg, seed=FG_SEED, mesh=mesh)
        res[name] = []
        for i in range(2):
            bd, bg = (tensors(parallel.shard_batch(fg_batch(cfg, 2 * i + j),
                                                   mesh)) for j in (0, 1))
            state, metrics = step(state, bd, bg,
                                  draws=fg_draws[i] if name == "fg" else None)
            res[name].append({"metrics": metrics, **_gan_state(state)})
    cfg = tconfig.BGGanConfig(**BG_KW)
    state = create_bg_gan_state(cfg, seed=BG_SEED, device="cpu")
    step = make_bg_gan_train_step(cfg, mesh)
    res["bg"] = []
    for i in range(2):
        state, metrics = step(state, tensors(parallel.shard_batch(
            bg_batch(cfg, i), mesh)))
        res["bg"].append({"metrics": metrics, **_gan_state(state)})
    save(out, "gan", rank, res)


def fg_harness(rank, out, shard, run_dir):
    """World 2: ``train_fg_gan`` on a mesh for 2 steps, then resumed to 3;
    each rank counts the snapshots it wrote."""
    from sketchyscenecolorization_torch.data import FGPairedDataset
    from sketchyscenecolorization_torch.train import harness
    cfg = tconfig.FGGanConfig(batch_size=2, image_size=32, vocab_size=10,
                              max_len=4, base_channels=4, noise_dim=8,
                              max_iters=3, snapshot_interval=1)
    written = []
    save_checkpoint = harness.save_checkpoint

    def counting(ckpt_dir, step, state, **kw):
        written.append(step)
        return save_checkpoint(ckpt_dir, step, state, **kw)
    harness.save_checkpoint = counting
    mesh = parallel.create_mesh(data=2)
    status = []
    for max_iters in (2, 3):
        ds = FGPairedDataset([shard], cfg.batch_size, cfg.image_size, seed=0)
        status.append(harness.train_fg_gan(cfg, ds, run_dir, log_every=1,
                                           max_iters=max_iters, device="cpu",
                                           mesh=mesh))
    save(out, "harness", rank, {"status": status, "written": written})


def no_jax(rank, out):
    """World 2: one data-parallel FG step and a pixel-sharded forward,
    then the modules of ``jax``, ``flax`` or the JAX package this rank
    holds (none)."""
    import sys
    from sketchyscenecolorization_torch.train import (create_fg_gan_state,
                                                      make_fg_gan_train_step)
    mesh = parallel.create_mesh(data=1, model=2)
    cfg, model = rmi("default", shard=True)
    batch = tensors(matching_batch(cfg, 1))
    with torch.no_grad(), parallel.set_mesh(mesh):
        model(batch["image"], batch["words"].long(), batch["seq_len"])
    mesh = parallel.create_mesh(data=2)
    cfg = tconfig.FGGanConfig(**FG_KW)
    state = create_fg_gan_state(cfg, device="cpu")
    make_fg_gan_train_step(cfg, mesh=mesh)(
        state, *(tensors(parallel.shard_batch(fg_batch(cfg, j), mesh))
                 for j in (0, 1)))
    save(out, "no_jax", rank, sorted(
        m for m in sys.modules if m.split(".")[0] in
        ("jax", "flax", "sketchyscenecolorization_tpu")))
