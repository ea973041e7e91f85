"""FG instance-colorization CLI of the port (``sketchyscenecolorization_tpu/cli_fg_gan.py``;
reference ``Foreground_Instance_Colorization/obj_colorization_main.py``):

    python -m sketchyscenecolorization_torch.cli_fg_gan --mode train \\
        --data_base_dir <d> [--resume_from <run>] [--device cpu]
    python -m sketchyscenecolorization_torch.cli_fg_gan --mode val \\
        --resume_from <run> --data_base_dir <d> [--device cpu]

``train`` reads the record shards ``<d>/records/train/*.npz``, writes a
timestamped run directory under ``--output_base_dir`` (or resumes
``--resume_from``) with ``params.json``, ``metrics.jsonl`` and
``snapshot/step_N/state.pt``, and relaunches from the newest snapshot
after a NaN loss.  ``val`` (shards ``<d>/records/val``), ``test``
(``<d>/captions/<category>/test.json``, ``<d>/images/<category>/sketch``,
``<d>/vocab.txt``) and ``inference`` (``examples/<image_name>`` with
``--instruction``) restore the generator of the newest snapshot of
``--resume_from`` and write PNGs under it.  ``--block_type`` picks the MRU
generator and discriminator (the default) or the Pix2Pix or Residual
variant.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from .config import FGGanConfig


def make_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "val", "test", "inference"])
    p.add_argument("--data_base_dir", type=str, default="data")
    p.add_argument("--output_base_dir", type=str, default="outputs")
    p.add_argument("--resume_from", type=str, default="",
                   help="existing run dir to resume")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--max_iter_step", type=int, default=100000)
    p.add_argument("--lr_G", type=float, default=2e-4)
    p.add_argument("--lr_D", type=float, default=1e-4)
    p.add_argument("--block_type", type=str, default="MRU",
                   choices=["MRU", "Pix2Pix", "Residual"])
    p.add_argument("--vocab_size", type=int, default=58)
    p.add_argument("--small_img", type=int, default=0)
    p.add_argument("--distance_map", type=int, default=0)
    p.add_argument("--ld", type=float, default=10.0)
    p.add_argument("--image_name", type=str, default="")
    p.add_argument("--instruction", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the models")
    return p


def build_config(args) -> FGGanConfig:
    return FGGanConfig(
        batch_size=args.batch_size, image_size=64 if args.small_img else 192,
        small=bool(args.small_img), vocab_size=args.vocab_size,
        block_type=args.block_type, lr_g=args.lr_G, lr_d=args.lr_D,
        max_iters=args.max_iter_step, ld=args.ld,
        distance_map=bool(args.distance_map))


def _shards(data_base_dir: str, split: str):
    shard_dir = os.path.join(data_base_dir, "records", split)
    return [os.path.join(shard_dir, n) for n in sorted(os.listdir(shard_dir))]


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    cfg = build_config(args)
    from .ops.conv import apply_compute_dtype
    apply_compute_dtype(cfg)

    if args.mode == "train":
        from .data import FGPairedDataset
        from .train import run_with_nan_restart, train_fg_gan
        run_dir = args.resume_from or os.path.join(
            args.output_base_dir, time.strftime("%Y-%m-%d-%H-%M-%S"))
        os.makedirs(run_dir, exist_ok=True)
        # per-run params JSON (reference obj_colorization_main.py:36-72)
        with open(os.path.join(run_dir, "params.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2)
        dataset = FGPairedDataset(_shards(args.data_base_dir, "train"),
                                  cfg.batch_size, cfg.image_size,
                                  cfg.distance_map, seed=args.seed)
        return run_with_nan_restart(
            lambda: train_fg_gan(cfg, dataset, run_dir, seed=args.seed,
                                 device=args.device))

    # val / test / inference restore the generator of a run
    from .pipeline.factory import restore_generator
    from .train.fg_gan import build_models
    run_dir = args.resume_from
    if not run_dir:
        raise SystemExit(f"--mode {args.mode} needs --resume_from <run_dir>")
    gen, _ = build_models(cfg, args.seed)
    step = restore_generator(gen, os.path.join(run_dir, "snapshot"))
    if step is not None:
        print(f"restored step {step}")

    if args.mode == "val":
        from .train.eval_procedures import fg_validation
        n = fg_validation(cfg, gen, _shards(args.data_base_dir, "val"),
                          os.path.join(run_dir, "results"),
                          device=args.device)
        print(f"wrote {n} triplets")
        return 0

    from .text import load_vocab
    vocab = load_vocab(os.path.join(args.data_base_dir, "vocab.txt"))
    if args.mode == "test":
        from .train.eval_procedures import fg_test
        n = fg_test(cfg, gen, args.data_base_dir,
                    os.path.join(run_dir, "test_results"), vocab,
                    seed=args.seed, device=args.device)
        print(f"wrote {n} outputs")
        return 0

    if not (args.image_name and args.instruction):
        raise SystemExit("--mode inference needs --image_name and "
                         "--instruction")
    from .train.eval_procedures import fg_inference
    cap_base = os.path.join(args.data_base_dir, "captions")
    categories = sorted(d for d in os.listdir(cap_base)
                        if os.path.isdir(os.path.join(cap_base, d)))
    out = fg_inference(cfg, gen, os.path.join("examples", args.image_name),
                       args.image_name[:args.image_name.find(".png")],
                       categories, args.instruction, vocab,
                       os.path.join(run_dir, "results"), seed=args.seed,
                       device=args.device)
    print("saved:", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
