"""BG colorization CLI of the port (``sketchyscenecolorization_tpu/cli_bg_gan.py``;
reference ``Background_Colorization/bg_colorization_main.py:703-1032``):

    python -m sketchyscenecolorization_torch.cli_bg_gan --mode train \\
        --data_base_dir <d> --run_dir <run> [--device cpu]
    python -m sketchyscenecolorization_torch.cli_bg_gan --mode test \\
        --data_base_dir <d> --run_dir <run> [--device cpu]

Reads ``<d>/captions/<split>.json`` ({fg_name, bg_name, color_text}
entries) and the PNGs under ``<d>/foreground/<split>``,
``<d>/background/<split>`` and ``<d>/segment/<split>``.  ``train`` resumes
from the newest snapshot under ``<run>/snapshot``; ``test`` restores its
generator and writes input/output/target triplets to
``<run>/test_results``.
"""
from __future__ import annotations

import argparse
import os

from .config import BGGanConfig


def make_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test"])
    p.add_argument("--data_base_dir", type=str, default="data")
    p.add_argument("--run_dir", type=str, default="outputs/bg_gan")
    p.add_argument("--vocab_path", type=str, default="data/bg_vocab.txt")
    p.add_argument("--image_size", type=int, default=768)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--vocab_size", type=int, default=18)
    p.add_argument("--max_len", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the models")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    cfg = BGGanConfig(batch_size=args.batch_size, image_size=args.image_size,
                      vocab_size=args.vocab_size, max_len=args.max_len,
                      lr=args.lr, max_steps=args.max_steps)
    from .ops.conv import apply_compute_dtype
    apply_compute_dtype(cfg)

    from .data import BGDataset
    from .text import load_vocab
    vocab = load_vocab(args.vocab_path)
    split = "train" if args.mode == "train" else "test"
    dataset = BGDataset(
        os.path.join(args.data_base_dir, "captions", f"{split}.json"),
        os.path.join(args.data_base_dir, "foreground", split),
        os.path.join(args.data_base_dir, "background", split),
        os.path.join(args.data_base_dir, "segment", split),
        vocab, image_size=cfg.image_size, max_len=cfg.max_len,
        seed=args.seed)

    if args.mode == "train":
        from .train import train_bg_gan
        train_bg_gan(cfg, dataset, args.run_dir, seed=args.seed,
                     device=args.device)
        return 0

    from .pipeline.engines import BGColorizeEngine
    from .pipeline.factory import restore_generator
    from .train.bg_gan import build_models
    from .train.eval_procedures import bg_test
    gen, _ = build_models(cfg, args.seed)
    step = restore_generator(gen, os.path.join(args.run_dir, "snapshot"))
    if step is not None:
        print(f"restored step {step}")
    engine = BGColorizeEngine(cfg, gen, vocab, device=args.device)
    n = bg_test(cfg, engine, dataset,
                os.path.join(args.run_dir, "test_results"))
    print(f"wrote {n} triplets")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
