"""Interactive CLI of the port (``sketchyscenecolorization_tpu/cli.py``;
reference ``sketchyscene_colorization_main.py``).

Usage:
    python -m sketchyscenecolorization_torch.cli \
        --command color --image_id 9996 --instruction "the bus is yellow"
    python -m sketchyscenecolorization_torch.cli \
        --command color --image_id 9996 --instruction "the sky is blue"
    python -m sketchyscenecolorization_torch.cli --command color \
        --image_id 9996 --instructions "the bus is yellow; the sky is blue"
    python -m sketchyscenecolorization_torch.cli --command withdraw --image_id 9996

``python -m sketchyscenecolorization_torch`` runs the same CLI.  The session
runs the default ``PipelineConfig``: device compositing, compact fetch and
the device sky gradient.  ``--instructions`` serves a ';'-separated queue
through ``colorize_stream``.

Each model is restored from the newest snapshot of the port's trainers
under ``--match_ckpt_dir``, ``--fg_ckpt_dir`` and ``--bg_ckpt_dir`` when
there is one, else starts from fresh parameters seeded by ``--seed``
(``pipeline/factory.py``).  ``build_session`` sets the f32 policy.
"""
from __future__ import annotations

import argparse
import dataclasses

from .config import FrameworkConfig, PipelineConfig


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Language-based scene-sketch colorization (PyTorch)")
    p.add_argument("--command", "-c", type=str, choices=["color", "withdraw"],
                   default="color")
    p.add_argument("--image_id", "-id", type=int, default=-1)
    p.add_argument("--instruction", "-it", type=str, default="")
    p.add_argument("--instructions", type=str, default="",
                   help="';'-separated queue served via colorize_stream: "
                        "consecutive FG instructions share one matching "
                        "forward and one generator batch (same outputs and "
                        "records as issuing them one by one)")
    p.add_argument("--data_base_dir", "-dbd", type=str, default="examples")
    p.add_argument("--results_base_dir", "-rbd", type=str, default="outputs")
    p.add_argument("--match_ckpt_dir", type=str, default="checkpoints/matching")
    p.add_argument("--match_vocab_path", type=str, default="data/match_vocab.txt")
    p.add_argument("--fg_ckpt_dir", type=str, default="checkpoints/fg_gan")
    p.add_argument("--fg_vocab_path", type=str, default="data/fg_vocab.txt")
    p.add_argument("--bg_ckpt_dir", type=str, default="checkpoints/bg_gan")
    p.add_argument("--bg_vocab_path", type=str, default="data/bg_vocab.txt")
    p.add_argument("--no_color_gradient", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the models")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.image_id == -1:
        raise SystemExit("--image_id is required")

    if args.command == "withdraw":
        from .data.records import withdraw_records
        withdraw_records(args.image_id, args.results_base_dir)
        print("withdrew last record for image", args.image_id)
        return 0

    if not args.instruction and not args.instructions:
        raise SystemExit("--instruction (or --instructions) is required for "
                         "the color command")

    from .pipeline.factory import build_session
    cfg = dataclasses.replace(FrameworkConfig(), pipeline=PipelineConfig(
        data_base_dir=args.data_base_dir,
        results_base_dir=args.results_base_dir,
        match_vocab_path=args.match_vocab_path,
        fg_vocab_path=args.fg_vocab_path,
        bg_vocab_path=args.bg_vocab_path,
        match_ckpt_dir=args.match_ckpt_dir,
        fg_ckpt_dir=args.fg_ckpt_dir,
        bg_ckpt_dir=args.bg_ckpt_dir,
        color_gradient=not args.no_color_gradient,
    ))
    session = build_session(cfg, seed=args.seed, device=args.device)
    if args.instructions:
        texts = [t.strip() for t in args.instructions.split(";") if t.strip()]
        out_paths = session.colorize_stream(args.image_id, texts)
    else:
        out_paths = [session.colorize(args.image_id, args.instruction)]
    session.flush()     # the records already point at these PNGs
    for out_path in out_paths:
        print("saved:", out_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
