"""Instance-matching CLI of the port (``sketchyscenecolorization_tpu/cli_matching.py``;
reference ``Instance_Matching/matching_main.py``):

    python -m sketchyscenecolorization_torch.cli_matching --mode train \\
        --data_base_dir data --captions_base_dir data \\
        --vocab_path data/match_vocab.txt [--device cpu]
    python -m sketchyscenecolorization_torch.cli_matching --mode eval \\
        --dataset val [--no_mask_ap] [--device cpu]
    python -m sketchyscenecolorization_torch.cli_matching --mode inference \\
        --dataset val --image_id 9996 --instruction "the bus" [--device cpu]

Training starts from fresh parameters seeded by ``--seed`` and resumes
from the newest snapshot under ``<run_dir>/snapshots``.  Evaluation and
inference restore that snapshot (fresh parameters when there is none).
Evaluation scores every caption of
``<captions_base_dir>/sentence_instance_<dataset>.json`` on
``<data_base_dir>/<dataset>`` (cumulative IoU, precision@0.5-0.9 and,
unless ``--no_mask_ap``, the instance mAP over
``<seg_data_base_dir>/<dataset>/seg_data``) and appends the summary to
``<run_dir>/eval_results/<backbone>_<dataset>_result.txt``.  Inference
predicts the mask of ``--instruction`` on ``<data_base_dir>/<dataset>/
DRAWING_GT/L0_sample<image_id>.png`` at ``--image_size`` and writes its
overlay to ``<run_dir>/visualize/L0_sample<image_id>_pred.png``.
In ``--mode train``, ``--pretrained_npz`` overlays a TF1 npz export
(``scripts/export_tf1_checkpoint.py``; a backbone-only one is the
reference's pretrained restore) onto the fresh parameters before
training, through ``utils/tf1_converter.py`` and the weight bridge.
"""
from __future__ import annotations

import argparse
import os

from .config import MatchingConfig


def make_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "eval", "inference"])
    p.add_argument("--backbone", type=str, default="deeplab",
                   choices=["deeplab", "fcn_8s", "segnet", "deeplab_v3plus"])
    p.add_argument("--dataset", type=str, default="val", choices=["val", "test"])
    p.add_argument("--data_base_dir", type=str, default="data")
    p.add_argument("--captions_base_dir", type=str, default="data")
    p.add_argument("--seg_data_base_dir", type=str, default="data")
    p.add_argument("--vocab_path", type=str, default="data/match_vocab.txt")
    p.add_argument("--vocab_size", type=int, default=76)
    p.add_argument("--max_len", type=int, default=15)
    p.add_argument("--run_dir", type=str, default="outputs/matching")
    p.add_argument("--pretrained_npz", type=str, default="",
                   help="TF-var npz for the pretrained backbone restore")
    p.add_argument("--max_iteration", type=int, default=100000)
    p.add_argument("--no_mask_ap", action="store_true")
    p.add_argument("--image_id", type=int, default=-1)
    p.add_argument("--instruction", type=str, default="")
    p.add_argument("--image_size", type=int, default=768)
    p.add_argument("--model_scale", type=float, default=1.0,
                   help="shrink factor for the text-head dims (debug runs)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    s = args.model_scale
    cfg = MatchingConfig(backbone=args.backbone, vocab_size=args.vocab_size,
                         max_len=args.max_len, max_iters=args.max_iteration,
                         H=args.image_size, W=args.image_size,
                         vf_h=args.image_size // 8, vf_w=args.image_size // 8,
                         w_emb_dim=int(1000 * s), v_emb_dim=int(1000 * s),
                         m_rnn_size=int(500 * s), w_rnn_size=int(1000 * s))
    from .data import matching_dataset as md
    md.IMAGE_SIZE = args.image_size

    import torch
    from .models.rmi import RMI
    from .ops.conv import apply_compute_dtype
    from .text import load_vocab
    apply_compute_dtype(cfg)
    vocab = load_vocab(args.vocab_path)
    model = RMI(cfg, torch.Generator().manual_seed(args.seed))
    if args.mode == "eval":
        return evaluate(args, cfg, model, vocab)
    if args.mode == "inference":
        return inference(args, cfg, model, vocab)

    from .data import MatchingTrainDataset
    from .train import train_matching
    if args.pretrained_npz:
        restore_pretrained(model, cfg, args.pretrained_npz)
    ds = MatchingTrainDataset(
        os.path.join(args.data_base_dir, "train"),
        os.path.join(args.captions_base_dir, "sentence_instance_train.json"),
        vocab, max_len=cfg.max_len, seed=args.seed)
    train_matching(cfg, ds, model, args.run_dir, device=args.device)
    return 0


def restore_pretrained(model, cfg: MatchingConfig, npz_path: str) -> None:
    """JAX ``cli_matching.py:70-75``: the converted TF1 variables of
    ``npz_path`` overlaid onto ``model``'s parameters (a partial export
    leaves the rest as they are)."""
    from .utils.bridge import export_jax_tree, load_jax_tree
    from .utils.tf1_converter import (convert_matching, load_tf_vars_npz,
                                      merge_converted)
    converted = convert_matching(load_tf_vars_npz(npz_path), cfg)
    load_jax_tree(model, merge_converted(export_jax_tree(model), converted))
    print("restored pretrained backbone from", npz_path)


def restored_engine(args, cfg: MatchingConfig, model, vocab):
    """A ``MatchingEngine`` on ``model`` restored from the newest snapshot
    under ``<run_dir>/snapshots``, when there is one."""
    from .pipeline.engines import MatchingEngine
    from .pipeline.factory import restore_matching
    step = restore_matching(model, os.path.join(args.run_dir, "snapshots"))
    if step is not None:
        print(f"restored step {step}")
    return MatchingEngine(cfg, model, vocab, device=args.device)


def evaluate(args, cfg: MatchingConfig, model, vocab) -> int:
    """JAX ``cli_matching.py:94-106``: the backbone runs once per image
    (``predict_masks``)."""
    from .train import eval_matching
    engine = restored_engine(args, cfg, model, vocab)
    eval_matching(
        engine.predict_mask, predict_batch_fn=engine.predict_masks,
        dataset_base_dir=os.path.join(args.data_base_dir, args.dataset),
        caption_json_path=os.path.join(
            args.captions_base_dir, f"sentence_instance_{args.dataset}.json"),
        seg_data_base_dir=None if args.no_mask_ap else os.path.join(
            args.seg_data_base_dir, args.dataset),
        compute_mask_ap=not args.no_mask_ap,
        result_path=os.path.join(args.run_dir, "eval_results",
                                 f"{args.backbone}_{args.dataset}_result.txt"))
    return 0


def inference(args, cfg: MatchingConfig, model, vocab) -> int:
    if args.image_id == -1 or not args.instruction:
        raise SystemExit("--mode inference needs --image_id and --instruction")
    from .train.eval_procedures import matching_inference
    engine = restored_engine(args, cfg, model, vocab)
    sketch_path = os.path.join(args.data_base_dir, args.dataset, "DRAWING_GT",
                               f"L0_sample{args.image_id}.png")
    out = matching_inference(engine, sketch_path, args.instruction,
                             os.path.join(args.run_dir, "visualize"),
                             image_size=args.image_size)
    print("saved:", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
