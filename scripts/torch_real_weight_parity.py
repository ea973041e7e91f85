#!/usr/bin/env python
"""The PyTorch port's parity check against the reference's released TF1
weights: the port's twin of ``scripts/real_weight_parity.py``, importing
only ``sketchyscenecolorization_torch`` and running on the card unless
``--device cpu`` is given.

1. Where TensorFlow is installed, export each checkpoint to npz:
       python scripts/export_tf1_checkpoint.py --checkpoint ... --out m.npz
2. Then:
       python scripts/torch_real_weight_parity.py --data_base_dir DIR \\
           --matching_npz m.npz --fg_npz fg.npz --bg_npz bg.npz \\
           [--reference_outputs DIR] [--image_id 9996] [--out_dir DIR]

Each npz is converted strictly by ``utils/tf1_converter.py`` (renames and
deconv-layout swaps into the JAX package's tree layout) and loaded into the
session's models through the weight bridge (``utils/bridge.py``); a model
without an npz keeps its fresh seeded weights.  The session uses the real
vocabularies (``data/*_vocab.txt``) and runs the canonical instruction
queue on the scene ``--image_id`` of ``--data_base_dir`` (the layout of
the reference's ``examples/``: ``sketches``, ``seg_data``,
``inner_masks``, ``colorMapC46.mat``), writing

- ``<out_dir>/results/<id>/<id>_N.png``: the colorized results;
- ``<out_dir>/masks/<id>_maskN.npy``: the binary matching mask of each FG
  instruction;
- ``<out_dir>/parity_report.json``: with ``--reference_outputs`` (the TF1
  pipeline's outputs for the same queue, same layout), per PNG the
  pixel-equality %, mean and max abs difference, and per mask the IoU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

DEFAULT_INSTRUCTIONS = [
    "the bus is yellow with gray windows",
    "the tree is green",
    "the sky is blue and the ground is green",
    "the cloud is gray",
]


def parity_config(data_base_dir: str = "", out_dir: str = ""):
    """The default ``FrameworkConfig`` on ``data_base_dir`` with the real
    vocabularies and no snapshots."""
    from sketchyscenecolorization_torch.config import (FrameworkConfig,
                                                       PipelineConfig)
    return FrameworkConfig(pipeline=PipelineConfig(
        data_base_dir=data_base_dir, results_base_dir=out_dir,
        match_vocab_path=os.path.join(REPO, "data", "match_vocab.txt"),
        fg_vocab_path=os.path.join(REPO, "data", "fg_vocab.txt"),
        bg_vocab_path=os.path.join(REPO, "data", "bg_vocab.txt"),
        match_ckpt_dir="", fg_ckpt_dir="", bg_ckpt_dir=""))


def convert_npz(kind: str, npz_path: str, cfg, template):
    """The strict conversion of one npz export: ``kind`` is 'matching',
    'fg' or 'bg'; ``template`` the model's tree (``export_jax_tree``), which
    the FG map reads for the blocks' optional projections."""
    from sketchyscenecolorization_torch.utils import tf1_converter as cvt
    tf_vars = cvt.load_tf_vars_npz(npz_path)
    if kind == "matching":
        return cvt.convert_matching(tf_vars, cfg.matching, strict=True)
    if kind == "fg":
        return cvt.convert_fg_generator(tf_vars, template, strict=True)
    return cvt.convert_bg_generator(tf_vars, cfg.bg_gan.multi_residual,
                                    strict=True)


def build_parity_session(matching_npz: str = "", fg_npz: str = "",
                         bg_npz: str = "", data_base_dir: str = "",
                         out_dir: str = "", seed: int = 0,
                         direct_params: dict | None = None,
                         device: str = "cuda"):
    """A session with any subset of converted TF1 weights (a model without
    an npz keeps its fresh weights, so the pipeline still runs end to end).

    ``direct_params`` bypasses the converter: a dict with any of the keys
    'matching'/'fg'/'bg' whose values are trees in the JAX layout, loaded
    as they are, to certify that a converted session gives the outputs of
    one handed the same arrays directly."""
    from sketchyscenecolorization_torch.pipeline.factory import build_session
    from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                             load_jax_tree)
    from sketchyscenecolorization_torch.utils.tf1_converter import \
        merge_converted
    cfg = parity_config(data_base_dir, out_dir)
    session = build_session(cfg, seed=seed, device=device)
    direct_params = direct_params or {}
    npzs = {"matching": matching_npz, "fg": fg_npz, "bg": bg_npz}
    models = {"matching": session.matching.model, "fg": session.fg.model,
              "bg": session.bg.model}
    for kind, module in models.items():
        template = export_jax_tree(module)
        if kind in direct_params:
            tree = direct_params[kind]
        elif npzs[kind]:
            tree = convert_npz(kind, npzs[kind], cfg, template)
        else:
            continue
        load_jax_tree(module, merge_converted(template, tree))
    return session


def run_and_report(session, image_id, instructions, out_dir: str,
                   reference_outputs: str = "") -> dict:
    """Run ``instructions`` in order on ``image_id``, dump each FG
    instruction's matching mask, and compare with ``reference_outputs``
    when given (JAX ``scripts/real_weight_parity.py:run_and_report``)."""
    from sketchyscenecolorization_torch.text import judge_colorize_type
    masks_dir = os.path.join(out_dir, "masks")
    os.makedirs(masks_dir, exist_ok=True)

    produced = []
    n_fg = 0
    for text in instructions:
        if judge_colorize_type(text) == "FG":
            state = session._state(image_id)
            mask = session.matching.predict_mask(state.sketch, text)
            n_fg += 1
            np.save(os.path.join(masks_dir, f"{image_id}_mask{n_fg}.npy"),
                    mask.astype(np.uint8))
        produced.append(session.colorize(image_id, text))
    session.flush()

    report = {"image_id": image_id, "instructions": list(instructions),
              "outputs": [os.path.relpath(p, out_dir) for p in produced]}
    if reference_outputs:
        report["comparisons"] = compare_outputs(
            out_dir, report["outputs"], instructions, image_id, n_fg,
            reference_outputs)
    return report


def compare_outputs(out_dir, outputs, instructions, image_id, n_fg,
                    reference_outputs):
    """Per PNG: pixel-equality %, mean and max abs difference; per mask:
    IoU (JAX ``real_weight_parity.py:135-170``)."""
    from PIL import Image
    comps = []
    for rel, text in zip(outputs, instructions):
        ref_path = os.path.join(reference_outputs, rel)
        entry = {"output": rel, "instruction": text}
        if os.path.isfile(ref_path):
            ours = np.asarray(
                Image.open(os.path.join(out_dir, rel)).convert("RGB"),
                dtype=np.int16)
            ref = np.asarray(Image.open(ref_path).convert("RGB"),
                             dtype=np.int16)
            if ours.shape == ref.shape:
                diff = np.abs(ours - ref)
                entry.update({
                    "pixels_equal_pct": round(
                        float((diff.max(axis=-1) == 0).mean() * 100), 3),
                    "mean_abs_diff": round(float(diff.mean()), 4),
                    "max_abs_diff": int(diff.max()),
                })
            else:
                entry["error"] = f"shape {ours.shape} vs {ref.shape}"
        else:
            entry["error"] = "reference output missing"
        comps.append(entry)
    for i in range(1, n_fg + 1):
        name = f"{image_id}_mask{i}.npy"
        ref_mask_path = os.path.join(reference_outputs, "masks", name)
        if os.path.isfile(ref_mask_path):
            ours = np.load(os.path.join(out_dir, "masks", name)) > 0
            ref = np.load(ref_mask_path) > 0
            union = float(np.logical_or(ours, ref).sum())
            comps.append({"mask": name, "iou": round(
                float(np.logical_and(ours, ref).sum()) / max(union, 1.0),
                5)})
    return comps


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--matching_npz", default="")
    p.add_argument("--fg_npz", default="")
    p.add_argument("--bg_npz", default="")
    p.add_argument("--data_base_dir", required=True,
                   help="scene fixtures in the layout of the reference's "
                        "examples/")
    p.add_argument("--reference_outputs", default="",
                   help="dir with the TF1 pipeline's outputs (same layout: "
                        "results/<id>/<id>_N.png, optional masks/*.npy)")
    p.add_argument("--out_dir", default="outputs/torch_real_weight_parity")
    p.add_argument("--image_id", type=int, default=9996)
    p.add_argument("--instruction", action="append", default=None,
                   help="repeatable; defaults to a canonical FG+BG queue")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    session = build_parity_session(args.matching_npz, args.fg_npz,
                                   args.bg_npz, args.data_base_dir,
                                   args.out_dir, device=args.device)
    report = run_and_report(session, args.image_id,
                            args.instruction or DEFAULT_INSTRUCTIONS,
                            args.out_dir, args.reference_outputs)
    session.close()
    path = os.path.join(args.out_dir, "parity_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    print(f"\nreport written to {path}")


if __name__ == "__main__":
    main()
