"""The yardstick's arithmetic: peaks, the work a call needs, bounds.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 495 TFLOP/s
TF32 on the tensor cores, 3.35 TB/s HBM.  The program computes in f32
(TF32 off); its hand-written recurrences reach f32 accuracy on the tensor
cores as three TF32 products per f32 product (3xTF32), so the f32-accurate
peak is 495 / 3 = 165 TFLOP/s, which no f32-accurate code can pass.  It is
the peak of ``mfu.*`` and of the rooflines.

``fwd_bound_s`` and ``bwd_bound_s`` count only the products a masked
pixel-LSTM call needs (one [P, H] x [H, 4H] product per valid step after
the first, per batch row; three for the backward) and its compulsory bytes
(inputs read once, outputs written once).  ``model_flops`` counts the
convolutions and matrix products of the plain reference models with
``torch.utils.flop_counter`` on the meta device, the recurrences replaced
by those needed products, so the count is the same whatever runs them.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Sequence

import torch

F32_ACCURATE_PEAK = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / F32_ACCURATE_PEAK, nbytes / HBM_BYTES_PER_S)


def fwd_bound_s(n: int, p: int, hid: int, t: int, kept: Sequence[int]) -> float:
    """B1 (the forward) of one call; ``kept`` is each batch row's number
    of valid steps."""
    flops = sum(2 * p * hid * 4 * hid * max(k - 1, 0) for k in kept)
    nbytes = 4 * (n * p * 4 * hid + n * t * 4 * hid + hid * 4 * hid + n * t
                  + n * p * hid)
    return _bound(flops, nbytes)


def bwd_bound_s(n: int, p: int, hid: int, t: int, kept: Sequence[int]) -> float:
    """B2 (the backward, which recomputes the forward) of one call."""
    flops = sum(3 * 2 * p * hid * 4 * hid * max(k - 1, 0) for k in kept)
    nbytes = 4 * (2 * n * p * 4 * hid + 2 * n * t * 4 * hid
                  + 2 * hid * 4 * hid + n * t + n * p * hid)
    return _bound(flops, nbytes)


def recurrence_flops(p: int, hid: int, kept: int) -> int:
    return 2 * p * hid * 4 * hid * max(kept - 1, 0)


def count_flops(fn) -> float:
    """FLOPs of ``fn()`` (a reference model's call, as a rule on the meta
    device), its recurrences counted as their needed products; a
    configuration's own work module counts its parts with it."""
    from torch.utils.flop_counter import FlopCounterMode
    from .reference import ops
    with ops.counting(), FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@lru_cache(maxsize=None)
def model_flops(kind: str, sizes_json: str, part: str) -> float:
    """FLOPs of one call of a reference model without its recurrence:
    ``part`` is 'backbone' (matcher: backbone and projection), 'fusion'
    (matcher: one text), 'row' (FG generator: one row), 'bg' (BG
    generator: one image)."""
    import json
    from . import reference
    sizes = json.loads(sizes_json)
    model = reference.skeleton(kind, sizes)
    meta = torch.device("meta")
    with torch.no_grad():
        if part == "backbone":
            img = torch.empty(1, sizes["H"], sizes["W"], 3, device=meta)
            return count_flops(lambda: model.visual(img))
        if part == "fusion":
            vis = torch.empty(1, sizes["vf_h"], sizes["vf_w"],
                              sizes["v_emb_dim"], device=meta)
            t = sizes["max_len"]
            words = torch.zeros(1, t, dtype=torch.long, device=meta)
            n = torch.full((1,), t, dtype=torch.long, device=meta)
            return count_flops(lambda: model.fuse(vis, words, n))
        s = sizes["image_size"]
        if part == "row":
            return count_flops(lambda: model(
                torch.empty(1, s, s, 3, device=meta),
                torch.zeros(1, sizes["max_len"], dtype=torch.long, device=meta),
                torch.zeros(1, dtype=torch.long, device=meta),
                torch.empty(1, sizes["noise_dim"], device=meta)))
        return count_flops(lambda: model(
            torch.empty(1, s, s, 3, device=meta),
            torch.zeros(1, sizes["max_len"], dtype=torch.long, device=meta)))


def _js(d: dict) -> str:
    import json
    return json.dumps(d, sort_keys=True)


def serve_work(fw: dict, plan, log: List[dict]) -> Dict[str, float]:
    """FLOPs and B1's bounds of the commands completed in the window."""
    from .reference import text as rtext
    from .serve_check import vocab
    m, f, b = fw["matching"], fw["fg_gan"], fw["bg_gan"]
    mv, fv, bv = (vocab("match_vocab.txt"), vocab("fg_vocab.txt"),
                  vocab("bg_vocab.txt"))
    p_m = m["vf_h"] * m["vf_w"]
    p_f = (f["image_size"] // 32) ** 2
    p_b = (b["image_size"] // 32) ** 2
    h_f, h_b = 8 * f["base_channels"], 16 * b["ngf"]
    flops, b1 = 0.0, 0.0
    seen_visits = set()
    bg_text = {}
    for e in log:
        if not e["ok"] or e["kind"] == "withdraw":
            continue
        visit = plan.visits[e["visit"]]
        k = plan.pool[visit.pool].k
        for text in e["texts"]:
            if rtext.is_fg(text):
                if e["visit"] not in seen_visits:
                    seen_visits.add(e["visit"])
                    flops += model_flops("matching", _js(m), "backbone")
                _, n = rtext.matching_encode(text, mv, m["max_len"])
                flops += model_flops("matching", _js(m), "fusion") \
                    + recurrence_flops(p_m, m["m_rnn_size"], n)
                b1 += fwd_bound_s(1, p_m, m["m_rnn_size"], m["max_len"], [n])
                toks = rtext.colorization_encode(rtext.fg_color_text(text),
                                                 fv, f["max_len"])
                kept = sum(1 for t in toks if t != 0)
                flops += k * (model_flops("fg_gan", _js(f), "row")
                              + recurrence_flops(p_f, h_f, kept))
                rows = 1 << max(k - 1, 0).bit_length()    # the padded batch
                b1 += fwd_bound_s(rows, p_f, h_f, f["max_len"],
                                  [kept] * k + [0] * (rows - k))
            else:
                merged = rtext.merge_bg_text(
                    text, bg_text.get(e["visit"], rtext.DEFAULT_BG_TEXT))
                bg_text[e["visit"]] = merged
                toks = rtext.colorization_encode(merged, bv, b["max_len"])
                kept = sum(1 for t in toks if t != 0)
                flops += model_flops("bg_gan", _js(b), "bg") \
                    + recurrence_flops(p_b, h_b, kept)
                b1 += fwd_bound_s(1, p_b, h_b, b["max_len"], [kept])
    return {"flops": flops, "b1_bound_s": b1}
