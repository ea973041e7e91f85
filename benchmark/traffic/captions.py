"""Generator of matcher-training batches: a SketchyScene caption, a scene
that holds the instances it names (and a few others), the union of the
named instances' strokes as the label mask.

Parameters (a traffic file with ``"kind": "captions"``):

- ``captions``: file under ``benchmark/data`` with the captions (text,
  category, number of instances named) and the length distribution of
  the training split;
- ``pool_batches``: batches drawn from the seed; the steps cycle through
  them.  Their caption lengths are the split's length quantiles at
  (j + 0.5) / pool_batches, so every seed trains on the same lengths;
- ``side_px``: [largest, smallest] instance side, as for the serving
  scenes;
- ``distractors``: numbers of other instances, cycled over the batches;
- ``augment``: append a colour phrase, as the training loader's caption
  augmentation does ("the dog" -> "the dog is light brown").
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import List

import numpy as np

from ..scenes import FG_CATEGORIES, WORD_TO_ID

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
AUG_COLORS = ["dark brown", "light brown", "light gray", "dark gray",
              "black", "red", "dark green", "light green", "dark blue",
              "light blue", "yellow", "orange", "pink", "purple"]


@dataclass
class BatchPlan:
    caption: str
    class_ids: List[int]       # 46-category id of every instance
    sides: List[int]
    targets: List[int]         # indices of the named instances


def _lengths(counts: dict, n: int) -> List[int]:
    ls = sorted(int(k) for k in counts)
    cdf = np.cumsum([counts[str(k)] for k in ls]) / sum(counts.values())
    return [ls[int(np.searchsorted(cdf, (j + 0.5) / n))] for j in range(n)]


def make_plan(p: dict, seed: int) -> List[BatchPlan]:
    with open(os.path.join(DATA, p["captions"])) as f:
        data = json.load(f)
    rng = np.random.default_rng([seed, 3])
    by_len = {}
    for text, cat, k in data["captions"]:
        by_len.setdefault(len(text.split()), []).append((text, cat, k))
    n = p["pool_batches"]
    big, small = p["side_px"]
    cats = sorted(FG_CATEGORIES)
    out = []
    for j, length in enumerate(_lengths(data["length_counts_all_train"], n)):
        options = by_len[length]
        text, cat, k = options[int(rng.integers(len(options)))]
        if p.get("augment"):
            verb = " are " if k > 1 else " is "
            text = text + verb + AUG_COLORS[int(rng.integers(len(AUG_COLORS)))]
        d = p["distractors"][j % len(p["distractors"])]
        others = [c for c in cats if c != WORD_TO_ID[cat]]
        ids = [WORD_TO_ID[cat]] * k + [int(rng.choice(others))
                                       for _ in range(d)]
        total = k + d
        hi = max(small, int(big / math.sqrt(total)))
        sides = [int(round(hi - (hi - small) * (i + 0.5) / total))
                 for i in range(total)]
        order = rng.permutation(total)
        out.append(BatchPlan(text, [ids[i] for i in order],
                             [sides[i] for i in order],
                             sorted(int(np.nonzero(order == t)[0][0])
                                    for t in range(k))))
    perm = rng.permutation(n)
    return [out[i] for i in perm]
