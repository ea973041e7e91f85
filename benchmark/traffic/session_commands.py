"""Generator of interactive-session traffic: scene visits, each a fresh
image id on which one user issues a few commands in a closed loop.

Parameters (a traffic file ``traffic/<name>.json`` with ``"kind":
"session_commands"``):

- ``pool_scenes``: scenes drawn from the seed; visits cycle through them
  in a seeded, K-balanced order (``balanced_order``), each visit under a
  new image id (so nothing cached for an earlier visit serves it).
- ``instances``: file under ``benchmark/data`` with the distribution of
  the number of instances K a referring expression names; the pool's K
  are its quantiles at (j + 0.5) / pool_scenes, the top one replaced by
  the distribution's largest, so every seed serves the same K and the
  tail is in every run.
- ``side_px``: [largest, smallest] box side of an instance; a scene of K
  instances spreads its sides between ``largest / sqrt(K)`` and
  ``smallest``.
- ``commands``: per visit, ``"fg"`` colour commands, ``"bg"`` commands,
  or ``"fg_queue"`` (one ``colorize_stream`` call of that many FG texts).
- ``per_visit``: commands (or queue length) per visit; a visit's FG
  texts are distinct, so none is served from the session's score cache.
- ``withdraw_per_visits``: [n, m]: n of every m visits hold one
  ``withdraw`` after their second command (0 for none).
- ``visits``: how many visits are planned; the window ends first.
- ``warmup_visits``: visits of set-up; by default one to a scene of each
  distinct K (every generator batch shape).
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..scenes import FG_CATEGORIES

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
FG_COLORS = ["light gray", "orange", "red", "purple", "brown", "dark green",
             "black", "cyan", "pink", "blue", "yellow", "white", "green",
             "dark gray", "light green", "light blue", "dark blue"]
FG_TEMPLATES = ["the {n} {v} {c}",
                "the {n} on the left {v} {c}",
                "the {n} {v} {c} with {c2} edge",
                "the {n} in the middle {v} {c}"]
BG_COLORS = ["blue", "green", "gray", "purple", "black", "yellow", "brown",
             "cyan", "pink", "orange", "red"]


@dataclass
class ScenePlan:
    class_id: int
    sides: List[int]

    @property
    def k(self) -> int:
        return len(self.sides)


@dataclass
class Visit:
    name: str                    # image id
    pool: int                    # index into Plan.pool
    commands: List[Tuple]        # ("color", text) | ("withdraw",) |
                                 # ("stream", [texts])


@dataclass
class Plan:
    pool: List[ScenePlan]
    visits: List[Visit]
    warmup: List[Visit] = field(default_factory=list)


def k_quantiles(path: str, n: int) -> List[int]:
    with open(path) as f:
        counts = {int(k): v for k, v in
                  json.load(f)["instances_per_expression"].items()}
    ks = sorted(counts)
    total = sum(counts.values())
    cdf = np.cumsum([counts[k] for k in ks]) / total
    out = [ks[int(np.searchsorted(cdf, (j + 0.5) / n))] for j in range(n)]
    out[-1] = ks[-1]
    return out


def balanced_order(ks: List[int], rng) -> List[int]:
    """A seeded cyclic order of the pool in which every stretch of visits
    holds about the pool's mix of K: the scenes sorted by K (ties
    shuffled) are laid out in bit-reversed rank order, then rotated by a
    seeded offset, so that a window that ends part-way through a cycle
    serves the same mix on every seed."""
    n = len(ks)
    bits = max(1, (n - 1).bit_length())
    ranked = sorted(range(n), key=lambda j: (ks[j], rng.random()))
    rev = sorted(range(n), key=lambda r: int(format(r, f"0{bits}b")[::-1], 2))
    order = [ranked[r] for r in rev]
    shift = int(rng.integers(n))
    return order[shift:] + order[:shift]


def _fg_text(rng, word, plural, template):
    c, c2 = rng.choice(FG_COLORS, 2, replace=False)
    return template.format(n=plural if plural else word,
                           v="are" if plural else "is", c=c, c2=c2)


def _bg_texts(rng, n) -> List[str]:
    sky, ground = rng.choice(BG_COLORS, 2, replace=False)
    texts = [f"the sky is {sky} and the ground is {ground}"]
    for i in range(1, n):
        kind = ("sky", "ground", "both")[(i + int(rng.integers(3))) % 3]
        if kind in ("sky", "both"):
            sky = rng.choice([c for c in BG_COLORS if c not in (sky, ground)])
        if kind in ("ground", "both"):
            ground = rng.choice([c for c in BG_COLORS
                                 if c not in (sky, ground)])
        texts.append({"sky": f"the sky is {sky}",
                      "ground": f"the ground is {ground}",
                      "both": f"the sky is {sky} and the ground is "
                              f"{ground}"}[kind])
    return texts


def _visit_commands(rng, p: dict, scene: ScenePlan, visit: int,
                    template0: int) -> List[Tuple]:
    word, plural = FG_CATEGORIES[scene.class_id]
    many = plural if scene.k > 1 else None
    n = p["per_visit"]
    if p["commands"] == "bg":
        return [("color", t) for t in _bg_texts(rng, n)]
    texts: List[str] = []
    while len(texts) < n:           # distinct: no command is a cache hit
        t = _fg_text(rng, word, many, FG_TEMPLATES[
            (template0 + len(texts)) % len(FG_TEMPLATES)])
        if t not in texts:
            texts.append(t)
    if p["commands"] == "fg_queue":
        return [("stream", texts)]
    cmds = [("color", t) for t in texts]
    wd, of = p.get("withdraw_per_visits", [0, 1])
    if visit % of < wd:
        cmds.insert(2 + int(rng.integers(n - 1)), ("withdraw",))
    return cmds


def make_plan(p: dict, seed: int) -> Plan:
    rng = np.random.default_rng(seed)
    n_pool = p["pool_scenes"]
    ks = k_quantiles(os.path.join(DATA, p["instances"]), n_pool)
    big, small = p["side_px"]
    cats = sorted(FG_CATEGORIES)
    pool = []
    for k in ks:
        hi = max(small, int(big / math.sqrt(k)))
        sides = [int(round(hi - (hi - small) * (i + 0.5) / k))
                 for i in range(k)]
        pool.append(ScenePlan(int(rng.choice(cats)), sides))
    order = balanced_order(ks, rng)
    visits = []
    for v in range(p["visits"]):
        j = int(order[v % n_pool])
        visits.append(Visit(f"v{v}", j, _visit_commands(
            rng, p, pool[j], v, v % len(FG_TEMPLATES))))
    # warm-up: one visit to a scene of each distinct K (or the first
    # ``warmup_visits`` scenes, where K changes no shape), same commands
    n_warm = p.get("warmup_visits")
    firsts = list(range(n_warm)) if n_warm else \
        [ks.index(k) for k in sorted(set(ks))]
    warm = [Visit(f"w{j}", j, _visit_commands(rng, p, pool[j], 0, 0))
            for j in firsts]
    return Plan(pool, visits, warm)
