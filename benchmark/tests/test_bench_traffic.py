"""The traffic generators: deterministic per seed, and their K and
caption-length distributions follow the vendored SketchyScene data."""
import json
import os

import numpy as np
import pytest

from benchmark.harness import BENCH_DIR, load_json
from benchmark.traffic import captions, session_commands

DATA = os.path.join(BENCH_DIR, "data")


def _plan_key(plan):
    return ([(s.class_id, s.sides) for s in plan.pool],
            [(v.name, v.pool, v.commands) for v in plan.visits],
            [(v.name, v.pool, v.commands) for v in plan.warmup])


@pytest.mark.parametrize("name", ["fg_interactive", "bg_interactive"])
def test_session_plan_is_deterministic_per_seed(name):
    p = load_json("traffic", f"{name}.json")
    a = session_commands.make_plan(p, 2 ** 31 + 11)
    b = session_commands.make_plan(p, 2 ** 31 + 11)
    c = session_commands.make_plan(p, 5)
    assert _plan_key(a) == _plan_key(b)
    assert _plan_key(a) != _plan_key(c)


def test_every_seed_serves_the_same_k_multiset_from_the_real_distribution():
    p = load_json("traffic", "fg_interactive.json")
    ks = [sorted(s.k for s in session_commands.make_plan(p, seed).pool)
          for seed in (1, 2, 3 ** 20)]
    assert ks[0] == ks[1] == ks[2]
    with open(os.path.join(DATA, p["instances"])) as f:
        counts = {int(k): v for k, v in
                  json.load(f)["instances_per_expression"].items()}
    total = sum(counts.values())
    share_one = counts[1] / total
    k = np.array(ks[0])
    assert abs((k == 1).mean() - share_one) < 1.0 / len(k)
    assert k.max() == max(counts)                    # the tail is in
    mean = sum(n * c for n, c in counts.items()) / total
    assert abs(k.mean() - mean) < 0.2 * mean


def test_session_commands_route_as_the_traffic_says():
    from benchmark.reference.text import bg_text_type, is_fg
    fg = session_commands.make_plan(load_json("traffic", "fg_interactive.json"), 9)
    bg = session_commands.make_plan(load_json("traffic", "bg_interactive.json"), 9)
    cmds = [c for v in fg.visits for c in v.commands]
    withdraws = sum(c[0] == "withdraw" for c in cmds)
    assert all(is_fg(c[1]) for c in cmds if c[0] == "color")
    assert abs(withdraws / len(cmds) - 1 / 8) < 0.02
    for v in bg.visits[:50]:
        texts = [c[1] for c in v.commands]
        assert bg_text_type(texts[0]) == "both"
        assert not any(is_fg(t) for t in texts)


def test_caption_plan_is_deterministic_and_follows_the_split_lengths():
    p = load_json("traffic", "matching_train.json")
    a = captions.make_plan(p, 77)
    assert [(b.caption, b.targets) for b in a] == \
        [(b.caption, b.targets) for b in captions.make_plan(p, 77)]
    raw = dict(p, augment=False)
    lens = sorted(len(b.caption.split()) for b in captions.make_plan(raw, 77))
    assert lens == sorted(len(b.caption.split())
                          for b in captions.make_plan(raw, 3))
    with open(os.path.join(DATA, p["captions"])) as f:
        counts = json.load(f)["length_counts_all_train"]
    assert min(lens) >= min(map(int, counts)) and max(lens) <= max(map(int, counts))
    assert np.median(lens) == pytest.approx(3, abs=1)
    for b in a:
        assert b.targets and all(0 <= t < len(b.class_ids) for t in b.targets)
