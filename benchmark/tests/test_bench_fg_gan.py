"""The FG GAN training cell on the CPU at a tiny size: it runs
``correct`` through its driver, the instance batches are a function of
the seed, the six metrics of the GAN step read what they should from a
synthetic run, and a step whose discriminator trains on the previous
step's fakes fails the check."""
import copy
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import train_fg_gan
from benchmark.harness import load_json
from benchmark.record import Run
from benchmark.tests.tiny import SIZE
from benchmark.traffic import instance_batches
from sketchyscenecolorization_torch.utils.tracing import Span

SEED = 4294967311            # more than 32 bits, as the driver's seeds are


def tiny_gan_config() -> dict:
    config = copy.deepcopy(load_json("configs", "train_fg_gan_mru192.json"))
    config["framework"]["fg_gan"].update(image_size=SIZE, base_channels=8,
                                         noise_dim=16)
    return config


def tiny_gan_traffic() -> dict:
    traffic = load_json("traffic", "fg_gan_train.json")
    traffic["pool_batches"] = 4
    return traffic


def train(seed=SEED, seconds=2.0):
    run = train_fg_gan.run(
        cell={"name": "fg_gan_train", "chips": 1}, config=tiny_gan_config(),
        traffic=tiny_gan_traffic(), seed=seed, seconds=seconds, trace=False,
        started=time.time(), device="cpu")
    return run, {c["name"]: c["value"] for c in run.checks}


def test_the_gan_cell_runs_correct_on_the_cpu():
    run, values = train()
    assert run.correct, run.checks
    assert run.steps > 0 and run.window_s > 0
    assert set(values) == {"loss_gap", "grad_gap", "change_gap", "sn_gap"}


def test_a_discriminator_on_stale_fakes_fails(monkeypatch):
    from sketchyscenecolorization_torch.models import fg_gan
    orig = fg_gan.MRUGenerator.forward
    last = {}

    def stale(self, *args, **kw):
        out = orig(self, *args, **kw)
        if torch.is_grad_enabled():
            return out
        prev, last["fakes"] = last.get("fakes"), out
        return out if prev is None else prev
    monkeypatch.setattr(fg_gan.MRUGenerator, "forward", stale)
    run, values = train()
    assert not run.correct
    assert values["loss_gap"] > 1e-5 and values["grad_gap"] > 1e-2


def test_the_instance_batches_are_the_seeds():
    traffic = tiny_gan_traffic()
    a = instance_batches.make_plan(traffic, SEED)
    assert a == instance_batches.make_plan(traffic, SEED)
    assert a != instance_batches.make_plan(traffic, SEED + 1)
    assert len(a) == traffic["pool_batches"]
    for pair in a:
        for batch in (pair.d, pair.g):
            assert len(batch.pairs) == len(batch.reals) == traffic["batch"]
            assert all(i.caption for i in batch.pairs)
            assert all(60 <= i.side <= 340 and 0 <= i.class_id < 25
                       for i in batch.pairs + batch.reals)
    f = tiny_gan_config()["framework"]["fg_gan"]
    one = train_fg_gan.make_batches(a[:2], f, SEED)
    two = train_fg_gan.make_batches(a[:2], f, SEED)
    for (d1, g1), (d2, g2) in zip(one, two):
        for k in d1:
            assert np.array_equal(d1[k], d2[k]) and np.array_equal(g1[k],
                                                                   g2[k])
    d, g = one[0]
    assert d["images"].shape == (2, SIZE, SIZE, 3)
    assert d["images"].min() >= -1.0 and d["images"].max() <= 1.0
    assert (d["tokens"][:, -1] != 0).all()          # front-padded
    assert not np.array_equal(d["sketches"], g["sketches"])


def gan_run() -> Run:
    """A traced run of two steps: one D update and one G update each, two
    Adam updates a step, four discriminator and two generator forwards a
    step, idle 7 s of the 10 s window, 4.2 s of it inside a named span."""
    run = Run(steps=2, window=(0.0, 10.0), window_s=10.0,
              traced_window_s=10.0)
    run.kernels = [("k", 0.0, 2.0), ("k", 5.0, 6.0)]
    spans, ids = [], iter(range(1, 100))

    def add(label, t0, t1, req, parent=None, counts=None):
        spans.append(Span(label, t0, t1, next(ids), req, parent, counts))
        return spans[-1].id
    for req, base in ((0, 0.0), (1, 5.0)):
        root = len(spans) + 1
        add("step", base, base + 5.0, req, None, {"d_updates": 1})
        d = add("d_update", base + 2.0, base + 2.9, req, root)
        add("adam", base + 2.8, base + 2.9, req, d)
        g = add("g_update", base + 3.0, base + 4.2, req, root)
        add("adam", base + 4.0, base + 4.2, req, g)
    run.stages = spans
    run.module_ms = {"generator": [3.0, 5.0, 3.0, 5.0],
                     "discriminator": [1.0, 2.0, 3.0, 4.0] * 2}
    return run


@pytest.mark.parametrize("name,want", [
    ("d_update_ms", 900.0), ("g_update_ms", 1200.0), ("adam_ms", 300.0),
    ("disc_device_ms", 10.0), ("fg_generator_device_ms.train", 8.0),
    ("idle_named_share.train", 60.0)])
def test_the_gan_step_metrics_read_their_spans_and_events(name, want):
    read = harness.metric_reader(name)
    assert read(gan_run()) == pytest.approx(want)
    assert read(Run()) is None          # a program without them: nothing
