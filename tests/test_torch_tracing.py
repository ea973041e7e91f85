"""The port's tracer (``sketchyscenecolorization_torch/utils/tracing.py``)
inside the serving session and the matching train step, on the CPU at the
tiny fixture of ``tests/test_pipeline.py``.

- Every public call (``colorize`` FG and BG, ``withdraw``,
  ``colorize_stream``) records its stages under one root span: the spans
  of one call share a request id, calls differ, parents enclose their
  children.
- The generator's ``gan_dispatch`` spans count their rows and the padded
  bucket rows; a slowed ``score_instances`` shows inside the stream's
  ``match`` span.
- Each PNG write counts ``png_writes`` and ``png_banded`` (deflated in
  row bands) on the span that waits for it: ``save+records``,
  ``fg_debug``, ``bg_save``, or a write-behind job's ``png_encode``.
- A train step records ``step``, ``forward``, ``backward`` and ``adam``.
- Off, nothing is recorded; on and off give byte-identical results,
  records and updated parameters.
"""
import copy
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.models.rmi import RMI
from sketchyscenecolorization_torch.pipeline import compositing as comp
from sketchyscenecolorization_torch.pipeline import io as png_io
from sketchyscenecolorization_torch.pipeline.factory import build_session
from sketchyscenecolorization_torch.train import (create_matching_state,
                                                  make_matching_train_step)
from sketchyscenecolorization_torch.utils.tracing import (NO_SPAN, Tracer,
                                                          self_ms, span)
from test_pipeline import INST, SIZE, write_fixtures

IMAGE_ID = 7
# fixed matches of the FG instructions: 0 is the bus, 1 the grass
ROUTES = {"the bus is yellow": [0], "the grass is green": [1],
          "the bus is red": [0, 1]}
BG_TEXT = "the sky is blue and the ground is green"
QUEUE = ["the bus is yellow", "the grass is green", BG_TEXT, "the bus is red"]


def routed(session):
    def _match_many(self, state, input_texts):
        return [list(ROUTES[t]) for t in input_texts]
    session._match_many = types.MethodType(_match_many, session)
    return session


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tracing")
    write_fixtures(str(tmp / "examples"), image_id=IMAGE_ID)
    cfg = tconfig.FrameworkConfig(
        matching=tconfig.MatchingConfig(
            vf_h=SIZE // 8, vf_w=SIZE // 8, H=SIZE, W=SIZE, vocab_size=16,
            w_emb_dim=16, v_emb_dim=16, m_rnn_size=8, w_rnn_size=16,
            max_len=6),
        fg_gan=tconfig.FGGanConfig(image_size=INST, vocab_size=16, max_len=6,
                                   base_channels=4, noise_dim=8),
        bg_gan=tconfig.BGGanConfig(image_size=SIZE, vocab_size=16, max_len=8,
                                   ngf=4, ndf=4, multi_residual=False),
        pipeline=tconfig.PipelineConfig(
            data_base_dir=str(tmp / "examples"),
            results_base_dir=str(tmp / "outputs"),
            match_vocab_path="", fg_vocab_path="", bg_vocab_path="",
            match_ckpt_dir="", fg_ckpt_dir="", bg_ckpt_dir="",
            image_size=SIZE, instance_size=INST))
    return tmp, build_session(cfg, seed=0, device="cpu")


def session_of(base, name, trace=True, route=True, **pipeline):
    tmp, session = base
    s = session.clone(seed=0, results_base_dir=str(tmp / name),
                      stage_trace=trace, **pipeline)
    return routed(s) if route else s


@pytest.fixture
def device_gradient(monkeypatch):
    monkeypatch.setattr(comp, "_LUT_MIN_PIXELS", 1)


WORKER_LABELS = ("png_fetch", "png_encode")


def one_call(events):
    """The root of a call's spans, after checking that they nest under it
    and share its request id (a PNG worker's span runs after the span that
    queued it)."""
    roots = [e for e in events if e.parent is None]
    assert len(roots) == 1, [e[0] for e in roots]
    root = roots[0]
    by_id = {e.id: e for e in events}
    for e in events:
        assert e.req == root.req, (e[0], e.req, root.req)
        assert e[2] >= e[1]
        if e is not root and e[0] not in WORKER_LABELS:
            parent = by_id[e.parent]
            assert parent[1] <= e[1] and e[2] <= parent[2], (e[0], parent[0])
    return root


FG_LEAVES = {"records", "image_state", "match", "prep_rows", "canvas_upload",
             "compositor_build", "gan_dispatch[1]", "comp_dispatch",
             "patch_wait", "reconstruct", "save+records"}
BG_LEAVES = {"records", "image_state", "canvas_upload", "compositor_build",
             "bg_dispatch", "fg_debug", "bg_band_fetch", "bg_ramp_host",
             "bg_finish_dispatch", "bg_save"}


@pytest.mark.parametrize("text,root,labels", [
    ("the bus is yellow", "cmd:fg", FG_LEAVES),
    (BG_TEXT, "cmd:bg", BG_LEAVES)])
def test_a_command_records_its_stages_under_one_root(base, device_gradient,
                                                     text, root, labels):
    session = session_of(base, f"one_{root[4:]}")
    session.colorize(IMAGE_ID, text)
    events = session.trace_events
    assert one_call(events)[0] == root
    got = {e[0] for e in events}
    assert labels <= got, labels - got
    assert not {"backbone_dispatch", "fuse_dispatch"} & got  # routed
    records = [e for e in events if e[0] == "records"]
    assert len(records) == 2            # the fetch and the update
    # the first look-up of the image builds its state, later ones hit
    assert [e[0] for e in events].count("image_state") == 1
    session.clear_trace()
    session.colorize(IMAGE_ID, text)
    again = session.trace_events
    assert one_call(again).counts["image_hit"] >= 1
    assert "image_state" not in {e[0] for e in again}


def test_withdraw_and_a_queue_each_take_a_request(base, device_gradient):
    session = session_of(base, "queue", async_png_writes=True)
    session.colorize_stream(IMAGE_ID, QUEUE)
    session.flush()
    stream = session.trace_events
    root = one_call(stream)
    assert root[0] == "cmd:stream"
    # the BG text runs as a command inside the queue's; the PNG workers'
    # spans belong to the command that queued them
    assert {"cmd:bg", "png_fetch", "png_encode", "fg_debug",
            "gan_dispatch[2]"} <= {e[0] for e in stream}
    session.clear_trace()
    session.withdraw(IMAGE_ID)
    withdraw = session.trace_events
    assert one_call(withdraw)[0] == "cmd:withdraw"
    assert [e[0] for e in withdraw] == ["records", "cmd:withdraw"]
    session.clear_trace()
    session.colorize(IMAGE_ID, "the bus is yellow")
    again = session.trace_events
    assert len({root.req, withdraw[0].req, one_call(again).req}) == 3


@pytest.mark.parametrize("k,bucket", [(1, 1), (3, 4), (4, 4), (6, 6),
                                      (7, 8), (9, 9)])
def test_gan_rows_count_each_chunks_bucket(base, k, bucket):
    """With chunks of 4 rows (``MAX_GAN_ROWS``), 7 rows run as 4 and 3,
    padded to 4 and 4."""
    engine = base[1].fg.fork(3)
    engine.MAX_GAN_ROWS = 4               # instance attr shadows the class's
    rng = np.random.RandomState(k)
    sketches = rng.uniform(-1, 1, (k, INST, INST, 3)).astype(np.float32)
    toks = rng.randint(0, 12, (k, 6)).astype(np.int32)
    tracer = Tracer()
    with span(tracer, "gan") as sp:
        out, n = engine.colorize_rows_dev(sketches, [1] * k, toks, tracer)
    assert n == k and out.shape[0] >= k
    assert sp.counts == {"rows": k, "bucket": bucket}


def test_gan_dispatch_counts_rows_and_bucket(base):
    session = session_of(base, "bucket")
    session.colorize_stream(IMAGE_ID, ["the bus is red", "the bus is yellow"])
    gan = [e for e in session.trace_events if e[0].startswith("gan_dispatch")]
    assert [(e[0], e.counts) for e in gan] == \
        [("gan_dispatch[3]", {"rows": 3, "bucket": 4})]
    match = [e for e in session.trace_events if e[0] == "match"]
    assert [e.counts for e in match] == [{"texts": 2}] * 2    # routed


def test_a_slow_scoring_shows_inside_the_queues_match(base, monkeypatch):
    session = session_of(base, "slow_match", route=False)
    score = session.matching.score_instances

    def slow(*args, **kwargs):
        time.sleep(0.05)
        return score(*args, **kwargs)
    monkeypatch.setattr(session.matching, "score_instances", slow)
    session.colorize_stream(IMAGE_ID, ["the bus", "the grass"])
    events = session.trace_events
    root = one_call(events)
    first = min((e for e in events if e[0] == "match"), key=lambda e: e[1])
    assert first.parent == root.id and first[2] - first[1] >= 0.05
    assert first.counts["texts"] == 2 and first.counts["scored"] == 2
    children = {e[0] for e in events if e.parent == first.id}
    assert children == {"backbone_dispatch", "fuse_dispatch", "match_fetch"}
    later = [e for e in events if e[0] == "match" and e is not first]
    assert [e.counts["scored"] for e in later] == [0]    # from the cache


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("bands", [1, 2])
def test_each_png_write_counts_on_the_span_that_waits_for_it(
        base, monkeypatch, bands, grad):
    """A synchronous write counts ``png_writes`` and ``png_banded`` on
    ``save+records``, ``fg_debug`` or ``bg_save`` and opens no ``png_*``
    span of its own; a write-behind one counts on its ``png_encode``."""
    if grad:
        monkeypatch.setattr(comp, "_LUT_MIN_PIXELS", 1)
    monkeypatch.setattr(png_io, "_pool_size", lambda: bands)
    monkeypatch.setattr(png_io, "_BAND_ROWS", SIZE // 4)
    want = {"png_writes": 1, "png_banded": int(bands > 1)}
    session = session_of(base, f"png_counts_{bands}_{grad}")
    session.colorize(IMAGE_ID, "the bus is yellow")
    session.colorize(IMAGE_ID, BG_TEXT)
    events = session.trace_events
    counted = [(e[0], e.counts) for e in events if "png_writes" in e.counts]
    assert sorted(counted) == sorted([("save+records", want),
                                      ("fg_debug", want), ("bg_save", want)])
    assert not [e[0] for e in events if e[0].startswith("png_")]
    behind = session_of(base, f"png_counts_behind_{bands}_{grad}",
                        async_png_writes=True)
    behind.colorize(IMAGE_ID, BG_TEXT)
    behind.flush()
    counted = [(e[0], e.counts) for e in behind.trace_events
               if "png_writes" in e.counts]
    assert counted == [("png_encode", want)] * 2


def _result_files(tmp, name):
    root = tmp / name
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


def test_tracing_off_records_nothing_and_changes_no_byte(base,
                                                         device_gradient):
    tmp, _ = base
    for name, trace in (("bytes_on", True), ("bytes_off", False)):
        session = session_of(base, name, trace=trace)
        session.colorize(IMAGE_ID, "the bus is yellow")
        session.colorize_stream(IMAGE_ID, QUEUE)
        session.withdraw(IMAGE_ID)
        session.colorize(IMAGE_ID, BG_TEXT)
        assert (session.trace_events != []) == trace
        assert (session.tracer is None) != trace
    on, off = _result_files(tmp, "bytes_on"), _result_files(tmp, "bytes_off")
    assert sorted(on) == sorted(off) and len(on) > 5
    for path in on:
        assert on[path] == off[path], path


def test_a_train_step_records_its_phases_and_changes_no_byte():
    cfg = tconfig.MatchingConfig(vf_h=6, vf_w=6, H=48, W=48, vocab_size=12,
                                 w_emb_dim=16, v_emb_dim=16, m_rnn_size=8,
                                 w_rnn_size=16, max_len=5)
    torch.manual_seed(0)
    model = RMI(cfg)
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.uniform(-120, 130, (1, 48, 48, 3))
                                  .astype(np.float32)),
        "words": torch.tensor([[3, 4, 5, 0, 0]], dtype=torch.int32),
        "seq_len": torch.tensor([3], dtype=torch.int32),
        "target_mask": torch.from_numpy(
            (rng.random((1, 48, 48, 1)) < 0.3).astype(np.float32))}
    tracer = Tracer()
    states, costs = [], []
    for trace in (tracer, None):
        state = create_matching_state(copy.deepcopy(model), cfg)
        step = make_matching_train_step(cfg, trace=trace)
        for _ in range(2):
            state, metrics = step(state, batch)
        states.append(state)
        costs.append(float(metrics["cost"]))
    assert costs[0] == costs[1]
    for (name, a), (_, b) in zip(states[0].model.state_dict().items(),
                                 states[1].model.state_dict().items()):
        assert torch.equal(a, b), name
    assert [e[0] for e in tracer.events] == \
        ["forward", "backward", "adam", "step"] * 2
    roots = [e for e in tracer.events if e.parent is None]
    assert [e.req for e in roots] == [0, 1]        # the state's step
    for e in tracer.events:
        if e.parent is not None:
            assert e.parent == roots[e.req].id


def test_spans_nest_per_thread_and_self_times_add_up():
    tracer = Tracer()
    with tracer.command("cmd:x") as root:
        with span(tracer, "a"):
            with span(tracer, "b") as b:
                b.count("n", 2)
        tracer.count("hit", root=True)
        tracer.count("hit", root=True)
        with tracer.command("cmd:inner"):     # a command inside a command
            pass

    def work():
        with span(tracer, "png", parent=root):
            pass
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    by = {e[0]: e for e in tracer.events}
    assert by["b"].parent == by["a"].id and by["a"].parent == root.id
    assert by["cmd:inner"].parent == root.id and by["png"].parent == root.id
    assert {e.req for e in tracer.events} == {root.req}
    assert by["b"].counts == {"n": 2} and by["cmd:x"].counts == {"hit": 2}
    ms = {e[0]: (e[2] - e[1]) * 1e3 for e in tracer.events}
    assert self_ms(tracer.events) == pytest.approx({
        "a": ms["a"] - ms["b"], "b": ms["b"], "cmd:inner": ms["cmd:inner"],
        "png": ms["png"]})
    assert span(None, "off") is NO_SPAN and NO_SPAN.count("n") is None
    label, t0, t1 = by["a"]
    assert (label, t0, t1) == tuple(by["a"])
