"""Metric arithmetic on synthetic runs: the p95 over all commands, window
rates, the idle share and gaps of a synthetic timeline, kernel families,
and the work counters against PERF.md's numbers at the RMI shape."""
import pytest

from benchmark import harness, trace, work
from benchmark.record import Run


def read(name, run):
    return harness.metric_reader(name)(run)


def test_rates_and_tail_cover_every_command():
    run = Run(window_s=10.0, walls_s=[0.05] * 95 + [0.3] * 5,
              kinds=["fg"] * 100, attempted=100)
    assert read("commands_per_s", run) == pytest.approx(10.0)
    assert read("command_p95_ms", run) == pytest.approx(50.0)
    run.walls_s[-6:] = [0.3] * 6
    assert read("command_p95_ms", run) == pytest.approx(300.0)
    assert read("bg_command_p95_ms", run) == read("command_p95_ms", run)
    # a failed command is missing: it counts as infinitely late
    run.walls_s = [0.05] * 94 + [float("inf")] * 6
    run.failed = 6
    assert read("commands_per_s", run) == pytest.approx(9.4)
    assert read("command_p95_ms", run) is None
    assert read("train_step_ms", run) is None


def test_train_step_is_the_window_over_the_steps():
    assert read("train_step_ms", Run(window_s=8.0, steps=100)) == \
        pytest.approx(80.0)
    assert read("commands_per_s", Run(window_s=8.0, steps=100)) is None


def test_idle_share_and_gaps_of_a_synthetic_timeline():
    kernels = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 3.5),
               ("a", 6.0, 7.0)]
    spans = [("command:fg", 0.0, 4.0), ("command:bg", 4.0, 10.0)]
    stages = [("bg_save", 8.0, 9.5)]
    busy, bd = trace.breakdown(kernels, spans, stages, 0.0, 10.0)
    assert busy == pytest.approx(3.5)
    run = Run(kernels=kernels, busy_s=busy, traced_window_s=10.0)
    assert read("idle_share.serve", run) == pytest.approx(65.0)
    assert bd["device_ops"][0] == ["a", pytest.approx(2.0)]
    assert bd["idle_gaps"][0] == ["bg_save", pytest.approx(3.0)]
    assert bd["idle_gaps"][1][0] == "command:bg"
    assert read("idle_share.serve", Run()) is None


def test_kernel_family_takes_its_own_layout_launches():
    k = [("lstm_slots_kernel", 0, 1), ("lstm_layout_kernel", 1, 2),
         ("mlstm_stage_kernel<1>(x)", 2, 5),
         ("lstm_slots_kernel", 5, 6), ("mlstm_stage_kernel<0>(x)", 6, 8),
         ("mlstm_bwd_sweep_kernel", 8, 9)]
    own1, shared = ("mlstm_stage_kernel<1>",), ("lstm_slots", "lstm_layout")
    assert trace.attributed_seconds(k, own1, shared, ("mlstm_stage_kernel<0>",),
                                    0, 10) == 5
    assert trace.attributed_seconds(
        k, ("mlstm_stage_kernel<0>", "mlstm_bwd_"), shared,
        ("mlstm_stage_kernel<1>",), 0, 10) == 4


def test_rooflines_read_nothing_without_their_kernels():
    run = Run(work={"b1_bound_s": 1e-3}, window=(0.0, 1.0),
              kernels=[("other", 0.0, 0.5)])
    assert read("roofline.b1.serve", run) is None
    run.kernels.append(("mlstm_stage_kernel<1>", 0.5, 0.504))
    assert read("roofline.b1.serve", run) == pytest.approx(25.0)


def test_bounds_at_the_rmi_shape_are_perf_mds():
    """B1's 3xTF32 bound 0.670 ms and B2's 2.011 ms at N=1, P=9216,
    H=500, T=15 with 7 kept steps (PERF.md's kernel table)."""
    assert work.fwd_bound_s(1, 9216, 500, 15, [7]) * 1e3 == \
        pytest.approx(0.670, abs=5e-4)
    assert work.bwd_bound_s(1, 9216, 500, 15, [7]) * 1e3 == \
        pytest.approx(2.011, abs=5e-4)
    # a row without a kept step needs no product, only its bytes
    assert work.fwd_bound_s(1, 9216, 500, 15, [0]) * 1e3 < 0.05


def test_flop_count_is_the_reference_models_at_the_configured_shapes():
    cfg = harness.load_json("configs", "serve_rmi_mru_resgen768.json")
    m = cfg["framework"]["matching"]
    backbone = work.model_flops("matching", work._js(m), "backbone")
    # DeepLab-v2 ResNet-101 at output stride 8 on 768^2, ~1.0 TFLOP
    assert 0.6e12 < backbone < 1.6e12
    fusion = work.model_flops("matching", work._js(m), "fusion")
    # the pixel term [9216, 1008] x [1008, 2000] dominates; the recurrence
    # is counted apart
    assert 2 * 9216 * 1008 * 2000 <= fusion < 1.2 * 2 * 9216 * 1008 * 2000
    assert work.recurrence_flops(9216, 500, 7) == 2 * 9216 * 500 * 2000 * 6


def test_serving_work_counts_every_completed_instruction():
    """FLOPs and B1 bounds of a window's log, a queue counting each of its
    texts; the backbone once a visit."""
    from benchmark.tests.tiny import tiny_serve_config, tiny_traffic
    from benchmark.traffic import session_commands
    fw = tiny_serve_config()["framework"]
    plan = session_commands.make_plan(tiny_traffic("fg_stream"), 3)
    queue = plan.visits[0].commands[0][1]
    log = [{"visit": 0, "kind": "stream", "ok": True, "texts": queue}]
    one = work.serve_work(fw, plan, log[:0] + [dict(log[0], texts=queue[:1])])
    all8 = work.serve_work(fw, plan, log)
    backbone = work.model_flops("matching", work._js(fw["matching"]),
                                "backbone")
    assert all8["flops"] - backbone == pytest.approx(
        8 * (one["flops"] - backbone), rel=0.2)
    assert all8["b1_bound_s"] > 7 * one["b1_bound_s"] / 1.2
    bg = session_commands.make_plan(tiny_traffic("bg_interactive"), 3)
    texts = [c[1] for c in bg.visits[0].commands]
    got = work.serve_work(fw, bg, [{"visit": 0, "kind": "color", "ok": True,
                                    "texts": [t]} for t in texts])
    assert got["flops"] > 0 and got["b1_bound_s"] > 0
