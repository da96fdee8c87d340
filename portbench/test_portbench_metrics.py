"""The metric arithmetic, on synthetic profiler events and windows."""

from __future__ import annotations

import statistics

import pytest

from portbench import bench, trace
from portbench.bench import Measured
from portbench.reference import flops, peaks


def kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def host(name, ts, dur, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def metric(name, run):
    return bench.load_module("metrics", name).read(run)


def test_union_merges_overlaps():
    busy, merged = trace.union_us([(0, 10), (5, 12), (20, 30), (30, 31)])
    assert busy == 23 and merged == [(0, 12), (20, 31)]


def test_summary_of_a_device_trace():
    # a window of 1000 us from the first device record: two K1 launches,
    # a copy overlapping the second, nothing else
    events = [kernel("k1_register_kernel<float>", 100, 300),
              kernel("k1_register_kernel<float>", 600, 300),
              kernel("Memcpy DtoD", 800, 200, cat="gpu_memcpy"),
              host("aten::add", 0, 50)]
    s = trace.summarize(events, 0.0, 1000.0, anchored=False)
    assert s["window_s"] == pytest.approx(1e-3)
    # union: [100, 400] + [600, 1000] (the copy runs to 1000)
    assert s["busy_s"] == pytest.approx(700e-6)
    assert trace.kernel_time(s, "k1_") == (2, pytest.approx(600e-6))
    assert s["kernels"]["Memcpy DtoD"][:2] == [1, pytest.approx(200e-6)]


def test_gaps_are_labelled_by_the_innermost_host_event():
    events = [host("portbench.window", 0, 1000, cat="user_annotation"),
              host("portbench.call", 0, 500, cat="user_annotation"),
              host("aten::copy_", 100, 100),
              kernel("k", 300, 100), kernel("k", 700, 300)]
    s = trace.summarize(events)
    gaps = s["idle_gaps"]
    # [0, 300): middle 150 under aten::copy_; [400, 700): middle 550 under
    # nothing but the window
    assert gaps["aten::copy_"] == pytest.approx(300e-6)
    assert gaps["host: none"] == pytest.approx(300e-6)
    assert trace.summarize([kernel("k", 0, 1)]) is None


def run_with(trace_summary, **kw):
    base = dict(window_s=2.0, calls=1000, facts={"ranks": 8, "count": 1 << 24, "itemsize": 4})
    base.update(kw)
    return Measured(traces=[trace_summary] if trace_summary else [], **base)


def summary(busy_s, window_s, calls, kernels):
    return {"busy_s": busy_s, "window_s": window_s, "calls": calls, "kernels": kernels,
            "idle_gaps": {}}


def test_k1_roofline_share():
    bound = flops.scan_bound_s(8, 1 << 24, 4)
    assert bound == pytest.approx(2 * 8 * (1 << 24) * 4 / peaks.HBM_BYTES_S)
    # K1 at twice its bound a call, 500 calls traced
    s = summary(0.5, 1.0, 500, {"k1_register_kernel": [500, 500 * 2 * bound, "kernel"]})
    assert metric("k1_roofline_share", run_with(s)) == pytest.approx(50.0)
    assert metric("k1_roofline_share", run_with(summary(0.5, 1.0, 500, {}))) is None
    assert metric("k1_roofline_share", run_with(None)) is None


def test_host_time_and_idle_share_use_the_untraced_window():
    # measured: 1000 calls in 2 s (2 ms a call); traced: the card busy
    # 1.2 ms a call
    s = summary(0.6, 1.0, 500, {"k": [500, 0.6, "kernel"]})
    run = run_with(s)
    assert metric("dispatch_host_us.scan", run) == pytest.approx(800.0)
    assert metric("device_idle_share.scan", run) == pytest.approx(40.0)
    assert metric("device_idle_share.tokens", run) == pytest.approx(40.0)
    idle = summary(0.0, 1.0, 500, {})
    assert metric("device_idle_share.scan", run_with(idle)) is None


def test_mfu_and_launches_per_step():
    f = 1e13
    s = summary(1.0, 1.0, 2, {"a": [30, 0.5, "kernel"], "b": [10, 0.5, "kernel"],
                              "c": [99, 0.1, "gpu_memset"]})
    run = run_with(s, window_s=10.0, calls=20, facts={"flops_per_call": f})
    assert metric("mfu", run) == pytest.approx(100 * f * 20 / (10.0 * peaks.BF16_FLOPS))
    assert metric("launches_per_step", run) == 20.0
    assert metric("mfu", run_with(None, facts={"flops_per_call": f})) is None


def test_end_to_end_readers():
    lat = [i * 1e-6 for i in range(1, 101)]
    run = Measured(setup_s=3.5, window_s=2.0, calls=100, latencies_s=lat,
                   units={"bytes": 4e9, "tokens": 1e5})
    assert metric("setup_s", run) == 3.5
    assert metric("scan_gbps", run) == pytest.approx(2.0)
    assert metric("tokens_per_s", run) == pytest.approx(5e4)
    want = statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e6
    assert metric("scan_p95_us", run) == pytest.approx(want)
    assert 95.0 <= want <= 96.0
    assert metric("scan_p95_us", Measured(latencies_s=lat[:10])) is None


def test_checks_keep_the_worst_and_fail_on_nan():
    checks = bench.worst([bench.Check("a", 1.0, 2.0), bench.Check("a", 3.0, 2.0),
                          bench.Check("b", float("nan"), 1.0)])
    by = {c.name: c for c in checks}
    assert by["a"].value == 3.0 and not by["a"].ok and not by["b"].ok


def test_mamba2_flops_by_hand():
    c = {"d_model": 4, "expand": 2, "d_state": 2, "headdim": 2, "chunk_size": 2,
         "d_conv": 4, "n_layer": 1, "vocab_size": 10, "pad_vocab_size_multiple": 8}
    # d 4, di 8, N 2, H 4, P 2, Q 2; one row of 4 tokens, head at 1 position
    per_token = 2 * 4 * (16 + 4 + 4) + 2 * 4 * (8 + 4) + 2 * 8 * 4
    per_chunk = 3 * (2 * 2 + 2 * 4 * 2) + 4 * 2 * 4 * 2 * 2 + 2 * 4 * 2 * 2
    want = 4 * per_token + 2 * per_chunk + 2 * 4 * 10
    assert flops.mamba2_forward_flops(c, 1, 4, 1) == want
    full = flops.mamba2_forward_flops(c, 1, 4, 4)
    assert flops.mamba2_train_flops(c, 1, 4) == 3 * full
