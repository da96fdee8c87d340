"""The port's spans (``repro_torch.obs.tracing.span``) on their three sinks:

* the counter: each span of a CPU sim dispatch of the ``osu8`` descriptor,
  of a tiny Mamba2 training step and of a prefill counts once a call, and
  nothing counts while a ``torch.profiler`` session records;
* the profiler: under a CPU profiler session the dispatch's spans are
  ``user_annotation`` ranges nested inside ``engine.offload``, the schedule
  cache gains no ``|traced`` key and the result is bitwise the unprofiled
  one;
* the Prometheus series the totals publish, and the two benchmark readers
  (``portbench/metrics``) over a known counter state.

The card test (``-m card``) counts ``k1.stage`` and ``k1.launch`` against
K1's own launch count.
"""

import json
import sys
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import fused_collective
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.models import build_model
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import tracing as ttracing
from repro_torch.offload import OffloadEngine
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.sharding.specs import Topology

ROOT = Path(__file__).resolve().parents[1]
P, N = 8, 64
ENGINE_SPANS = ("engine.offload", "engine.prepare", "engine.drain",
                "engine.schedule", "engine.wait", "engine.record")
STEP_SPANS = ("step.train", "step.forward", "step.backward", "step.optimizer")


def counts():
    return {name: c for name, (c, _) in ttracing.span_totals().items()}


def added(before, after):
    return {name: after[name] - before.get(name, 0) for name in after
            if after[name] != before.get(name, 0)}


def osu8(device="cpu"):
    """The osu8 cell's descriptor (axes (1, 8), fused backend, one chunk)
    at a small payload."""
    eng = OffloadEngine(device=device)
    desc = eng.make_descriptor("SCAN", axes=(1, P), payload_bytes=N * 4,
                               op="sum", backend="pallas", chunks=1)
    x = torch.arange(P * N, dtype=torch.float32, device=device).reshape(P, N)
    return eng, desc.encode(), x


def test_sim_dispatch_counts_each_engine_span_once():
    eng, words, x = osu8()
    before = counts()
    eng.offload(words, x)  # a miss: compiles
    assert added(before, counts()) == {**{n: 1 for n in ENGINE_SPANS},
                                       "engine.compile": 1}
    before = counts()
    out = eng.offload(words, x)  # a repeat: a prepared dispatch
    assert added(before, counts()) == {**{n: 1 for n in ENGINE_SPANS},
                                       "engine.reuse": 1}
    assert torch.equal(out, torch.cumsum(x, 0))
    before = counts()
    with profile(activities=[ProfilerActivity.CPU]):
        eng.offload(words, x)
    assert counts() == before


def test_profiled_dispatch_nests_its_spans_as_ranges(tmp_path):
    eng, words, x = osu8()
    want = eng.offload(words, x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = eng.offload(words, x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith("engine.")]
    (outer,) = [e for e in events if e["name"] == "engine.offload"]
    inner = sorted((e for e in events if e is not outer), key=lambda e: e["ts"])
    # a repeat: the prepared dispatch's engine.reuse inside engine.prepare
    assert [e["name"] for e in inner] == [ENGINE_SPANS[1], "engine.reuse",
                                          *ENGINE_SPANS[2:]]
    for e in inner:
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    assert not any(key.endswith(b"|traced") for key in eng._cache)
    assert eng.cache_size() == 1
    assert torch.equal(got, want)


def test_collecting_tracer_keeps_the_new_spans_too():
    eng, words, x = osu8()
    eng.offload(words, x)
    with ttracing.tracing() as tracer:
        eng.offload(words, x)
    spans = tracer.spans()
    by_id = {s.span_id: s for s in spans}
    parents = {s.name: by_id[s.parent_id].name for s in spans
               if s.name in ENGINE_SPANS[1:]}
    assert parents == {n: "engine.offload" for n in ENGINE_SPANS[1:]}
    # the traced schedule is a miss: its compile sits inside the prepare
    (compile_,) = [s for s in spans if s.name == "engine.compile"]
    assert by_id[compile_.parent_id].name == "engine.prepare"
    assert any(key.endswith(b"|traced") for key in eng._cache)


def tiny_mamba():
    cfg = get_config("mamba2_130m").reduced()
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen)
    batch = {"tokens": ids[:, :-1].to(torch.int32),
             "labels": ids[:, 1:].to(torch.int32)}
    return cfg, api, model, batch


def test_training_step_and_prefill_count_each_step_span_once():
    cfg, api, model, batch = tiny_mamba()
    step, _, _ = build_train_step(api, Topology(mesh=None),
                                  ShapeConfig("t", 32, 2, "train"),
                                  AdamWConfig())
    opt = init_opt_state(model)
    before = counts()
    model, opt, metrics = step(model, opt, batch)
    got = added(before, counts())
    assert {n: got.get(n) for n in STEP_SPANS} == {n: 1 for n in STEP_SPANS}
    assert "step.prefill" not in got
    # K3's segment scans, forward and backward, each in a k3.call span
    assert got["k3.call"] > 0
    assert torch.isfinite(metrics["loss"])
    prefill, _, _ = build_prefill_step(api, Topology(mesh=None),
                                       ShapeConfig("p", 32, 2, "prefill"))
    before = counts()
    prefill(model, {"tokens": batch["tokens"]})
    got = added(before, counts())
    assert got.get("step.prefill") == 1
    assert not set(got) & set(STEP_SPANS)


def test_totals_publish_on_the_process_registry():
    with ttracing.span("test.published", "host"):
        pass
    n = ttracing.span_totals()["test.published"][0]
    text = tmetrics.render_prometheus()
    assert f'repro_span_total{{span="test.published"}} {n}' in text
    assert 'repro_span_seconds_total{span="test.published"}' in text
    prev = tmetrics.set_registry(tmetrics.MetricsRegistry())
    try:
        assert 'repro_span_total{span="test.published"}' in (
            tmetrics.render_prometheus())
    finally:
        tmetrics.set_registry(prev)
    # a registry nobody installed keeps to its own series
    assert tmetrics.MetricsRegistry().render() == ""


def test_counts_lose_no_update_across_threads():
    threads, each = 16, 500
    before = ttracing.span_totals().get("test.threads", (0, 0))[0]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with ttracing.span("test.threads"):
                    pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert ttracing.span_totals()["test.threads"][0] - before == threads * each


def reader(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import bench

    return bench.load_module("metrics", name).read


def test_readers_on_a_known_counter_state(monkeypatch):
    engine_host_us = reader("engine_host_us.scan")
    optimizer_host_ms = reader("optimizer_host_ms.train")
    known = {"engine.offload": (10, 5_000_000), "engine.compile": (1, 1_000_000),
             "engine.drain": (10, 500_000), "engine.wait": (10, 2_000_000),
             "engine.prepare": (10, 400_000), "step.optimizer": (4, 20_000_000)}
    monkeypatch.setattr(ttracing, "span_totals", lambda: known)
    # (5e6 - 1e6 - 0.5e6 - 2e6) ns over 10 calls
    assert engine_host_us(None) == pytest.approx(150.0)
    assert optimizer_host_ms(None) == pytest.approx(5.0)
    monkeypatch.setattr(ttracing, "span_totals", dict)
    assert engine_host_us(None) is None and optimizer_host_ms(None) is None
    # a program without span counters (the module lacks span_totals)
    monkeypatch.delattr(ttracing, "span_totals")
    assert engine_host_us(None) is None and optimizer_host_ms(None) is None


@pytest.mark.card
def test_k1_stage_and_launch_count_once_per_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 runs only there")
    eng, words, x = osu8("cuda")
    eng.offload(words, x)
    before, launches = counts(), fused_collective.launches
    for _ in range(3):
        out = eng.offload(words, x)
    torch.cuda.synchronize()
    made = fused_collective.launches - launches
    got = added(before, counts())
    assert made == 3
    assert got["k1.stage"] == got["k1.launch"] == made
    assert torch.equal(out.cpu(), torch.cumsum(x.cpu(), 0))
