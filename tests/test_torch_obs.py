"""``repro_torch.obs`` (metrics, events, tracing, export) and the engine's
traced dispatch against ``repro.obs`` and the reference engine.

* ``render_prometheus`` text is identical for the same metric operations.
* Flight-recorder dumps are equal apart from timestamps.
* ``spans_to_chrome`` / ``chrome_to_spans`` round-trip to the reference's
  output, event for event.
* A traced sim dispatch (device ``cpu``; the fused backend runs K1's plain
  version, the reference Pallas interpret mode) gives the reference's span
  names, categories, arguments and parent structure (beside the port's own
  dispatch spans, each once under ``engine.offload``), on the default and
  the ``"pallas"`` backend, chunked and unchunked; its result is bitwise
  equal to the untraced dispatch's and to the reference's. Float32 sums on
  small integers: exact, no tolerance.
* ``merge_device_trace`` aligns a ``torch.profiler``-format device trace on
  the annotation span and degrades like the reference on a bad file.
"""

import numpy as np
import pytest
import torch

from repro.core.selector import set_active_tuning as j_set_tuning
from repro.obs import events as jevents
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import tracing as jtracing
from repro.offload import OffloadEngine as JEngine
from repro_torch.core.selector import set_active_tuning as t_set_tuning
from repro_torch.obs import events as tevents
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import tracing as ttracing
from repro_torch.offload import OffloadEngine as TEngine
from test_torch_interop import to_both


@pytest.fixture(autouse=True)
def _fresh():
    j_set_tuning(None)
    t_set_tuning(None)
    jprev = jmetrics.set_registry(jmetrics.MetricsRegistry())
    tprev = tmetrics.set_registry(tmetrics.MetricsRegistry())
    yield
    jmetrics.set_registry(jprev)
    tmetrics.set_registry(tprev)


def _metric_ops(m):
    reg = m.MetricsRegistry()
    c = reg.counter("repro_engine_dispatches_total", "engine dispatches",
                    labelnames=("coll",))
    for coll in ("scan", "scan", "reduce", 'we"ird\\name'):
        c.inc(coll=coll)
    c.inc(2.5, coll="scan")
    g = reg.gauge("repro_cache_size", "entries")
    g.set(3)
    g.inc(-1.25)
    h = reg.histogram("repro_engine_device_latency_us", "device latency",
                      labelnames=("coll",))
    for v in (0.5, 5.0, 7.25, 99.0, 1e6, 250.0):
        h.observe(v, coll="scan")
    h2 = reg.histogram("repro_small", "", buckets=(1.0, 2.0))
    h2.observe(1.5)
    m.observe_round("scan", "SCAN", 0, 12.0, registry=reg)
    m.observe_round("scan", "SCAN", 9, 3.0, registry=reg)
    m.observe_phase("scan", "SCAN", 40.0, registry=reg)
    with pytest.raises(ValueError):
        reg.gauge("repro_engine_dispatches_total")
    with pytest.raises(ValueError):
        c.inc(-1, coll="scan")
    return reg


def test_prometheus_text_identical():
    t, j = _metric_ops(tmetrics), _metric_ops(jmetrics)
    assert tmetrics.render_prometheus(t) == jmetrics.render_prometheus(j)
    assert t.collect() == j.collect()
    for i in (0, 3, 4, 7, 8, 100, 1 << 20):
        assert tmetrics.round_bucket(i) == jmetrics.round_bucket(i)


def _recorder_ops(ev, tmp_path, name):
    rec = ev.FlightRecorder(capacity=4)
    rec.record("dispatch", coll="scan", cache="miss", latency_us=12.5)
    rec.record("cache_miss", coll="scan", scope="schedule")
    for i in range(4):
        rec.record("profiler_fallback", reason=f"r{i}")
    rec.dump(tmp_path / name / "dump.json", reason="test")
    blocker = tmp_path / f"{name}.file"
    blocker.write_text("")
    rec.dump(blocker / "x.json", reason="bad")  # logged into the ring
    return rec


def _strip_times(snap):
    snap = dict(snap)
    snap.pop("wall_time")
    snap["events"] = [
        {k: (k if k == "error" else v) for k, v in e.items()
         if k not in ("t", "ts_us", "path")}
        for e in snap["events"]
    ]
    return snap


def test_flight_recorder_dumps_equal_apart_from_timestamps(tmp_path):
    t = _recorder_ops(tevents, tmp_path, "t")
    j = _recorder_ops(jevents, tmp_path, "j")
    assert _strip_times(t.snapshot("x")) == _strip_times(j.snapshot("x"))
    assert t.counts() == j.counts()
    assert len(t) == len(j) == 4
    assert [e["kind"] for e in t.events(limit=2)] == [
        e["kind"] for e in j.events(limit=2)]
    assert (tmp_path / "t" / "dump.json").exists()


def _spans(tr):
    tracer = tr.Tracer()
    with tracer.span("engine.offload", "engine", coll="scan") as s:
        s.set(cache="miss")
        with tracer.span("engine.compile", "engine"):
            pass
        tracer.add_span("plan.phase:SCAN:L0", "phase", 10.0, 20.5,
                        parent_id=tracer.current_span_id(), rounds=2)
    tr.add_kernel_round_spans(tracer, phase="SCAN:L1", coll="scan",
                              rounds=3, start_us=100.0, end_us=103.0)
    return tracer.spans()


def _normalized(trace):
    out = []
    for e in trace["traceEvents"]:
        e = dict(e)
        if e.get("ph") == "X" and e["name"].startswith("engine."):
            e["ts"] = e["dur"] = 0  # measured on the clock
        out.append(e)
    return out


def test_chrome_round_trip_equals_the_references():
    tspans, jspans = _spans(ttracing), _spans(jtracing)
    tchrome = texport.spans_to_chrome(tspans)
    jchrome = jexport.spans_to_chrome(jspans)
    # the thread id is this process's in both; the clock-read spans differ
    assert _normalized(tchrome) == _normalized(jchrome)
    back = texport.chrome_to_spans(tchrome)
    assert [(s.name, s.cat, s.span_id, s.parent_id, s.args) for s in back] \
        == [(s.name, s.cat, s.span_id, s.parent_id, s.args) for s in tspans]
    jback = jexport.chrome_to_spans(jchrome)
    assert [(s.name, s.cat, s.parent_id, s.args) for s in back] == [
        (s.name, s.cat, s.parent_id, s.args) for s in jback]


#: the port's own spans inside a dispatch, which the reference lacks
PORT_SPANS = ("engine.prepare", "engine.drain", "engine.schedule",
              "engine.wait", "engine.record")


def _structure(spans, skip=()):
    """Span names, categories, arguments and parent names, in id order;
    the spans named in ``skip`` left out, their children hung on the
    nearest ancestor kept."""
    by_id = {s.span_id: s for s in spans}

    def kept_parent(s):
        parent = by_id.get(s.parent_id)
        while parent is not None and parent.name in skip:
            parent = by_id.get(parent.parent_id)
        return parent

    rows = []
    for s in sorted(spans, key=lambda s: s.span_id):
        if s.name in skip:
            continue
        parent = kept_parent(s)
        rows.append((s.name, s.cat, None if parent is None else parent.name,
                     dict(s.args)))
    return rows


CASES = [
    # (axes, backend, optimize, chunks)
    ((1, 8), "pallas", False, 1),
    ((1, 8), "pallas", True, 1),
    ((2, 4), "", True, 1),
    ((2, 4), "", False, 2),
    ((2, 2, 2), "", True, 1),
]


@pytest.mark.parametrize("axes,backend,optimize,chunks", CASES, ids=str)
@pytest.mark.parametrize("coll", ["SCAN", "EXSCAN", "ALLREDUCE"])
def test_traced_dispatch_matches_the_reference(coll, axes, backend, optimize,
                                               chunks):
    p = int(np.prod(axes))
    x = np.random.default_rng(3).integers(-5, 6, size=(p, 16)).astype(
        np.float32)
    jx, tx = to_both(x)
    je, te = JEngine(), TEngine(device="cpu")
    kw = dict(axes=axes, payload_bytes=64, backend=backend or "auto",
              optimize=optimize, chunks=chunks)
    dj, dt = je.make_descriptor(coll, **kw), te.make_descriptor(coll, **kw)
    assert dt.encode().tobytes() == dj.encode().tobytes()
    jbase, tbase = np.asarray(je.offload(dj, jx)), te.offload(dt, tx)
    with jtracing.tracing() as jtr:
        jgot = np.asarray(je.offload(dj, jx))
    with ttracing.tracing() as ttr:
        tgot = te.offload(dt, tx)
    assert np.array_equal(tgot.numpy(), tbase.numpy())
    assert np.array_equal(tgot.numpy(), jgot)
    assert np.array_equal(jgot, jbase)
    got = _structure(ttr.spans(), skip=PORT_SPANS)
    assert got == _structure(jtr.spans())
    # the port's own spans: each once, a child of engine.offload
    own = [(name, parent) for name, _, parent, _ in _structure(ttr.spans())
           if name in PORT_SPANS]
    assert own == [(name, "engine.offload") for name in PORT_SPANS]
    assert any(cat == "round" for _, cat, _, _ in got)
    # a second traced dispatch hits the traced schedule: no compile span
    with ttracing.tracing() as ttr2:
        te.offload(dt, tx)
    names = [s.name for s in ttr2.spans()]
    assert "engine.compile" not in names and "engine.offload" in names
    assert te.telemetry.snapshot() ["compiles"] == je.telemetry.compiles


def test_noop_tracer_records_nothing_and_keeps_the_cache():
    te = TEngine(device="cpu")
    d = te.make_descriptor("SCAN", axes=(2, 4), payload_bytes=64)
    x = torch.ones(8, 16)
    te.offload(d, x)
    assert isinstance(ttracing.get_tracer(), ttracing.NoopTracer)
    assert te.cache_size() == 1
    with ttracing.tracing():
        te.offload(d, x)
    assert te.cache_size() == 2  # the traced schedule has its own key
    te.offload(d, x)
    assert te.cache_size() == 2 and te.telemetry.hits == 1


def _device_trace(tag, host_ts):
    return {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": tag, "ts": host_ts,
         "dur": 50.0, "pid": 7, "tid": 7, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": host_ts + 5, "dur": 3.0, "pid": 7, "tid": 7,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k1_register_kernel",
         "ts": host_ts + 9, "dur": 2.0, "pid": 0, "tid": 7,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset",
         "ts": host_ts + 12, "dur": 1.0, "pid": 0, "tid": 7,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty",
         "ts": host_ts + 1, "dur": 1.0, "pid": 7, "tid": 7, "args": {}},
    ]}


def test_merge_aligns_on_the_annotation(tmp_path):
    tag = "repro_offload:scan:p8"
    tracer = ttracing.Tracer()
    tracer.add_span(tag, "profile", 500.0, 550.0, annotation=True)
    host = texport.spans_to_chrome(tracer.spans())
    merged = texport.merge_device_trace(host, _device_trace(tag, 1e9))
    assert merged["deviceClockAligned"] is True
    assert merged["deviceEventsMerged"] == 2
    dev = [e for e in merged["traceEvents"]
           if e.get("pid") == texport.DEVICE_PID and e.get("ph") == "X"]
    assert [e["ts"] for e in dev] == [509.0, 512.0]
    assert all(e["args"]["source"] == "torch.profiler" for e in dev)
    # no common event: unaligned, unshifted
    merged = texport.merge_device_trace(host, _device_trace("other", 7.0))
    assert merged["deviceClockAligned"] is False
    # a bad file degrades like the reference's
    bad = tmp_path / "bad.json"
    bad.write_text("{oops")
    tm = texport.merge_device_trace(host, str(bad))
    jm = jexport.merge_device_trace(host, str(bad))
    assert tm["deviceEventsMerged"] == jm["deviceEventsMerged"] == 0
    assert tm["deviceClockAligned"] is jm["deviceClockAligned"] is False
    assert set(tm) == set(jm)
    path = texport.write_trace(tmp_path / "m.json", merged)
    assert texport.load_chrome_trace(path)["traceEvents"]
