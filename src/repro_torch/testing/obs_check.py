"""Observability smoke check: traced dispatch -> spans, metrics, merge
(counterpart of ``repro.testing.obs_check``).

    python -m repro_torch.testing.obs_check [OUTER INNER] [--device cpu]

One planned SCAN dispatches through an ``OffloadEngine`` in sim mode over
an (OUTER, INNER) mesh shape (default (2, 2)) on the card, or on the CPU
with ``--device cpu``, twice: once with the default no-op tracer (the
baseline) and once under a collecting :mod:`repro_torch.obs.tracing` tracer.
The check then asserts the whole observability contract at once:

  * the traced result is **bitwise identical** to the untraced baseline —
    tracing must never change the computation;
  * the span tree is well-formed: an ``engine.offload`` root, >= 1
    ``phase`` span, and for every *communication* phase span (one that
    reports ``rounds > 0``) exactly as many ``round`` spans whose
    ``parent_id`` is that phase as the phase reported;
  * every span nests inside its parent's [start, end] window;
  * ``EngineTelemetry.snapshot()`` exposes the reference's keys, the
    profiler-fallback counters included;
  * the Prometheus rendering holds the engine dispatch counter and the
    per-round latency histogram;
  * a profiled dispatch merges with the host spans into one Perfetto trace.
    On a card the profiler must deliver (``source == "profiler"``, device
    events merged, clocks aligned); on the CPU there is no device event,
    so the dispatch must come back ``"wall"`` with the reason counted.

Prints an ``obs_check_summary`` CSV row and ALL-OK; exits nonzero on any
violation.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import List

import numpy as np
import torch

from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.offload import OffloadEngine

#: snapshot keys dashboards read (the reference's)
SNAPSHOT_KEYS = (
    "hits",
    "misses",
    "hit_rate",
    "dispatches",
    "compiles",
    "errors",
    "cache_size",
    "cache_clears",
    "calls_by_coll",
    "mean_latency_us",
    "last_latency_us",
    "latency_by_coll_us",
    "device_latency_by_coll_us",
    "latency_source_by_coll",
    "profiler_fallbacks",
    "profiler_fallback_reasons",
)


def main(argv: List[str]) -> int:
    parser = argparse.ArgumentParser(prog="repro_torch.testing.obs_check")
    parser.add_argument("sizes", nargs="*", type=int, default=[2, 2])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    axes = tuple(args.sizes)
    p = int(np.prod(axes))
    n = 16
    rng = np.random.default_rng(7)
    eng = OffloadEngine(device=args.device)
    x = torch.from_numpy(
        rng.integers(-5, 6, size=(p, n)).astype(np.float32)
    ).to(eng.device)
    failures = 0

    def check(name, ok):
        nonlocal failures
        print(f"obs {name:42s} {'OK' if ok else 'FAIL'}")
        failures += 0 if ok else 1

    desc = eng.make_descriptor(
        "scan", axes=axes, payload_bytes=n * 4, op="sum", optimize=True,
    )

    baseline = eng.offload(desc, x)
    check("noop tracer leaves no spans", isinstance(
        obs_tracing.get_tracer(), obs_tracing.NoopTracer,
    ))

    with obs_tracing.tracing() as tracer:
        traced = eng.offload(desc, x)
    check("traced result bitwise == untraced", torch.equal(traced, baseline))

    spans = tracer.spans()
    by_id = {s.span_id: s for s in spans}
    phase_spans = [s for s in spans if s.cat == "phase"]
    round_spans = [s for s in spans if s.cat == "round"]
    check("engine.offload span present", any(
        s.name == "engine.offload" and s.cat == "engine" for s in spans
    ))
    check(">= 1 phase span", len(phase_spans) >= 1)
    check(">= 1 round span", len(round_spans) >= 1)

    comm_phases = [s for s in phase_spans if s.args.get("rounds", 0) > 0]
    check(">= 1 communication phase", len(comm_phases) >= 1)
    rounds_ok = True
    for ph in comm_phases:
        children = [r for r in round_spans if r.parent_id == ph.span_id]
        if len(children) != ph.args.get("rounds") or not children:
            rounds_ok = False
            print(
                f"  phase {ph.name}: {len(children)} round spans, "
                f"reported rounds={ph.args.get('rounds')}"
            )
    check("each comm phase owns its round spans", rounds_ok)

    nesting_ok = True
    for s in spans:
        parent = by_id.get(s.parent_id)
        if parent is None:
            continue
        if not (
            parent.start_us <= s.start_us
            and s.end_us <= parent.end_us + 1e-3
        ):
            nesting_ok = False
            print(f"  span {s.name} escapes parent {parent.name}")
    check("spans nest inside their parents", nesting_ok)

    snap = eng.telemetry.snapshot()
    check("snapshot keys intact", all(k in snap for k in SNAPSHOT_KEYS))

    prom = obs_metrics.render_prometheus()
    check("prometheus: engine dispatch counter", (
        "repro_engine_dispatches_total" in prom
    ))
    check("prometheus: per-round histogram", (
        "repro_round_latency_us_bucket" in prom
    ))

    # host+device merge: profile one dispatch while the tracer collects
    with obs_tracing.tracing() as tracer:
        with tempfile.TemporaryDirectory() as td:
            timing = eng.profile_offload(desc, x, trace_dir=td)
            host = obs_export.spans_to_chrome(tracer.spans())
            merged = host
            aligned = False
            if timing.source == "profiler" and timing.trace_path:
                device = obs_export.load_chrome_trace(timing.trace_path)
                merged = obs_export.merge_device_trace(host, device)
                aligned = bool(merged.get("deviceClockAligned"))
    n_device = sum(
        1 for e in merged.get("traceEvents", [])
        if e.get("pid") == obs_export.DEVICE_PID and e.get("ph") == "X"
    )
    check("merged trace has host spans", any(
        e.get("pid") == obs_export.HOST_PID and e.get("ph") == "X"
        for e in merged.get("traceEvents", [])
    ))
    if eng.device.type == "cuda":
        check("profiled dispatch measured on the device",
              timing.source == "profiler")
        check("merged trace has device events", n_device > 0)
        check("device clock aligned to host", aligned)
    else:
        check("CPU profile falls back to wall, reason counted", (
            timing.source == "wall"
            and eng.telemetry.snapshot()["profiler_fallback_reasons"].get(
                timing.fallback_reason, 0) >= 1
        ))

    print(
        f"obs_check_summary,bitwise_equal,"
        f"{int(torch.equal(traced, baseline))},"
        f"phase_spans,{len(phase_spans)},round_spans,{len(round_spans)},"
        f"comm_phases,{len(comm_phases)},device_events,{n_device},"
        f"source,{timing.source}"
    )
    if failures:
        print(f"FAILURES: {failures}")
        return 1
    print("ALL-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
