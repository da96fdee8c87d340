"""Chrome/Perfetto trace export + host/device timeline merge (PyTorch port
of ``repro.obs.export``).

Spans from :mod:`repro_torch.obs.tracing` serialize to the Chrome
trace-event JSON format (``{"traceEvents": [...]}``) that both
``chrome://tracing`` and https://ui.perfetto.dev open directly. Two extras
beyond plain export:

  * **round-trip**: :func:`chrome_to_spans` reconstructs the span list from
    an exported trace, so traces are a faithful wire format for span data,
    not a lossy rendering;
  * **host+device merge**: :func:`merge_device_trace` folds the device
    events (kernels, copies, memsets) of the ``torch.profiler`` chrome trace
    that :mod:`repro_torch.offload.profiling` parses into the host span
    timeline — one trace showing the engine/phase/round spans on the host
    track and the kernels on a device track. The two traces run on
    different clocks (collected spans use ``perf_counter`` µs, the profiler
    its own epoch; the spans a profiler session records itself, as ranges,
    are on its clock already); alignment pins the profiler's ``record_function``
    annotation to the host-side span of the same name, which
    :func:`repro_torch.offload.profiling.profile_offload` emits whenever a
    tracer is installed.

Event mapping: every span becomes one complete ("ph": "X") event whose
``args`` carry the span/parent ids, so parent links survive the round trip.
``pid`` 1 is the host process, ``pid`` 2 the device; thread-name metadata
events label the tracks.
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.tracing import Span

__all__ = [
    "HOST_PID",
    "DEVICE_PID",
    "chrome_to_spans",
    "load_chrome_trace",
    "merge_device_trace",
    "spans_to_chrome",
    "write_trace",
]

HOST_PID = 1
DEVICE_PID = 2


def spans_to_chrome(
    spans: Sequence[Span],
    *,
    process_name: str = "repro-host",
) -> Dict[str, Any]:
    """Serialize spans to a Chrome trace-event dict (Perfetto-openable)."""
    events: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "pid": HOST_PID,
            "tid": 0,
            "name": "process_name",
            "args": {"name": process_name},
        }
    ]
    tids = sorted({s.tid for s in spans})
    tid_map = {t: i for i, t in enumerate(tids)}
    for t, i in tid_map.items():
        events.append(
            {
                "ph": "M",
                "pid": HOST_PID,
                "tid": i,
                "name": "thread_name",
                "args": {"name": f"host-thread-{i}"},
            }
        )
    for s in spans:
        args = dict(s.args)
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        args["host_tid"] = s.tid
        events.append(
            {
                "ph": "X",
                "pid": HOST_PID,
                "tid": tid_map.get(s.tid, 0),
                "name": s.name,
                "cat": s.cat,
                "ts": s.start_us,
                "dur": s.dur_us,
                "args": args,
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ns"}


def chrome_to_spans(trace: Dict[str, Any]) -> List[Span]:
    """Inverse of :func:`spans_to_chrome` for host span events."""
    spans: List[Span] = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("pid") != HOST_PID:
            continue
        args = dict(e.get("args", {}))
        span_id = args.pop("span_id", None)
        if span_id is None:
            continue
        parent_id = args.pop("parent_id", None)
        tid = args.pop("host_tid", e.get("tid", 0))
        spans.append(
            Span(
                name=str(e["name"]),
                cat=str(e.get("cat", "host")),
                start_us=float(e["ts"]),
                dur_us=float(e.get("dur", 0.0)),
                span_id=int(span_id),
                parent_id=None if parent_id is None else int(parent_id),
                tid=int(tid),
                args=args,
            )
        )
    return spans


def load_chrome_trace(path: "str | Path") -> Dict[str, Any]:
    """Read a chrome trace JSON, gzip-compressed or plain."""
    path = Path(path)
    raw = path.read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return json.loads(raw)


def _device_events(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    from repro_torch.offload.profiling import DEVICE_EVENT_CATS

    return [
        e for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENT_CATS
    ]


def _find_event(
    trace: Dict[str, Any], name: str
) -> Optional[Dict[str, Any]]:
    from repro_torch.offload.profiling import find_annotation

    return find_annotation(trace.get("traceEvents", []), name)


def merge_device_trace(
    host_trace: Dict[str, Any],
    device_trace: "str | Path | Dict[str, Any]",
    *,
    align_on: Optional[str] = None,
) -> Dict[str, Any]:
    """Fold a ``torch.profiler`` chrome trace's device events into a host
    trace.

    ``align_on`` names an event present in *both* traces (the profiler's
    ``record_function`` tag, which ``profile_offload`` mirrors as a host
    span); device timestamps are shifted so the two copies coincide. When
    ``align_on`` is None the first host event name that also appears in the
    device trace is used; with no common event the device events are
    appended unshifted (still viewable, on their own clock).

    Returns a new trace dict; inputs are not mutated. Device events keep
    their names, move to ``pid`` :data:`DEVICE_PID`, and gain
    ``args.source = "torch.profiler"``.

    Spans opened with :func:`repro_torch.obs.tracing.span` while that
    profiler recorded are already in its trace as ``record_function``
    ranges, on its clock: they need no alignment, only the collecting
    tracer's ``perf_counter`` spans do.

    A missing or unparseable device trace **degrades, never raises**: the
    profiler writing a truncated trace must not take down the tooling that
    wanted to decorate a perfectly good host trace. The merged result is
    then the host trace with ``deviceEventsMerged == 0`` and the reason in
    ``deviceMergeError`` (also recorded as a ``profiler_fallback`` flight
    event).
    """
    from repro_torch.obs import events as obs_events

    def degrade(reason: str, kind: str) -> Dict[str, Any]:
        obs_events.record("profiler_fallback", reason=kind)
        out = {
            **host_trace,
            "traceEvents": [
                dict(ev) for ev in host_trace.get("traceEvents", [])
            ],
        }
        out["deviceEventsMerged"] = 0
        out["deviceClockAligned"] = False
        out["deviceMergeError"] = reason
        return out

    if not isinstance(device_trace, dict):
        try:
            device_trace = load_chrome_trace(device_trace)
        except (OSError, ValueError) as e:
            return degrade(
                f"device trace unreadable: {e}", "merge_unreadable_trace"
            )
    if not isinstance(device_trace, dict):
        # a JSON file that parsed to a list/scalar — same degrade path
        return degrade(
            f"device trace malformed: expected an object, got "
            f"{type(device_trace).__name__}",
            "merge_malformed_trace",
        )

    host_events = [dict(e) for e in host_trace.get("traceEvents", [])]
    merged = {**host_trace, "traceEvents": host_events}

    # -- clock alignment ---------------------------------------------------
    offset = 0.0
    aligned = False
    candidates: List[str] = []
    if align_on is not None:
        candidates = [align_on]
    else:
        candidates = [
            str(e.get("name"))
            for e in host_events
            if e.get("ph") == "X"
        ]
    for name in candidates:
        dev_anchor = _find_event(device_trace, name)
        host_anchor = _find_event(merged, name)
        if dev_anchor is not None and host_anchor is not None:
            offset = float(host_anchor["ts"]) - float(dev_anchor["ts"])
            aligned = True
            break

    host_events.append(
        {
            "ph": "M",
            "pid": DEVICE_PID,
            "tid": 0,
            "name": "process_name",
            "args": {"name": "repro-device (torch.profiler)"},
        }
    )
    n = 0
    for e in _device_events(device_trace):
        ev = dict(e)
        ev["pid"] = DEVICE_PID
        ev["tid"] = 0
        ev["ts"] = float(e.get("ts", 0.0)) + offset
        args = dict(ev.get("args") or {})
        args["source"] = "torch.profiler"
        args["aligned"] = aligned
        ev["args"] = args
        host_events.append(ev)
        n += 1
    merged["deviceEventsMerged"] = n
    merged["deviceClockAligned"] = aligned
    return merged


def write_trace(path: "str | Path", trace: Dict[str, Any]) -> Path:
    """Write a trace dict as (plain) JSON; returns the path. Open the file
    at https://ui.perfetto.dev or chrome://tracing."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(trace, indent=1, default=str) + "\n")
    return path
