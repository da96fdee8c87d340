"""Profiler-measured schedule latency: device timings into EngineTelemetry
(PyTorch port of ``repro.offload.profiling``).

In sim and driver mode the engine times dispatches with the host clock,
bracketed by ``torch.cuda.synchronize``; inside ``shard_map`` (spmd mode) it
leaves latency to the profiler. This module closes that loop: one dispatch
runs under ``torch.profiler`` (CUPTI) inside a
``torch.profiler.record_function`` annotation naming the schedule, the
chrome trace ``export_chrome_trace`` writes is parsed with the standard
library, and the *device time* of the work the window launched — the union
of the intervals of its kernels, copies and memsets, so overlapping work
never counts twice — is recorded into
:class:`~repro_torch.offload.engine.EngineTelemetry` as a
**measured-on-device** latency source, apart from the wall-clock numbers.
That is the software analogue of the paper's 8 ns on-NIC timer: the host
clock sees dispatch + launch + sync; the trace sees the collective itself.

Which device work belongs to the window: a device event (``cat`` one of
:data:`DEVICE_EVENT_CATS`) whose ``correlation`` id matches a CUDA runtime
or driver call (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, a memcpy or
memset) that *started* inside the annotation. The match is on correlation,
not on the device event's own timestamp: the GPU clock is aligned to the
host clock only to within microseconds, and clipping to the window would
cut real kernel time.

When the runtime cannot produce or parse a trace (a second profiler session
already running, no CUDA activity at all — every CPU run), measurement
falls back to the window's own wall duration, labelled ``source="wall"`` so
dashboards never mistake it for a device number, and the *reason* is
recorded (:attr:`DeviceTiming.fallback_reason`, counted into
``EngineTelemetry.snapshot()["profiler_fallback_reasons"]`` and the
``repro_engine_profiler_fallbacks_total`` metric).

When a collecting tracer is installed (:mod:`repro_torch.obs.tracing`), the
profiled dispatch also emits a host-side span *named exactly like the
annotation*. The same name then appears in both the host span trace and
the profiler's chrome trace, which is the anchor
:func:`repro_torch.obs.export.merge_device_trace` aligns the two clocks on.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.obs import tracing as obs_tracing
from repro_torch.obs.export import load_chrome_trace

PyTree = Any

#: every annotation this module emits starts with this prefix
ANNOTATION_PREFIX = "repro_offload"

#: chrome-trace categories of device activity in a ``torch.profiler`` trace
DEVICE_EVENT_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})

#: chrome-trace categories of the host calls that enqueue device work
#: (runtime: ``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cudaMemcpyAsync``,
#: ``cudaMemsetAsync``; driver: ``cuLaunchKernel``, ``cuLaunchKernelEx``)
LAUNCH_EVENT_CATS = frozenset({"cuda_runtime", "cuda_driver"})

#: the host-side category ``record_function`` gives its annotation (its
#: device-side copy is ``gpu_user_annotation``)
ANNOTATION_CAT = "user_annotation"


@dataclasses.dataclass(frozen=True)
class DeviceTiming:
    """One profiled dispatch: where each number came from."""

    coll: str
    device_us: float       # union of device-event intervals of the window
    wall_us: float         # host wall clock around the same dispatch
    source: str            # "profiler" (trace-derived) or "wall" (fallback)
    events: int            # device events attributed to the window
    trace_path: Optional[str] = None
    #: why source degraded to "wall": "trace_start_failed" (most often a
    #: concurrent profiler session), "stop_failed", "no_trace_file", or
    #: "parse_failed"; None when the profiler delivered
    fallback_reason: Optional[str] = None


def _interval_union_us(intervals: List[Tuple[float, float]]) -> float:
    total = 0.0
    end = -1.0
    for lo, hi in sorted(intervals):
        if lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def find_annotation(
    events: List[Dict[str, Any]], name: str
) -> Optional[Dict[str, Any]]:
    """The host-side complete event named ``name``: the ``user_annotation``
    one when there is one, else the first host event of that name (device
    activity and its ``gpu_user_annotation`` copy never anchor a window)."""
    first = None
    for e in events:
        if e.get("ph") != "X" or e.get("name") != name:
            continue
        cat = e.get("cat")
        if cat == ANNOTATION_CAT:
            return e
        if first is None and cat not in DEVICE_EVENT_CATS and cat != (
            "gpu_" + ANNOTATION_CAT
        ):
            first = e
    return first


def window_device_events(
    events: List[Dict[str, Any]], annotation: str
) -> Optional[List[Dict[str, Any]]]:
    """The device events launched inside the annotation window, or None
    when the trace holds no such annotation."""
    anchor = find_annotation(events, annotation)
    if anchor is None:
        return None
    lo_w = float(anchor.get("ts", 0.0))
    hi_w = lo_w + float(anchor.get("dur", 0.0))
    launched = set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in LAUNCH_EVENT_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and lo_w <= float(e.get("ts", 0.0)) <= hi_w:
            launched.add(corr)
    return [
        e for e in events
        if e.get("ph") == "X"
        and e.get("cat") in DEVICE_EVENT_CATS
        and (e.get("args") or {}).get("correlation") in launched
    ]


def parse_device_us(
    trace_path: str, annotation: str
) -> Optional[Tuple[float, int]]:
    """(device µs, event count) for one annotation window, or None.

    Reads the chrome trace ``export_chrome_trace`` writes, plain or
    gzip-compressed. Device time is the interval union of the window's
    device events (see the module docstring for which those are), whole,
    never clipped; None when the trace cannot be read, holds no such
    annotation, or the window launched nothing on the device.
    """
    try:
        trace = load_chrome_trace(trace_path)
    except (OSError, ValueError):
        return None
    found = window_device_events(trace.get("traceEvents", []), annotation)
    if not found:
        return None
    intervals = [
        (float(e.get("ts", 0.0)),
         float(e.get("ts", 0.0)) + float(e.get("dur", 0.0)))
        for e in found
    ]
    return _interval_union_us(intervals), len(intervals)


def _prime(device: "torch.device | str") -> None:
    """One untimed launch, waited for, before the annotated window: after
    a process's earlier profiler sessions over the serving path, the first
    kernel launched in a new session was slow to launch and left no device
    record (seen on an H100; ``chip_smoke.py``'s ``profile`` phase reports
    that launch), which emptied a window whose dispatch launched one
    kernel. The primer takes that loss outside the window."""
    torch.ones(1, device=device).add_(1)
    torch.cuda.synchronize(device)


def profile_call(
    call: Callable[[], PyTree],
    tag: str,
    *,
    coll: str = "",
    device: "torch.device | str" = "cuda",
    trace_dir: Optional[str] = None,
) -> DeviceTiming:
    """Run ``call()`` once under a profiler trace, inside a
    ``record_function(tag)`` annotation, wait for its result on ``device``
    and return where its time went (:class:`DeviceTiming`, ``coll`` as
    given). No telemetry is touched: :func:`profile_offload` is this around
    one engine dispatch, and a caller with another entry point (the per-rank
    fused lowering under ``shard_map``, say) profiles it the same way.
    Trace machinery failures degrade to the wall-clock source with the
    reason; a failing ``call`` propagates."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    owned = trace_dir is None
    tmp = tempfile.mkdtemp(prefix="repro_torch_prof_") if owned else trace_dir
    parsed: Optional[Tuple[float, int]] = None
    trace_path: Optional[str] = None
    fallback_reason: Optional[str] = None
    span_tracer = obs_tracing.get_tracer()
    prof = None
    try:
        try:
            # a second session would silently end the running one
            if torch.autograd._profiler_enabled():
                raise RuntimeError("a profiler session is already running")
            prof = profile(activities=activities)
            prof.start()
        except RuntimeError:
            prof = None
            fallback_reason = "trace_start_failed"
        if prof is not None and torch.device(device).type == "cuda":
            _prime(device)
        t0 = time.perf_counter()
        t0_us = obs_tracing.now_us()
        try:
            if prof is not None:
                with record_function(tag):
                    obs_tracing._block(call())
            else:
                obs_tracing._block(call())
        finally:
            wall_us = (time.perf_counter() - t0) * 1e6
            if span_tracer.enabled:
                # host span named exactly like the annotation — the
                # clock-alignment anchor for merge_device_trace
                span_tracer.add_span(
                    tag, "profile", t0_us, obs_tracing.now_us(),
                    parent_id=span_tracer.current_span_id(),
                    coll=coll, annotation=True,
                )
            if prof is not None:
                try:
                    prof.stop()
                except RuntimeError:
                    prof = None
                    fallback_reason = "stop_failed"
        if prof is not None:
            os.makedirs(tmp, exist_ok=True)
            path = os.path.join(
                tmp, f"{tag.replace(':', '_')}.{time.time_ns()}.trace.json"
            )
            try:
                prof.export_chrome_trace(path)
            except (OSError, RuntimeError):
                pass
            if not os.path.exists(path):
                fallback_reason = "no_trace_file"
            else:
                trace_path = path
                parsed = parse_device_us(path, tag)
                if parsed is None:
                    fallback_reason = "parse_failed"
    finally:
        if owned:
            shutil.rmtree(tmp, ignore_errors=True)
            trace_path = None
    if parsed is None:
        return DeviceTiming(
            coll=coll, device_us=wall_us, wall_us=wall_us, source="wall",
            events=0, trace_path=trace_path,
            fallback_reason=fallback_reason or "trace_start_failed",
        )
    return DeviceTiming(
        coll=coll, device_us=parsed[0], wall_us=wall_us, source="profiler",
        events=parsed[1], trace_path=trace_path,
    )


def profile_offload(
    engine,
    descriptor,
    x: Optional[PyTree] = None,
    *,
    axis_name=None,
    mesh=None,
    warmup: int = 1,
    trace_dir: Optional[str] = None,
) -> DeviceTiming:
    """Dispatch one descriptor under a profiler trace; feed the telemetry.

    Works in sim mode and in driver mode (both are host-dispatched: the
    engine owns the program, so the window brackets exactly one schedule).
    ``warmup`` dispatches first so building and first launches never
    pollute the window. The measurement lands in ``engine.telemetry`` via
    ``record_device_latency`` (and a fallback's reason via
    ``record_profiler_fallback``). Pass ``trace_dir`` to keep the chrome
    trace there (``DeviceTiming.trace_path``).
    """
    desc = engine._as_descriptor(descriptor)
    coll = desc.coll_type.name.lower()
    for _ in range(max(0, warmup)):
        engine.offload(desc, x, axis_name=axis_name, mesh=mesh)
    timing = profile_call(
        lambda: engine.offload(desc, x, axis_name=axis_name, mesh=mesh),
        f"{ANNOTATION_PREFIX}:{coll}:p{desc.comm_size}",
        coll=coll,
        device=engine.device if mesh is None else mesh.device,
        trace_dir=trace_dir,
    )
    if timing.source != "profiler":
        engine.telemetry.record_profiler_fallback(
            coll, timing.fallback_reason
        )
    engine.telemetry.record_device_latency(
        coll, timing.device_us * 1e-6, source=timing.source
    )
    return timing


__all__ = [
    "ANNOTATION_PREFIX",
    "DEVICE_EVENT_CATS",
    "DeviceTiming",
    "parse_device_us",
    "profile_call",
    "profile_offload",
]
