"""The benchmark's own profiler windows and what it reads from them.

A traced run (``--trace 1``) measures its window as an untraced run does,
then runs two more: one under ``torch.profiler`` recording the card alone
(the kernels', copies' and memsets' device time by name, and the union of
the card's activity), and a shorter one recording the host too, inside
``portbench.window`` / ``portbench.call`` annotations, whose only use is to
label the card's idle gaps with the innermost host event running at each
gap's middle. Recording the host slows it; recording the card alone slows
it less, but still (``PERF.md``), so the readers take the card's busy time
a call from the trace and everything timed on the host from the measured
window. The chrome traces are read back into small summaries, one a chip.
"""

from __future__ import annotations

import bisect
import json
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
WINDOW = "portbench.window"
#: gaps shorter than this are not labelled (the launch queue's own spacing)
GAP_MIN_US = 2.0
#: the longest gaps labelled by the host event under them
GAPS_LABELLED = 4000
NAME_CHARS = 160


def union_us(intervals: Iterable[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Length of the union of ``(start, end)`` intervals and the merged
    intervals, sorted."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


def _label_gaps(gaps: List[Tuple[float, float]], host: List[Dict[str, Any]]) -> Dict[str, float]:
    """Seconds of device idle time by the innermost host event running at
    each gap's middle (``host: none`` where nothing ran)."""
    host = sorted(host, key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    out: Dict[str, float] = {}
    for s, e in sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:GAPS_LABELLED]:
        mid = 0.5 * (s + e)
        label = "host: none"
        # nested host events: the latest-starting one that covers the
        # middle is the innermost
        j = bisect.bisect_right(starts, mid) - 1
        for ev in host[max(0, j - 4000):j + 1][::-1]:
            if ev["ts"] + ev["dur"] >= mid and ev["name"] != WINDOW:
                label = ev["name"][:NAME_CHARS]
                break
        out[label] = out.get(label, 0.0) + (e - s) * 1e-6
    return out


def summarize(events: List[Dict[str, Any]], w0: float = 0.0, w1: float = 0.0,
              anchored: bool = True) -> Optional[Dict[str, Any]]:
    """A chrome trace's events as the summary the readers take. The window
    is the ``portbench.window`` annotation's (None when there is none), or
    with ``anchored=False`` one of ``w1 - w0`` microseconds from the first
    device record: a trace of the card alone, whose records all fall
    inside a window of that length measured on the host."""
    if anchored:
        windows = [e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if not windows:
            return None
        w0 = float(windows[0]["ts"])
        w1 = w0 + float(windows[0]["dur"])
    else:
        starts = [float(e["ts"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        length = w1 - w0
        w0 = min(starts) if starts else 0.0
        w1 = w0 + length
    device, host = [], []
    kernels: Dict[str, List[float]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            s, t = max(ts, w0), min(ts + dur, w1)
            if t <= s:
                continue
            device.append((s, t))
            name = str(e.get("name", ""))[:NAME_CHARS]
            k = kernels.setdefault(name, [0, 0.0, cat])
            k[0] += 1
            k[1] += (t - s) * 1e-6
        elif cat in HOST_CATS and w0 <= ts <= w1:
            host.append({"name": str(e.get("name", "")), "cat": cat, "ts": ts,
                         "dur": dur})
    busy_us, merged = union_us(device)
    gaps = []
    prev = w0
    for s, t in merged:
        if s - prev >= GAP_MIN_US:
            gaps.append((prev, s))
        prev = t
    if w1 - prev >= GAP_MIN_US:
        gaps.append((prev, w1))
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernels": kernels,
        "idle_gaps": _label_gaps(gaps, host),
    }


def kernel_time(summary: Dict[str, Any], part: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds ``part``."""
    n, s = 0, 0.0
    for name, (count, secs, cat) in summary["kernels"].items():
        if cat == "kernel" and part in name:
            n += count
            s += secs
    return n, s


def breakdown(summaries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The ten device operations that took most time and the ten host
    labels under the most idle time, averaged over the chips."""
    ops: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    for s in summaries:
        for name, (_, secs, _cat) in s["kernels"].items():
            ops[name] = ops.get(name, 0.0) + secs / len(summaries)
        for name, secs in s["idle_gaps"].items():
            gaps[name] = gaps.get(name, 0.0) + secs / len(summaries)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def _session(wl, activities, seconds, annotate):
    """One profiler session: the primer in its warm-up step, whose events
    the profiler drops (a session's first launch can lose its device
    record), then the window in its active step; returns (Measured,
    chrome trace events)."""
    from torch.profiler import profile, record_function, schedule

    from portbench.bench import timed_window

    tmp = Path(tempfile.mkdtemp(prefix="portbench-trace-"))
    try:
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            wl.primer()
            prof.step()
            if annotate:
                with record_function(WINDOW):
                    measured = timed_window(wl, seconds, annotate=record_function)
            else:
                measured = timed_window(wl, seconds)
            prof.step()
        path = tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return measured, events


def traced(wl, seconds: float, label_seconds: float) -> Dict[str, Any]:
    """The traced run's two windows; returns the summary, with the calls
    the traced window made (``calls``).

    The measured window records the card's activity alone, which costs the
    host little: its length is the host clock's, its busy time the union
    of the device records, all of which fall inside it (the window ends
    with the card synchronised). A second, shorter window records the host
    too, inside ``portbench.window`` / ``portbench.call`` annotations, for
    the idle gaps' labels only: recording every host operation slows the
    host (a training step's twenty thousand launches most)."""
    from torch.profiler import ProfilerActivity

    cuda = wl.device.type == "cuda"
    device_acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    measured, events = _session(wl, device_acts, seconds, annotate=False)
    summary = summarize(events, 0.0, measured.window_s * 1e6, anchored=False)
    _, events = _session(wl, [ProfilerActivity.CPU] + device_acts[:int(cuda)],
                         label_seconds, annotate=True)
    labelled = summarize(events)
    if labelled is None:
        raise RuntimeError("the profiler's trace holds no portbench.window")
    summary["idle_gaps"] = labelled["idle_gaps"]
    summary["calls"] = measured.calls
    return summary


def device_s_per_call(run) -> Optional[float]:
    """The card's busy time a call in the traced window, the mean over the
    cards; None without a trace or device activity."""
    if not run.traces or any(t["busy_s"] <= 0 or not t["calls"] for t in run.traces):
        return None
    return sum(t["busy_s"] / t["calls"] for t in run.traces) / len(run.traces)


def idle_share(run) -> Optional[float]:
    """Percent of the measured (untraced) window in which the card ran
    nothing: one minus the card's busy time a call, from the traced window,
    times the measured window's calls, over its length."""
    busy = device_s_per_call(run)
    if busy is None or run.calls == 0 or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy * run.calls / run.window_s)
