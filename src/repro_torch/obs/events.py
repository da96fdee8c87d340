"""Flight recorder: a bounded, always-on ring buffer of structured events
(the port's copy of ``repro.obs.events``, standard library only).

Spans (:mod:`repro_torch.obs.tracing`) answer "where did the time go?" for one
traced request; metrics (:mod:`repro_torch.obs.metrics`) answer "how much, in
aggregate?". Neither helps when a process crashes or an SLO burns at
3am and the question is "what was the stack *doing* just before?" — the
tracer is off by default and metrics have no ordering. The flight
recorder fills that gap the way an aircraft FDR does: a fixed-size ring
of the last N structured events, recording **always**, cheap enough that
no one ever wants to turn it off, dumpable to JSON on demand and
automatically on crash/recovery.

Event kinds the port records so far (the schema is open: extra fields are
free-form per kind, and every event also carries ``seq``, ``t`` (epoch
seconds) and ``ts_us`` (perf_counter µs, the spans' clock)); the reference
adds service, fault and reliability kinds, which land with those slices:

========================  ====================================================
kind                      fields
========================  ====================================================
``dispatch``              coll, cache ("hit"/"miss"), latency_us
``cache_miss``            coll, scope ("schedule")
``backend_fallback``      coll, reason
``profiler_fallback``     reason (and coll, from the engine)
``dump``                  reason, path
========================  ====================================================

The recorder is process-global (:func:`get_recorder` / :func:`record`),
like the metrics registry. ``$REPRO_TORCH_FLIGHT_RECORD`` (or
:func:`set_auto_dump_path`) names a JSON file that :func:`auto_dump` writes
when a crash or recovery path asks for it.

Cost: ``record()`` is one lock acquire + deque append of a small tuple.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Deque, Dict, List, Optional, Tuple

__all__ = [
    "DEFAULT_CAPACITY",
    "FlightRecorder",
    "auto_dump",
    "auto_dump_path",
    "get_recorder",
    "record",
    "set_auto_dump_path",
    "set_recorder",
]

DEFAULT_CAPACITY = 4096

#: environment variable naming the auto-dump JSON file
AUTO_DUMP_ENV = "REPRO_TORCH_FLIGHT_RECORD"


class FlightRecorder:
    """Bounded thread-safe ring buffer of ``(seq, t, ts_us, kind, fields)``.

    Always on: the hot path is one lock + one ``deque.append`` (the deque
    evicts the oldest event itself at capacity), so instrumented code
    calls :meth:`record` unconditionally. Reads (:meth:`events`,
    :meth:`snapshot`, :meth:`dump`) materialize dicts under the same lock.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._buf: Deque[Tuple[int, float, float, str, Dict[str, Any]]] = (
            collections.deque(maxlen=self.capacity)
        )
        self._lock = threading.Lock()
        self._seq = 0
        self._counts: Dict[str, int] = {}

    # -- hot path ----------------------------------------------------------

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event. Cheap by design: no formatting, no I/O."""
        t = time.time()
        ts_us = time.perf_counter() * 1e6
        with self._lock:
            self._seq += 1
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._buf.append((self._seq, t, ts_us, kind, fields))

    # -- reading -----------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def events(
        self, kind: Optional[str] = None, limit: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        """The retained events (oldest first) as dicts, optionally filtered
        by ``kind`` and truncated to the newest ``limit``."""
        with self._lock:
            raw = list(self._buf)
        out = [
            {"seq": seq, "t": t, "ts_us": ts_us, "kind": k, **f}
            for seq, t, ts_us, k, f in raw
            if kind is None or k == kind
        ]
        if limit is not None:
            out = out[-int(limit):]
        return out

    def counts(self) -> Dict[str, int]:
        """Total events recorded per kind (including evicted ones)."""
        with self._lock:
            return dict(self._counts)

    def snapshot(self, reason: str = "") -> Dict[str, Any]:
        """The full dump payload: config, per-kind totals, retained ring."""
        with self._lock:
            raw = list(self._buf)
            recorded = self._seq
            counts = dict(self._counts)
        return {
            "reason": reason,
            "wall_time": time.time(),
            "capacity": self.capacity,
            "recorded": recorded,
            "evicted": recorded - len(raw),
            "counts": counts,
            "events": [
                {"seq": seq, "t": t, "ts_us": ts_us, "kind": k, **f}
                for seq, t, ts_us, k, f in raw
            ],
        }

    def to_json(self, reason: str = "") -> str:
        return json.dumps(self.snapshot(reason), indent=1, default=str)

    def dump(
        self, path: Optional[os.PathLike] = None, reason: str = ""
    ) -> Dict[str, Any]:
        """Snapshot the ring; when ``path`` is given also write it as JSON.

        Never raises on I/O problems — a broken dump path must not take
        down the recovery path that asked for the dump; the failure is
        recorded into the ring instead.
        """
        snap = self.snapshot(reason)
        if path is not None:
            try:
                p = Path(path)
                if p.parent and not p.parent.exists():
                    p.parent.mkdir(parents=True, exist_ok=True)
                p.write_text(json.dumps(snap, indent=1, default=str))
                self.record("dump", reason=reason, path=str(p))
            except OSError as e:
                self.record(
                    "dump", reason=reason, path=str(path), error=str(e)
                )
        return snap

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._counts.clear()
            self._seq = 0


# -- the process-wide recorder (always on) -----------------------------------

_recorder = FlightRecorder()
_auto_dump_path: Optional[Path] = None


def get_recorder() -> FlightRecorder:
    return _recorder


def set_recorder(rec: Optional[FlightRecorder]) -> FlightRecorder:
    """Install ``rec`` (None installs a fresh default); returns previous."""
    global _recorder
    prev = _recorder
    _recorder = FlightRecorder() if rec is None else rec
    return prev


def record(kind: str, **fields: Any) -> None:
    """Record one event into the process-wide flight recorder."""
    _recorder.record(kind, **fields)


def set_auto_dump_path(path: Optional[os.PathLike]) -> None:
    """Explicitly set (or clear) the crash/recovery auto-dump target;
    overrides ``$REPRO_TORCH_FLIGHT_RECORD``."""
    global _auto_dump_path
    _auto_dump_path = None if path is None else Path(path)


def auto_dump_path() -> Optional[Path]:
    if _auto_dump_path is not None:
        return _auto_dump_path
    env = os.environ.get(AUTO_DUMP_ENV, "").strip()
    return Path(env) if env else None


def auto_dump(reason: str) -> Optional[Path]:
    """Dump the recorder to the configured path, if any. Called from
    crash/recovery paths; a no-op when no path is configured so those paths
    stay dependency-free."""
    path = auto_dump_path()
    if path is None:
        return None
    _recorder.dump(path, reason=reason)
    return path
