"""In-process span tracer: per-round latency attribution for the offload stack
(the port's copy of ``repro.obs.tracing``).

The paper's core evidence is a *measurement*: an on-NIC timer attributing
scan latency to the network device versus the host. The software stack has
many more places for the time to hide — broker queue, coalescing window,
schedule-cache lookup, lowering, the per-round host constant of the sim
interpreter, the kernel launch — so this module provides lightweight
host-side spans with explicit parent links:

    service.submit  ->  broker.queue_wait  ->  broker.dispatch_group
      ->  engine.offload (cache hit/miss, engine.compile on miss)
        ->  plan.phase:<KIND>:L<level>   (one per PlanPhase)
          ->  plan.round:<i>             (one per communication round)

Span categories (``cat``): ``service``, ``broker``, ``engine``, ``phase``,
``round``, ``profile``, and — in link-probe mode
(``Tracer(link_probe=True)``, see :mod:`repro_torch.obs.health`) —
``link``, one span per (src, dst) message of a round. Timestamps are ``time.perf_counter()`` microseconds, one
monotonic clock for the whole process; :mod:`repro_torch.obs.export`
serializes them to Chrome/Perfetto trace JSON and can merge the device-side
events a ``torch.profiler`` trace records for the same dispatch.

**Tracing is off by default and zero-cost when off.** The module-level
tracer is a :class:`NoopTracer` whose ``span()`` returns one shared no-op
context manager — instrumented code paths pay a single attribute check.
Nothing about the dispatched computation changes either way: spans only
wrap *host-side* work. Driver and spmd dispatches get spans around the
dispatch only; the traced sim lowerings
(:func:`repro_torch.offload.planner.lower_sim` and
:func:`repro_torch.kernels.fused_collective.lower_fused` with
``traced=True``) also emit phase- and round-level spans, synchronizing the
device at each boundary so a span's length is the work inside it.

Usage::

    from repro_torch.obs import tracing

    with tracing.tracing() as tracer:        # installs + restores
        engine.offload(desc, x)              # sim dispatch -> round spans
    spans = tracer.spans()
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "NoopTracer",
    "Span",
    "Tracer",
    "TracingBackend",
    "add_kernel_round_spans",
    "get_tracer",
    "install_tracer",
    "now_us",
    "set_tracer",
    "tracing",
]


def now_us() -> float:
    """The tracer clock: ``perf_counter`` microseconds (process-monotonic)."""
    return time.perf_counter() * 1e6


@dataclasses.dataclass
class Span:
    """One closed span. ``start_us``/``dur_us`` are perf_counter µs."""

    name: str
    cat: str
    start_us: float
    dur_us: float
    span_id: int
    parent_id: Optional[int] = None
    tid: int = 0
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


class _OpenSpan:
    """Mutable in-flight span handle yielded by :meth:`Tracer.span`."""

    __slots__ = ("name", "cat", "span_id", "parent_id", "start_us", "args")

    def __init__(self, name, cat, span_id, parent_id, start_us, args):
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_us = start_us
        self.args = args

    def set(self, **kw: Any) -> None:
        """Attach/overwrite span args while the span is open."""
        self.args.update(kw)


class _NullSpan:
    """The disabled tracer's span handle/context manager: does nothing."""

    __slots__ = ()
    span_id = None
    parent_id = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def set(self, **kw: Any) -> None:
        return None


_NULL_SPAN = _NullSpan()


class NoopTracer:
    """The default tracer: disabled, allocation-free on the hot path."""

    enabled = False

    def span(self, name: str, cat: str = "host", **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def add_span(self, *a: Any, **kw: Any) -> None:
        return None

    def spans(self) -> Tuple[Span, ...]:
        return ()

    def clear(self) -> None:
        return None

    def current_span_id(self) -> Optional[int]:
        return None


class Tracer:
    """Collecting tracer: thread-safe append, per-thread parent stacks.

    Parent links resolve from context-manager nesting on each thread; spans
    whose bounds were measured elsewhere (cross-thread waits, a fused
    kernel's rounds) are recorded after the fact via :meth:`add_span` with
    an explicit ``parent_id``.

    ``link_probe=True`` makes the traced sim lowering split every round's
    permute into per-(src, dst) messages, one ``link`` span each
    (:class:`repro_torch.obs.health.LinkProbeBackend`); ``link_injector``
    (a ``LinkDelayInjector`` or ``ChaosInjector``) adds per-link delay and
    ``link_detector`` (a ``LinkStragglerDetector``) watches every message.
    """

    enabled = True

    def __init__(
        self,
        *,
        max_spans: int = 200_000,
        link_probe: bool = False,
        link_injector: Optional[Any] = None,
        link_detector: Optional[Any] = None,
    ):
        self.link_probe = bool(link_probe)
        self.link_injector = link_injector
        self.link_detector = link_detector
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self.max_spans = int(max_spans)
        self.dropped = 0

    # -- recording ---------------------------------------------------------

    def _stack(self) -> List[int]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_span_id(self) -> Optional[int]:
        stack = self._stack()
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        cat: str = "host",
        *,
        parent_id: Optional[int] = None,
        **args: Any,
    ) -> Iterator[_OpenSpan]:
        stack = self._stack()
        if parent_id is None and stack:
            parent_id = stack[-1]
        handle = _OpenSpan(
            name, cat, next(self._ids), parent_id, now_us(), dict(args)
        )
        stack.append(handle.span_id)
        try:
            yield handle
        finally:
            stack.pop()
            self._append(
                Span(
                    name=handle.name,
                    cat=handle.cat,
                    start_us=handle.start_us,
                    dur_us=now_us() - handle.start_us,
                    span_id=handle.span_id,
                    parent_id=handle.parent_id,
                    tid=threading.get_ident(),
                    args=handle.args,
                )
            )

    def add_span(
        self,
        name: str,
        cat: str,
        start_us: float,
        end_us: float,
        *,
        parent_id: Optional[int] = None,
        tid: Optional[int] = None,
        **args: Any,
    ) -> Optional[int]:
        """Record a span whose bounds were measured elsewhere (cross-thread
        waits, retroactive attribution). Returns the new span id."""
        span = Span(
            name=name,
            cat=cat,
            start_us=float(start_us),
            dur_us=max(0.0, float(end_us) - float(start_us)),
            span_id=next(self._ids),
            parent_id=parent_id,
            tid=threading.get_ident() if tid is None else tid,
            args=dict(args),
        )
        self._append(span)
        return span.span_id

    def _append(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
                return
            self._spans.append(span)

    # -- reading -----------------------------------------------------------

    def spans(self) -> Tuple[Span, ...]:
        with self._lock:
            return tuple(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0


# -- the process-wide active tracer (default: disabled) ----------------------

NOOP = NoopTracer()
_active: "Tracer | NoopTracer" = NOOP
_active_lock = threading.Lock()


def get_tracer() -> "Tracer | NoopTracer":
    """The active tracer. Instrumented code calls this per operation; with
    the default :data:`NOOP` installed the whole call chain is a couple of
    attribute reads."""
    return _active


def set_tracer(tracer: "Tracer | NoopTracer | None") -> "Tracer | NoopTracer":
    """Install ``tracer`` (None restores the no-op); returns the previous."""
    global _active
    with _active_lock:
        prev = _active
        _active = NOOP if tracer is None else tracer
    return prev


def install_tracer(**kw: Any) -> Tracer:
    """Install and return a fresh collecting tracer."""
    tracer = Tracer(**kw)
    set_tracer(tracer)
    return tracer


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Context manager: install a (fresh by default) tracer, restore the
    previous one on exit."""
    tracer = Tracer() if tracer is None else tracer
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


class TracingBackend:
    """Wrap a schedule backend so every ``permute`` is one ``round`` span.

    A communication *round* in every schedule in
    :mod:`repro_torch.core.algorithms`
    is exactly one ``backend.permute`` call (opposite-direction permutes of
    the fused schedule count as one full-duplex round each — they appear as
    two adjacent spans sharing a round index only when the schedule really
    issues two permutes). The wrapper synchronizes the device on the
    permuted result so the span's duration is the *whole cost of that
    round* — launch, copy, sync — the per-round constant the dispatch work
    wants attributed. Only meaningful on an eager schedule: never use it
    inside a CUDA graph capture, where a sync is not allowed.

    Chunked-streaming schedules
    (:func:`repro_torch.core.algorithms._pipeline`)
    announce the (chunk, schedule-round) coordinates of each pipeline slot
    via :meth:`set_chunk_context` before issuing its permute; while set,
    round spans carry ``chunk`` and ``chunk_round`` args, so the per-round
    cost table can attribute time per (round, chunk) cell. Unchunked
    schedules never call it and their spans are arg-for-arg what they were
    before chunking existed.
    """

    def __init__(
        self,
        inner: Any,
        tracer: "Tracer | NoopTracer",
        *,
        phase: str = "",
        on_round: Optional[Any] = None,
    ):
        self.inner = inner
        self.tracer = tracer
        self.phase = phase
        self.on_round = on_round
        self.rounds = 0
        self._chunk = -1
        self._chunk_round = -1

    @property
    def p(self) -> int:
        return self.inner.p

    def rank(self):
        return self.inner.rank()

    def set_chunk_context(self, chunk: int, rnd: int) -> None:
        """Label subsequent rounds with pipeline coordinates (-1 clears)."""
        self._chunk = int(chunk)
        self._chunk_round = int(rnd)

    def permute(self, tree: Any, perm: Any) -> Any:
        idx = self.rounds
        self.rounds += 1
        extra: Dict[str, Any] = {}
        if self._chunk >= 0:
            extra = {"chunk": self._chunk, "chunk_round": self._chunk_round}
        t0 = now_us()
        with self.tracer.span(
            f"plan.round:{idx}",
            "round",
            round=idx,
            phase=self.phase,
            messages=len(perm),
            **extra,
        ):
            out = self.inner.permute(tree, perm)
            out = _block(out)
        if self.on_round is not None:
            self.on_round(idx, now_us() - t0)
        return out


def add_kernel_round_spans(
    tracer: "Tracer | NoopTracer",
    *,
    phase: str,
    coll: str,
    rounds: int,
    start_us: float,
    end_us: float,
) -> Optional[int]:
    """Record phase + round spans for a *fused-kernel* phase after the fact.

    The fused backend (registered as ``"pallas"``, K1 on the GPU) runs every
    exchange round of a phase inside one kernel, so there is no host-side per-round boundary to wrap a span
    around — the only measurable quantity is the whole kernel's wall time.
    This helper keeps the trace schema uniform anyway: one ``phase``-category
    span over ``[start_us, end_us]`` plus ``rounds`` contiguous child
    ``round`` spans splitting the interval evenly, all tagged
    ``source="pallas"`` and ``attribution="uniform"`` so downstream
    consumers (the per-round cost table, trace exports) can tell a measured
    host round from a kernel-amortized estimate. Returns the phase span id
    (None on the no-op tracer).
    """
    if not tracer.enabled:
        return None
    n = max(0, int(rounds))
    phase_id = tracer.add_span(
        f"plan.phase:{phase}",
        "phase",
        start_us,
        end_us,
        parent_id=tracer.current_span_id(),
        coll=coll,
        rounds=n,
        source="pallas",
    )
    if n:
        step = (float(end_us) - float(start_us)) / n
        for i in range(n):
            tracer.add_span(
                f"plan.round:{i}",
                "round",
                start_us + i * step,
                start_us + (i + 1) * step,
                parent_id=phase_id,
                round=i,
                phase=phase,
                source="pallas",
                attribution="uniform",
            )
    return phase_id


def _block(tree: Any) -> Any:
    """Wait for the device work that produces ``tree``: one
    ``torch.cuda.synchronize`` per CUDA device its tensors live on (CPU
    tensors are ready when returned)."""
    import torch
    from torch.utils._pytree import tree_leaves

    devices = {
        a.device for a in tree_leaves(tree)
        if isinstance(a, torch.Tensor) and a.device.type == "cuda"
    }
    for device in devices:
        torch.cuda.synchronize(device)
    return tree
