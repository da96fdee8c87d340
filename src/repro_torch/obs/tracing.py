"""In-process spans: where the offload stack and the model step spend the
host's time (the port's copy of ``repro.obs.tracing``, extended).

The paper's core evidence is a *measurement*: an on-NIC timer attributing
scan latency to the network device versus the host. The software stack has
many more places for the time to hide — broker queue, coalescing window,
schedule-cache lookup, lowering, the per-round host constant of the sim
interpreter, the kernel launch — so this module provides lightweight
host-side spans with explicit parent links. The span tree:

    service.submit  ->  broker.queue_wait  ->  broker.dispatch_group
      ->  engine.offload
            engine.prepare   decode, plan memo, backend, cache key, lookup,
                             payload validation
              ->  engine.compile             (a cache miss only)
              ->  engine.reuse               (a prepared dispatch only)
            engine.drain     the device sync before the schedule
            engine.schedule  the schedule: phase loop (or one packed K1
                             call), staging, launches
              ->  k1.stage, k1.launch        (one pair a K1 launch)
              ->  plan.phase:<KIND>:L<level> (traced lowering only)
                ->  plan.round:<i>
            engine.wait      the device sync after it
            engine.record    telemetry, metrics, flight recorder

    step.train  ->  step.forward, step.backward, step.optimizer
    step.prefill
    attn.block       one full-sequence attention layer (attention_block)
      ->  k5.call                    (where its attention runs on K5)
    k3.call          one K3 segment-scan call, wherever it runs
    k5.call          one K5 call (``kernels/flash_attention.py::attention``),
                     wherever it runs

Span categories (``cat``): ``service``, ``broker``, ``engine``, ``phase``,
``round``, ``kernel`` (``k1.*``, ``k3.call``, ``k5.call``), ``step``,
``attn``, ``profile``, and —
in link-probe mode (``Tracer(link_probe=True)``, see
:mod:`repro_torch.obs.health`) — ``link``, one span per (src, dst) message
of a round.

**Three sinks.** Every span opened with :func:`span` goes to:

* **a counter, always** (except while a ``torch.profiler`` session
  records): a process-wide ``(count, total ns)`` pair a span name, updated
  when the span closes from ``time.perf_counter_ns``
  (:func:`span_totals`; published on every scrape of the process registry
  as ``repro_span_total{span=...}`` and ``repro_span_seconds_total``). A
  profiler slows the host, so its windows stay out of the totals. Each
  thread keeps its own counters, so a span takes no lock. Cost, measured
  on the host of an H100 machine: 0.3-0.75 µs a site above a bare ``with``
  block (``PERF.md``), 8 sites a scan dispatch;
* **a profiler range, while a ``torch.profiler`` session records**: a
  ``record_function`` range of the span's name, gated on the module flag
  ``torch.autograd.profiler._is_profiler_enabled``, so the span sits in the
  same trace as the kernels, on the profiler's clock (12-14 µs a range on
  the same host);
* **the installed collecting** :class:`Tracer`, with parent links, as
  before. Timestamps are ``time.perf_counter()`` microseconds;
  :mod:`repro_torch.obs.export` serializes them to Chrome/Perfetto trace
  JSON and merges a ``torch.profiler`` trace's device events.

Only a collecting tracer changes what runs: the traced sim lowerings
(:func:`repro_torch.offload.planner.lower_sim` and
:func:`repro_torch.kernels.fused_collective.lower_fused` with
``traced=True``) emit phase- and round-level spans, synchronizing the device
at each boundary so a span's length is the work inside it. The counter and
profiler sinks wrap host-side work only and run the untraced schedule.

Usage::

    from repro_torch.obs import tracing

    with tracing.tracing() as tracer:        # installs + restores
        engine.offload(desc, x)              # sim dispatch -> round spans
    spans = tracer.spans()
    tracing.span_totals()["engine.offload"]  # (count, ns) outside profilers
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from torch.autograd import profiler as _autograd_profiler

from repro_torch.obs import metrics as obs_metrics

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
    "span",
    "span_totals",
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


# -- spans on all three sinks -------------------------------------------------

_perf_ns = time.perf_counter_ns
_local = threading.local()
#: every thread's ``{name: _Site}``, kept after the thread ends
_thread_sites: List[Dict[str, "_Site"]] = []
_thread_sites_lock = threading.Lock()


class _Site:
    """One span name's counter on one thread, and the span context of the
    counter sink: the start times of its open spans on a stack (a name may
    nest in itself). Only its own thread writes it, so it needs no lock;
    its handle's ``set`` drops the arguments."""

    __slots__ = ("starts", "count", "ns")
    span_id = None

    def __init__(self):
        self.starts: List[int] = []
        self.count = 0
        self.ns = 0

    def __enter__(self) -> "_Site":
        self.starts.append(_perf_ns())
        return self

    def __exit__(self, *exc: Any) -> None:
        ns = _perf_ns() - self.starts.pop()
        if not _autograd_profiler._is_profiler_enabled:
            self.count += 1
            self.ns += ns

    def set(self, **kw: Any) -> None:
        return None


def _site(name: str) -> _Site:
    """This thread's counter of ``name``, made on first use."""
    sites = getattr(_local, "sites", None)
    if sites is None:
        sites = _local.sites = {}
        with _thread_sites_lock:
            _thread_sites.append(sites)
    site = sites.get(name)
    if site is None:
        site = sites[name] = _Site()
    return site


class _SinkSpan:
    """A span while a collecting tracer is installed or a profiler records:
    a ``record_function`` range under the profiler, a collected span under
    the tracer (whose handle it yields), the counter outside profilers."""

    __slots__ = ("site", "name", "cat", "args", "tracer", "t0", "_range",
                 "_collected")
    span_id = None

    def __init__(self, site: _Site, name: str, cat: str, tracer: Any,
                 args: Dict[str, Any]):
        self.site, self.name, self.cat = site, name, cat
        self.tracer, self.args = tracer, args
        self._range = self._collected = None

    def __enter__(self) -> Any:
        handle = self
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        if self.tracer.enabled:
            self._collected = self.tracer.span(self.name, self.cat, **self.args)
            handle = self._collected.__enter__()
        self.t0 = _perf_ns()
        return handle

    def __exit__(self, *exc: Any) -> None:
        ns = _perf_ns() - self.t0
        if not _autograd_profiler._is_profiler_enabled:
            self.site.count += 1
            self.site.ns += ns
        if self._collected is not None:
            self._collected.__exit__(*exc)
        if self._range is not None:
            self._range.__exit__(*exc)

    def set(self, **kw: Any) -> None:
        return None


def span(name: str, cat: str = "host", **args: Any) -> Any:
    """A span of the host's work named ``name``, on every sink that is on
    (the module docstring): ``with span("engine.offload", "engine") as s``.
    The handle's ``set(**kw)`` adds arguments, kept by a collecting tracer
    alone; its ``span_id`` is None unless a collecting tracer records it."""
    tracer = _active
    if tracer.enabled or _autograd_profiler._is_profiler_enabled:
        return _SinkSpan(_site(name), name, cat, tracer, args)
    try:
        return _local.sites[name]
    except (AttributeError, KeyError):
        return _site(name)


def span_totals() -> Dict[str, Tuple[int, int]]:
    """``{name: (closed spans, total ns)}`` of every span closed in this
    process outside a ``torch.profiler`` session, summed over threads (a
    span closing while this reads may show in its count and not yet in its
    time)."""
    with _thread_sites_lock:
        every = list(_thread_sites)
    out: Dict[str, Tuple[int, int]] = {}
    for sites in every:
        for name, site in list(sites.items()):
            if site.count:
                count, ns = out.get(name, (0, 0))
                out[name] = (count + site.count, ns + site.ns)
    return out


def _publish(registry: "obs_metrics.MetricsRegistry") -> None:
    """The span totals as two counter series of ``registry``, read at every
    scrape."""
    registry.callback_counter(
        "repro_span_total", "spans closed outside a profiler session",
        ("span",), lambda: {(n,): c for n, (c, _) in span_totals().items()})
    registry.callback_counter(
        "repro_span_seconds_total",
        "host seconds in spans closed outside a profiler session", ("span",),
        lambda: {(n,): ns * 1e-9 for n, (_, ns) in span_totals().items()})


obs_metrics.add_process_series(_publish)


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
