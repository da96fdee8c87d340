"""Multi-tenant descriptor broker: many client streams, one offload engine
(counterpart of ``repro.service.broker``).

The paper's NetFPGA is a *shared* device: every host rank posts its request
packet at the same NIC, and the firmware combines compatible requests inside
one hardware pipeline pass. :class:`DescriptorBroker` is that front end in
software. Many in-process :class:`ServiceClient` handles (one per tenant)
submit wire-encoded :class:`~repro_torch.core.packet.CollectiveDescriptor`
requests into bounded queues; the broker groups compatible requests into
**coalesced dispatches** — one stacked payload through the wrapped
:class:`~repro_torch.offload.OffloadEngine` per fused group — and
distributes the unstacked results back through per-request tickets. Each
ticket's result is a tensor of its own (a copy out of the fused result, not
a view into it), so a tenant that writes into its result touches nobody
else's.

Coalescing rules (all must hold for two requests to fuse):

  * identical *normalized* descriptor words — same coll/op/dtype/count,
    same comm_size, same topology (axes + split), same algo; per-rank
    fields (rank, msg_type) are normalized away exactly like the engine's
    schedule-cache key;
  * identical payload structure: same pytree spec and same leaf
    shapes/dtypes/devices (so the payloads stack).

Fused payloads stack along a new batch axis *behind* the rank axis
(``(p, n) -> (p, k, n)``); every collective in the repo reduces along the
leading rank axis elementwise over the rest, so the fused result is
**bitwise identical** to k separate dispatches — the service never changes
numerics, only amortizes dispatch and compilation. Fused widths are padded
to the next power of two with zero columns (``coalesce_pad_pow2``): the
padding rides the elementwise batch axis and is dropped at unstack time, so
a broker compiles at most log2(max_coalesce) fused shapes per descriptor
instead of one per group size the traffic happens to produce.

Flow control, like the paper's ACK-based back-to-back flow control:

  * per-tenant bounded queues — a client over its bound either blocks
    (``block=True``, bounded by ``timeout``) or is rejected with
    :class:`QueueFullError`; other tenants are unaffected;
  * broker-wide admission control — ``max_pending`` caps total queued
    requests and ``max_tenants`` caps open client streams
    (:class:`AdmissionError`);
  * a **deadline-based flush**: a request waits at most
    ``flush_interval_s`` for companions before its group dispatches, so a
    lone tenant is never starved waiting for traffic that isn't coming.

The broker runs its flush loop on a daemon thread (``start()``/``stop()``);
``drain()`` pumps synchronously for deterministic tests and for use without
a thread. The flush thread dispatches on the engine's device (the current
CUDA device is per thread) and on its default stream, so a client's reads
of a result are ordered after the kernel that wrote it. Execution mode is
fixed per broker: sim (default) or the engine's driver mode
(``axis_name=...``, ``mesh=...`` a :class:`repro_torch.compat.Mesh`), where
each fused dispatch runs the schedule per rank under the port's
``shard_map``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import contextlib

import numpy as np
import torch

from repro_torch.core.packet import CollType, CollectiveDescriptor
from repro_torch.core.trees import tree_flatten, tree_map
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.offload import reliability as _rel
from repro_torch.offload.engine import AxisSpec, OffloadEngine
from repro_torch.service.telemetry import ServiceTelemetry

PyTree = Any

#: default bound on ``ServiceTicket.result()`` — callers that don't pass a
#: timeout must never block forever on an abandoned request (a crashed
#: broker, a stopped flush loop); pass ``timeout=None`` explicitly to wait
#: unboundedly
DEFAULT_RESULT_TIMEOUT_S = 120.0

_UNSET = object()


class QueueFullError(RuntimeError):
    """A tenant exceeded its queue bound (or the broker its pending cap)."""


class AdmissionError(RuntimeError):
    """The broker refused to open another client stream."""


class BrokerStopped(RuntimeError):
    """Submitted to (or waited on) a broker that has shut down."""


class ServiceTicket:
    """One request's future: filled by the broker's flush, read by the
    submitting tenant."""

    def __init__(self, tenant: str, seqno: int):
        self.tenant = tenant
        self.seqno = seqno
        self._event = threading.Event()
        self._result: PyTree = None
        self._error: Optional[BaseException] = None

    def _fulfill(self, result: PyTree) -> None:
        self._result = result
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Any = _UNSET) -> PyTree:
        """Wait for the result (or raise the request's failure).

        ``timeout`` defaults to :data:`DEFAULT_RESULT_TIMEOUT_S`; pass
        ``None`` to wait forever (explicit opt-in only).
        """
        if timeout is _UNSET:
            timeout = DEFAULT_RESULT_TIMEOUT_S
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.tenant}#{self.seqno} not completed within "
                f"{timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result


class _Request:
    __slots__ = (
        "tenant", "desc", "payload", "ticket", "submit_t", "flush_at",
        "deadline_at", "group_key", "submit_span_id", "submit_us",
        "checksum",
    )

    def __init__(self, tenant, desc, payload, ticket, submit_t, flush_at,
                 deadline_at, checksum=None):
        self.tenant = tenant
        self.desc = desc
        self.payload = payload
        self.ticket = ticket
        self.submit_t = submit_t
        self.flush_at = flush_at
        self.deadline_at = deadline_at
        # submit-time payload digest (reliability mode): verified again at
        # dispatch so at-rest corruption is caught and quarantined
        self.checksum = checksum
        # trace linkage: the submitting side's span id and enqueue time on
        # the tracer clock, so the dispatch thread can retroactively record
        # this request's broker.queue_wait span with the right parent
        self.submit_span_id: Optional[int] = None
        self.submit_us: float = 0.0
        # computed once at submit time: encoding the normalized descriptor
        # and walking the payload pytree per flush cycle would repeat per
        # queued request on every wakeup
        self.group_key = (
            desc.normalized().encode().tobytes(),
            _payload_signature(payload),
        )


def _payload_signature(x: PyTree) -> Optional[Tuple]:
    if x is None:
        return None
    leaves, spec = tree_flatten(x)
    return (
        str(spec),
        tuple((tuple(l.shape), str(l.dtype), str(l.device)) for l in leaves),
    )


def _own(tree: PyTree) -> PyTree:
    """A copy of every leaf: a ticket's result never shares memory with
    another ticket's."""
    return tree_map(torch.clone, tree)


class ServiceClient:
    """One tenant's handle on the broker: bounded submit + ticket results."""

    def __init__(
        self,
        broker: "DescriptorBroker",
        tenant: str,
        *,
        max_queue_depth: int = 32,
        block: bool = False,
    ):
        self.broker = broker
        self.tenant = tenant
        self.max_queue_depth = int(max_queue_depth)
        self.block = bool(block)
        self._seq = itertools.count()
        self._closed = False

    def submit(
        self,
        descriptor: "CollectiveDescriptor | np.ndarray",
        x: Optional[PyTree] = None,
        *,
        block: Optional[bool] = None,
        timeout: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> ServiceTicket:
        """Enqueue one wire-encoded request; returns immediately with a
        ticket (backpressure permitting)."""
        if self._closed:
            raise BrokerStopped(f"client {self.tenant!r} is closed")
        return self.broker._submit(
            self,
            descriptor,
            x,
            block=self.block if block is None else block,
            timeout=timeout,
            deadline_s=deadline_s,
        )

    def offload(
        self,
        descriptor: "CollectiveDescriptor | np.ndarray",
        x: Optional[PyTree] = None,
        *,
        timeout: Optional[float] = 60.0,
    ) -> PyTree:
        """Synchronous convenience: submit and wait for the result."""
        return self.submit(descriptor, x).result(timeout)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.broker._release_client(self)


class DescriptorBroker:
    """Coalescing front end over one :class:`OffloadEngine`."""

    def __init__(
        self,
        engine: Optional[OffloadEngine] = None,
        *,
        axis_name: AxisSpec = None,
        mesh: Any = None,
        flush_interval_s: float = 0.002,
        max_coalesce: int = 64,
        max_pending: int = 1024,
        max_tenants: int = 64,
        registry: Any = None,
        coalesce_pad_pow2: bool = True,
        reliability: "_rel.ReliabilityPolicy | bool | None" = None,
    ):
        if mesh is not None and axis_name is None:
            raise ValueError("driver mode (mesh=...) requires axis_name")
        # the default engine runs on the card (raises without CUDA); pass
        # OffloadEngine(device="cpu") to run on the CPU
        self.engine = engine if engine is not None else OffloadEngine()
        # the reliable dispatch path is opt-in: None keeps the historical
        # fail-the-whole-group-once semantics byte-for-byte
        if reliability is True:
            reliability = _rel.ReliabilityPolicy()
        self.reliability: Optional[_rel.ReliabilityPolicy] = (
            reliability or None
        )
        self._dispatcher: Optional[_rel.ReliableDispatcher] = (
            None
            if self.reliability is None
            else _rel.ReliableDispatcher.from_policy(
                self.engine, self.reliability
            )
        )
        self.axis_name = axis_name
        self.mesh = mesh
        self.flush_interval_s = float(flush_interval_s)
        self.max_coalesce = max(1, int(max_coalesce))
        self.coalesce_pad_pow2 = bool(coalesce_pad_pow2)
        self.max_pending = int(max_pending)
        self.max_tenants = int(max_tenants)
        self.registry = registry
        self.telemetry = ServiceTelemetry(self.engine.telemetry)
        self.tuning_table = None
        if registry is not None:
            table = registry.fetch(device=self.engine.device)
            if table is not None:
                self.tuning_table = table.activate()

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[_Request] = []
        # requests handed to a dispatch but not completed, per tenant; they
        # still count against the tenant's queue bound so a slow engine
        # can't be outrun by resubmission
        self._inflight: Dict[str, int] = {}
        self._clients: Dict[str, ServiceClient] = {}
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._tenant_seq = itertools.count()

    # -- client lifecycle --------------------------------------------------

    def client(
        self,
        tenant: Optional[str] = None,
        *,
        max_queue_depth: int = 32,
        block: bool = False,
    ) -> ServiceClient:
        """Open one tenant stream (admission-controlled)."""
        with self._lock:
            if self._stopping:
                raise BrokerStopped("broker is shut down")
            if tenant is None:
                tenant = f"tenant{next(self._tenant_seq)}"
            if tenant in self._clients:
                raise AdmissionError(f"tenant {tenant!r} already has a stream")
            if len(self._clients) >= self.max_tenants:
                raise AdmissionError(
                    f"broker at max_tenants={self.max_tenants}; "
                    f"refusing stream for {tenant!r}"
                )
            handle = ServiceClient(
                self, tenant, max_queue_depth=max_queue_depth, block=block
            )
            self._clients[tenant] = handle
            return handle

    def _release_client(self, client: ServiceClient) -> None:
        with self._lock:
            self._clients.pop(client.tenant, None)

    def make_descriptor(self, coll: "CollType | str", **kw):
        """Build a request descriptor through the engine's selector (under
        the registry-activated tuning table when one was fetched)."""
        return self.engine.make_descriptor(coll, **kw)

    # -- submission --------------------------------------------------------

    def _submit(
        self,
        client: ServiceClient,
        descriptor: "CollectiveDescriptor | np.ndarray",
        x: Optional[PyTree],
        *,
        block: bool,
        timeout: Optional[float],
        deadline_s: Optional[float],
    ) -> ServiceTicket:
        desc = OffloadEngine._as_descriptor(descriptor)
        tenant = client.tenant
        tracer = obs_tracing.get_tracer()
        submit_t0 = obs_tracing.now_us() if tracer.enabled else 0.0
        with self._cond:
            if self._stopping:
                raise BrokerStopped("broker is shut down")

            def over_bound() -> bool:
                depth = sum(
                    1 for r in self._queue if r.tenant == tenant
                ) + self._inflight.get(tenant, 0)
                return (
                    depth >= client.max_queue_depth
                    or len(self._queue) >= self.max_pending
                )

            if over_bound():
                if not block:
                    self.telemetry.record_reject(tenant)
                    raise QueueFullError(
                        f"tenant {tenant!r} at queue bound "
                        f"{client.max_queue_depth} (broker pending "
                        f"{len(self._queue)}/{self.max_pending})"
                    )
                start = time.monotonic()
                while over_bound():
                    remaining = (
                        None
                        if timeout is None
                        else timeout - (time.monotonic() - start)
                    )
                    if remaining is not None and remaining <= 0:
                        self.telemetry.record_reject(tenant)
                        raise QueueFullError(
                            f"tenant {tenant!r} blocked on full queue for "
                            f"{timeout}s"
                        )
                    self._cond.wait(remaining)
                    if self._stopping:
                        raise BrokerStopped("broker is shut down")
            now = time.monotonic()
            ticket = ServiceTicket(tenant, next(client._seq))
            checksum = None
            if (
                self.reliability is not None
                and self.reliability.checksums
                and x is not None
            ):
                checksum = _rel.payload_checksum(x)
            req = _Request(
                tenant,
                desc,
                x,
                ticket,
                now,
                now + self.flush_interval_s,
                None if deadline_s is None else now + float(deadline_s),
                checksum,
            )
            if tracer.enabled:
                # the span covers admission + any backpressure wait; its id
                # parents the queue_wait span the dispatch thread records
                req.submit_us = obs_tracing.now_us()
                req.submit_span_id = tracer.add_span(
                    "service.submit", "service",
                    submit_t0, req.submit_us,
                    parent_id=tracer.current_span_id(),
                    tenant=tenant,
                    coll=desc.coll_type.name.lower(),
                    seqno=ticket.seqno,
                )
            self._queue.append(req)
            self.telemetry.record_submit(tenant)
            self._cond.notify_all()
        return ticket

    # -- flush loop --------------------------------------------------------

    def start(self) -> "DescriptorBroker":
        with self._lock:
            if self._thread is not None:
                return self
            self._stopping = False
            self._thread = threading.Thread(
                target=self._loop, name="descriptor-broker", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the flush loop; by default dispatch whatever is queued first."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)
            if thread.is_alive():
                # a wedged dispatch (e.g. a hung compile) must not be raced
                # by a force-pump, and `running` must keep reporting it
                raise TimeoutError(
                    f"broker flush thread did not stop within {timeout}s; "
                    "a dispatch is still running"
                )
            self._thread = None
        if drain:
            self._pump(force=True)
        with self._cond:
            dropped, self._queue = self._queue, []
        now = time.monotonic()
        for req in dropped:
            # account the drop before failing the ticket so queue_depth and
            # submitted == completed + errors + rejected stay consistent
            self.telemetry.record_complete(
                req.tenant, now - req.submit_t, error=True
            )
            req.ticket._fail(BrokerStopped("broker stopped"))

    def __enter__(self) -> "DescriptorBroker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def drain(self) -> int:
        """Synchronously dispatch everything queued (maximal coalescing);
        returns the number of requests completed. The deterministic pump for
        tests and threadless embedding."""
        return self._pump(force=True)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait()
                if self._stopping:
                    return
                # the deadline flush: wait until the oldest queued request's
                # window closes, letting companions accumulate, never longer
                wakeup = min(r.flush_at for r in self._queue)
                delay = wakeup - time.monotonic()
                if delay > 0:
                    self._cond.wait(delay)
                    continue
            self._pump(force=False)

    def _device_scope(self):
        """Make the engine's device current on the dispatching thread (the
        current CUDA device is per thread; a fresh flush thread starts on
        device 0)."""
        device = self.engine.device if self.mesh is None else self.mesh.device
        if device.type == "cuda":
            return torch.cuda.device(device)
        return contextlib.nullcontext()

    def _pump(self, *, force: bool) -> int:
        with self._cond:
            now = time.monotonic()
            if force:
                batch, self._queue = self._queue[:], []
            else:
                # take every group with at least one expired member: the
                # expired request pulls its (younger) companions along
                expired_keys = {
                    r.group_key for r in self._queue if r.flush_at <= now
                }
                batch = [
                    r for r in self._queue if r.group_key in expired_keys
                ]
                self._queue = [
                    r for r in self._queue if r.group_key not in expired_keys
                ]
            for req in batch:
                self._inflight[req.tenant] = (
                    self._inflight.get(req.tenant, 0) + 1
                )
            self._cond.notify_all()
        if not batch:
            return 0
        groups: Dict[Tuple, List[_Request]] = {}
        for req in batch:
            groups.setdefault(req.group_key, []).append(req)
        completed = 0
        with self._device_scope():
            for reqs in groups.values():
                for chunk_at in range(0, len(reqs), self.max_coalesce):
                    chunk = reqs[chunk_at : chunk_at + self.max_coalesce]
                    self._dispatch_group(chunk, deadline=not force)
                    completed += len(chunk)
        return completed

    def _dispatch_group(
        self, reqs: List[_Request], *, deadline: bool = False
    ) -> None:
        desc = reqs[0].desc
        barrier = desc.coll_type == CollType.BARRIER
        start_t = time.monotonic()
        tracer = obs_tracing.get_tracer()
        if tracer.enabled:
            # queue_wait runs from each request's enqueue to this dispatch:
            # it starts on the client thread and ends here, so it is
            # recorded retroactively with the submit span as parent
            dispatch_t0 = obs_tracing.now_us()
            for req in reqs:
                tracer.add_span(
                    "broker.queue_wait", "broker",
                    req.submit_us or dispatch_t0, dispatch_t0,
                    parent_id=req.submit_span_id,
                    tenant=req.tenant,
                )
        group_cm = tracer.span(
            "broker.dispatch_group", "broker",
            coll=desc.coll_type.name.lower(),
            group=len(reqs),
            deadline=deadline,
        )
        group_cm.__enter__()
        try:
            # the optimized flag shapes the compiled schedule, so a fused
            # group must agree on it. Normal grouping guarantees this (the
            # flag travels in the normalized words the group key hashes);
            # the check guards direct/manual dispatch paths.
            flags = {bool(r.desc.optimized) for r in reqs}
            if len(flags) > 1:
                raise ValueError(
                    "cannot coalesce requests with mixed plan-optimizer "
                    "flags: optimized and unoptimized descriptors compile "
                    "different schedules"
                )
            if self._dispatcher is None:
                try:
                    outcomes = [(reqs, self._run_group(reqs), None)]
                except Exception as e:  # noqa: BLE001 - via tickets
                    outcomes = [(reqs, [None] * len(reqs), e)]
            else:
                outcomes = self._run_group_reliable(reqs)
        except Exception as e:  # noqa: BLE001 - reported through tickets
            outcomes = [(reqs, [None] * len(reqs), e)]
        finally:
            group_cm.__exit__(None, None, None)
        done_t = time.monotonic()
        any_err = any(err is not None for _, _, err in outcomes)
        self.telemetry.record_flush(len(reqs), 1, deadline=deadline)
        obs_events.record(
            "flush",
            coll=desc.coll_type.name.lower(),
            requests=len(reqs),
            deadline=deadline,
            error=any_err,
        )
        with self._cond:
            for req in reqs:
                n = self._inflight.get(req.tenant, 0) - 1
                if n > 0:
                    self._inflight[req.tenant] = n
                else:
                    self._inflight.pop(req.tenant, None)
            self._cond.notify_all()
        for sub, results, err in outcomes:
            for req, result in zip(sub, results):
                missed = (
                    req.deadline_at is not None and done_t > req.deadline_at
                )
                if missed:
                    # the post-hoc diagnosis record: was the miss queue
                    # time (waited too long for a flush) or dispatch time
                    # (the group itself was slow)?
                    obs_events.record(
                        "deadline_miss",
                        tenant=req.tenant,
                        coll=desc.coll_type.name.lower(),
                        group=len(reqs),
                        queue_wait_s=round(start_t - req.submit_t, 6),
                        dispatch_s=round(done_t - start_t, 6),
                        overrun_s=round(done_t - req.deadline_at, 6),
                    )
                self.telemetry.record_complete(
                    req.tenant,
                    done_t - req.submit_t,
                    error=err is not None,
                    deadline_missed=missed,
                )
                if err is not None:
                    req.ticket._fail(err)
                else:
                    req.ticket._fulfill(result)

    def _run_group(self, reqs: List[_Request]) -> List[PyTree]:
        """Dispatch one compatible group (stacked when fusable); returns
        per-request results. In reliability mode each request's submit-time
        checksum is re-verified first — a poisoned payload fails the whole
        attempt with an attributed IntegrityError, which the bisection
        driver then isolates — and the dispatch runs through the
        ReliableDispatcher (retries/breaker/degradation) bounded by the
        group's earliest request deadline."""
        desc = reqs[0].desc
        barrier = desc.coll_type == CollType.BARRIER
        if self._dispatcher is None:
            dispatch = lambda d, x: self.engine.offload(  # noqa: E731
                d, x, axis_name=self.axis_name, mesh=self.mesh
            )
        else:
            for r in reqs:
                if r.checksum is not None:
                    _rel.verify_payload(
                        r.payload, r.checksum,
                        request=f"{r.tenant}#{r.ticket.seqno}",
                    )
            deadlines = [
                r.deadline_at for r in reqs if r.deadline_at is not None
            ]
            deadline_at = min(deadlines) if deadlines else None
            dispatch = lambda d, x: self._dispatcher.offload(  # noqa: E731
                d, x, self.axis_name, self.mesh, deadline=deadline_at
            )
        if barrier or len(reqs) == 1:
            out = dispatch(desc, reqs[0].payload)
            return [out] + [_own(out) for _ in reqs[1:]]
        payloads = [r.payload for r in reqs]
        if self.coalesce_pad_pow2:
            width = 1 << (len(payloads) - 1).bit_length()
            pad = tree_map(torch.zeros_like, payloads[0])
            payloads += [pad] * (width - len(payloads))
        stacked = tree_map(
            lambda *leaves: torch.stack(leaves, dim=1),
            *payloads,
        )
        fused = dispatch(desc, stacked)
        # fused[:, i] would be a view into the one fused buffer: copy each
        # ticket's columns out so results stay fresh tensors
        return [
            tree_map(lambda l, i=i: l[:, i].clone(), fused)
            for i in range(len(reqs))
        ]

    def _run_group_reliable(
        self, reqs: List[_Request]
    ) -> List[Tuple[List[_Request], List[PyTree], Optional[BaseException]]]:
        """Dispatch with group bisection: a failed fused dispatch splits in
        half, so exactly the poisoned request(s) are quarantined — their
        tickets fail with the *original* error — while clean neighbors
        retry and complete. Returns ``(sub_requests, results, error)``
        leaves covering ``reqs``.

        Deliberately an iterative worklist, not a recursive closure: a
        closure calling itself is a reference cycle (function ↔ cell)
        that keeps every captured payload/result buffer alive until the
        *cyclic* gc runs, and stalling multi-MiB device buffers like that
        defeats the allocator's reuse on the hot path (measured as a
        payload-scaling dispatch slowdown). Plain refcounting must be
        able to free each sub-group's buffers the moment its outcome is
        recorded.
        """
        outcomes: List[
            Tuple[List[_Request], List[PyTree], Optional[BaseException]]
        ] = []
        coll = reqs[0].desc.coll_type.name.lower()
        nreqs = len(reqs)
        # LIFO worklist, right half pushed first → left-to-right order,
        # same as the recursion it replaces
        work: List[List[_Request]] = [list(reqs)]
        while work:
            sub = work.pop()
            try:
                outcomes.append((sub, self._run_group(sub), None))
                continue
            except Exception as e:  # noqa: BLE001 - via tickets
                if len(sub) > 1 and self.reliability.bisect:
                    obs_events.record(
                        "bisect",
                        coll=coll,
                        requests=len(sub),
                        error=type(e).__name__,
                    )
                    obs_metrics.get_registry().counter(
                        "repro_reliability_events_total",
                        "reliable-dispatch retries/degrades/breaker skips",
                        labelnames=("kind",),
                    ).inc(kind="bisect")
                    mid = (len(sub) + 1) // 2
                    work.append(sub[mid:])
                    work.append(sub[:mid])
                    continue
                err: BaseException = e
                if (
                    isinstance(err, _rel.RetryExhaustedError)
                    and err.last_error is not None
                ):
                    err = err.last_error
                if nreqs > 1:
                    obs_events.record(
                        "quarantine",
                        tenant=sub[0].tenant,
                        seqno=sub[0].ticket.seqno,
                        coll=coll,
                        error=type(err).__name__,
                    )
                    obs_metrics.get_registry().counter(
                        "repro_reliability_events_total",
                        "reliable-dispatch retries/degrades/breaker skips",
                        labelnames=("kind",),
                    ).inc(kind="quarantine")
                outcomes.append((sub, [None] * len(sub), err))
        return outcomes


__all__ = [
    "AdmissionError",
    "BrokerStopped",
    "DEFAULT_RESULT_TIMEOUT_S",
    "DescriptorBroker",
    "QueueFullError",
    "ServiceClient",
    "ServiceTicket",
]
