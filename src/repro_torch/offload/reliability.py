"""The reliable dispatch layer: checksums, retries, breakers, degradation
(counterpart of ``repro.offload.reliability``).

The paper's NetFPGA collectives ride raw Ethernet media-access frames — a
medium that loses and corrupts packets — so a deployable offload engine
needs the reliability protocol the NIC-based collective literature builds
first (PAPERS.md, cs/0402027: NIC-level ACK/retransmit; 1709.05483:
per-packet handlers). This module is that protocol's software analogue,
sitting between the service broker and the engine:

* :func:`payload_checksum` / :func:`verify_payload` — a canonical-bytes
  checksum over a payload pytree (dtype, shape, and tree structure mixed
  in), computed at broker submit and re-verified at dispatch so at-rest
  corruption surfaces as a typed
  :class:`~repro_torch.core.packet.IntegrityError` instead of a silently
  wrong prefix sum. The digest is a vectorized position-weighted fold with
  tiered coverage (full single-bit detection for leaves <= 16 KiB,
  deterministic run-sampling above — see :func:`_fold_bytes`; it is not
  cryptographic). The sampled bytes are gathered on the payload's device
  and copied to the host once per payload; the lane sums equal the
  reference's for the same bytes. The structure digest comes from the
  port's pytree spec, whose text differs from a JAX treedef's, so whole
  digests differ between the two packages. Descriptor words get a real
  CRC32 via ``repro_torch.core.packet.wire_checksum`` — they are tiny.

* :class:`RetryPolicy` — bounded attempts with deterministic exponential
  backoff that never sleeps (or retries) past an absolute deadline.
  Retryable faults are the *transient transport* kinds:
  :class:`~repro_torch.runtime.chaos.TransportError` (lost message — a
  retransmit fixes it) and in-flight :class:`IntegrityError` (receiver
  CRC reject — ditto). Exhaustion raises :class:`RetryExhaustedError`
  carrying the last underlying error.

* :class:`CircuitBreaker` — per-(backend, coll) keyed; trips open after
  ``failure_threshold`` consecutive failures, fails fast while open, and
  recovers through half-open probes after ``cooldown_s``. State changes
  land in the flight recorder and the ``repro_breaker_state`` gauge;
  ``snapshot()`` feeds ``HealthMonitor.healthz()``.

* :class:`ReliableDispatcher` — wraps ``engine.offload`` with the
  graceful-degradation chain: requested backend (e.g. pallas) → default
  backend → raw (unoptimized, unchunked) plan → :func:`reference_collective`
  (the direct schedules in plain PyTorch, no engine machinery and no
  kernel, immune to chaos).
  Each stage runs under the retry policy and its own breaker key; every
  retry, degradation, and breaker transition is counted in telemetry,
  metrics, and the flight recorder. Caller bugs (``ValueError`` & co.),
  host-failure signals (``SimulatedFailure`` — the remesh loop owns those)
  and a kernel that fails to build or launch (a plain ``RuntimeError``)
  propagate immediately, undegraded: no rung may hide a broken kernel
  behind the default lowering.

The broker composes these per coalesced group and adds bisection: a
failed fused dispatch splits its group to quarantine exactly the poisoned
request(s) while clean neighbors retry and complete (see
``repro_torch.service.broker``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.packet import CollectiveDescriptor, CollType, IntegrityError
from repro_torch.core.trees import checked_device, tree_device, tree_flatten
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime.chaos import TransportError

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "IntegrityError",
    "ReliabilityPolicy",
    "ReliableDispatcher",
    "RetryExhaustedError",
    "RetryPolicy",
    "TransportError",
    "payload_checksum",
    "reference_collective",
    "verify_payload",
]

PyTree = Any


class RetryExhaustedError(RuntimeError):
    """Every attempt of a retryable dispatch failed.

    ``last_error`` is the final underlying fault — the broker unwraps it
    when failing a quarantined ticket, so callers see the *original*
    error, not the retry bookkeeping.
    """

    def __init__(
        self, message: str, *, last_error: Optional[BaseException] = None,
        attempts: int = 0,
    ):
        super().__init__(message)
        self.last_error = last_error
        self.attempts = attempts


class CircuitOpenError(RuntimeError):
    """Dispatch refused because every eligible stage's breaker is open."""


#: transient transport faults a retry can fix (a retransmit re-sends the
#: frame; chaos decisions advance per message, so a retry draws fresh ones)
RETRYABLE_ERRORS: Tuple[type, ...] = (TransportError, IntegrityError)


# ---------------------------------------------------------------------------
# Payload integrity
# ---------------------------------------------------------------------------

#: odd 64-bit lane weights (splitmix64 outputs) — position sensitivity
#: across the fold so swapped blocks don't cancel like plain XOR would
_LANE_WEIGHTS = (
    0x9E3779B97F4A7C15,
    0xBF58476D1CE4E5B9,
    0x94D049BB133111EB,
    0xD6E8FEB86659FD93,
    0xA5A5A5A5A5A5A5A5 | 1,
    0xC2B2AE3D27D4EB4F,
    0x165667B19E3779F9,
    0x27D4EB2F165667C5,
)
_MASK64 = (1 << 64) - 1


#: full single-bit coverage up to this many 64-byte blocks per leaf;
#: larger leaves fold a deterministic stride-sample of the same size
#: (``$REPRO_CHECKSUM_FULL=1`` forces full coverage at any size)
_FULL_COVER_BLOCKS = 256  # 16 KiB

#: contiguous sampled runs per oversized leaf (see ``_fold_bytes``)
_SAMPLE_RUNS = 32


_FULL_COVERAGE: Optional[bool] = None


def _full_coverage() -> bool:
    # read once: os.environ lookups cost ~15 us here, far too slow for a
    # per-fold check (tests reset the cache via _reset_full_coverage)
    global _FULL_COVERAGE
    if _FULL_COVERAGE is None:
        _FULL_COVERAGE = (
            os.environ.get("REPRO_CHECKSUM_FULL", "") not in ("", "0")
        )
    return _FULL_COVERAGE


def _reset_full_coverage() -> None:
    global _FULL_COVERAGE
    _FULL_COVERAGE = None


def _mix_lanes(col: List[int], h: int) -> int:
    for c, w in zip(col, _LANE_WEIGHTS):
        h ^= (c * w) & _MASK64
        h = ((h << 7) | (h >> 57)) & _MASK64
    return h


def _gather(view: torch.Tensor) -> torch.Tensor:
    """The bytes :func:`_fold_bytes` reads from a flat uint8 tensor, on its
    device: the whole body up to ``_FULL_COVER_BLOCKS`` 64-byte blocks (or
    under ``$REPRO_CHECKSUM_FULL``), else ``_SAMPLE_RUNS`` evenly spaced
    runs of the same total size; then the final partial block."""
    n = view.numel()
    tail = n % 64
    nw = (n - tail) // 8
    cap = _FULL_COVER_BLOCKS * 8  # budget in 8-byte words
    if nw > cap and not _full_coverage():
        spacing = (nw // _SAMPLE_RUNS) * 8
        runlen = (cap // _SAMPLE_RUNS) * 8
        body = view[: _SAMPLE_RUNS * spacing].view(_SAMPLE_RUNS, spacing)
        return torch.cat([body[:, :runlen].reshape(-1), view[n - tail:]])
    return view


def _fold_gathered(buf: np.ndarray, n: int, h: int) -> int:
    """Fold the bytes :func:`_gather` took from an ``n``-byte leaf (a host
    uint8 array) into ``h`` — the reference's fold, lane for lane."""
    tail = n % 64
    body = buf[: buf.size - tail]
    if body.size:
        w = body.view(np.uint64)
        # modular *sum* per lane, not xor: xor cancels exactly whenever
        # an even number of a lane's words get the same corruption mask
        # (a uniform bit-flip over a slice is the textbook case); a
        # wrapping sum moves by each word's data-dependent delta, so any
        # single flipped word always lands and uniform masks cannot
        # cancel.
        col = np.add.reduce(w.reshape(8, -1), axis=1).tolist()
        h = _mix_lanes(col, h)
    if tail:
        last = np.zeros(64, np.uint8)
        last[:tail] = buf[buf.size - tail:]
        h = _mix_lanes(last.view(np.uint64).tolist(), h)
    h ^= n
    return (h * 0x9E3779B97F4A7C15) & _MASK64


def _fold_bytes(view: torch.Tensor, h: int) -> int:
    """Fold a flat uint8 tensor into ``h`` (64-bit lanes, weighted mix).

    Leaves up to ``_FULL_COVER_BLOCKS`` 64-byte blocks are folded in
    full — any single flipped bit changes the digest. Above that the
    fold covers ``_SAMPLE_RUNS`` evenly spaced **contiguous runs**
    totalling the same byte budget, plus the final partial block, so

    * corruption touching any contiguous region of ``>= nbytes /
      _SAMPLE_RUNS`` bytes (slice-scale software corruption — aliasing,
      row mutation — the dominant at-rest failure mode) always spans a
      run start and is detected unless the corrupted words' per-lane
      sum deltas cancel mod 2**64 — never the case for a single flipped
      word or a uniform mask, and
    * an isolated single-word event is detected with probability
      ``~ 16 KiB / nbytes`` (it must land in a sampled run; once
      sampled, detection is certain).

    The runs are gathered on the tensor's device and only they cross to
    the host (16 KiB and the tail per leaf), so a multi-MiB payload on the
    card costs a gather and one small copy, not a full transfer.
    ``$REPRO_CHECKSUM_FULL=1`` opts a deployment into full coverage at
    any size. Same bytes, same value as the reference's ``_fold_bytes``.
    """
    buf = _gather(view).cpu().numpy()
    return _fold_gathered(buf, view.numel(), h)


def _leaf_bytes(a: torch.Tensor) -> torch.Tensor:
    """A leaf's bytes as a flat uint8 tensor on its device (row-major, as
    numpy lays the reference's leaves out)."""
    return a.contiguous().reshape(-1).view(torch.uint8)


#: (tree spec, per-leaf (dtype, shape)) -> structure digest; payloads are
#: few distinct shapes per process, so this almost always hits
_META_CACHE: Dict[Any, int] = {}


def payload_checksum(tree: PyTree) -> int:
    """64-bit canonical-bytes checksum of a payload pytree.

    Covers every leaf's dtype/shape and the tree structure, plus the
    leaf bytes under the tiered-coverage rule of :func:`_fold_bytes`
    (full single-bit detection for leaves <= 16 KiB — which includes
    every descriptor and control payload — run-sampled above, full
    everywhere with ``$REPRO_CHECKSUM_FULL=1``). Every leaf's gathered
    bytes travel to the host in one copy.
    """
    leaves, spec = tree_flatten(tree)
    key = (spec,) + tuple((str(a.dtype), tuple(a.shape)) for a in leaves)
    h = _META_CACHE.get(key)
    if h is None:
        h = zlib.crc32(repr(key).encode("utf-8")) & _MASK64
        if len(_META_CACHE) < 1024:
            _META_CACHE[key] = h
    if not leaves:
        return h
    views = [_leaf_bytes(a) for a in leaves]
    parts = [_gather(v) for v in views]
    host = (parts[0] if len(parts) == 1 else torch.cat(parts)).cpu().numpy()
    at = 0
    for v, part in zip(views, parts):
        size = part.numel()
        h = _fold_gathered(host[at : at + size], v.numel(), h)
        at += size
    return h


def verify_payload(
    tree: PyTree, checksum: int, *, request: Optional[str] = None
) -> None:
    """Recompute and compare; mismatch raises :class:`IntegrityError`
    stamped with ``request`` (and recorded) so the broker can quarantine
    the poisoned submission without retrying it."""
    actual = payload_checksum(tree)
    if actual != checksum:
        obs_events.record(
            "integrity_fail", request=request, scope="payload"
        )
        obs_metrics.get_registry().counter(
            "repro_integrity_failures_total",
            "payload/descriptor checksum verification failures",
            labelnames=("scope",),
        ).inc(scope="payload")
        raise IntegrityError(
            f"payload checksum mismatch for request "
            f"{request or '<unattributed>'}: got {actual:#018x}, "
            f"expected {checksum:#018x} (corrupted at rest)",
            request=request,
        )


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded, deadline-aware retry with deterministic backoff.

    ``backoff(attempt)`` is exact exponential (no jitter — determinism is
    a feature here: chaos tests must be reproducible), capped at
    ``max_backoff_s``. ``run`` never sleeps past an absolute ``deadline``
    (``time.monotonic`` timebase, matching the broker's ``deadline_at``):
    if the next backoff would cross it, the attempt budget is forfeit and
    :class:`RetryExhaustedError` carries the last fault.
    """

    max_attempts: int = 3
    backoff_s: float = 0.001
    multiplier: float = 2.0
    max_backoff_s: float = 0.1
    retryable: Tuple[type, ...] = RETRYABLE_ERRORS

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def backoff(self, attempt: int) -> float:
        return min(
            self.backoff_s * self.multiplier ** attempt, self.max_backoff_s
        )

    def run(
        self,
        fn: Callable[[], Any],
        *,
        deadline: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
    ) -> Any:
        attempt = 0
        while True:
            try:
                return fn()
            except self.retryable as err:
                if attempt + 1 >= self.max_attempts:
                    raise RetryExhaustedError(
                        f"dispatch failed after {attempt + 1} attempts: "
                        f"{type(err).__name__}: {err}",
                        last_error=err,
                        attempts=attempt + 1,
                    ) from err
                pause = self.backoff(attempt)
                if deadline is not None and clock() + pause > deadline:
                    raise RetryExhaustedError(
                        f"dispatch failed after {attempt + 1} attempts and "
                        f"the {pause * 1e3:.3g} ms backoff would cross the "
                        f"deadline: {type(err).__name__}: {err}",
                        last_error=err,
                        attempts=attempt + 1,
                    ) from err
                if on_retry is not None:
                    on_retry(attempt, err)
                if pause > 0:
                    sleep(pause)
                attempt += 1


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _BreakerEntry:
    state: str = "closed"  # closed | open | half_open
    consecutive: int = 0
    opened_at: float = 0.0
    probes: int = 0
    trips: int = 0


class CircuitBreaker:
    """Keyed circuit breaker (keys are ``(backend_label, coll_name)``).

    ``allow(key)`` answers "may this stage attempt a dispatch now":
    closed → yes; open → no until ``cooldown_s`` elapsed, then the key
    moves to half-open; half-open → yes for up to ``half_open_probes``
    in-flight probes. ``record_success`` closes a half-open key and
    resets the failure streak; ``record_failure`` re-opens a half-open
    key immediately and opens a closed key once ``failure_threshold``
    consecutive failures accumulate. The clock is injectable so recovery
    is testable without real cooldowns.
    """

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        cooldown_s: float = 30.0,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = max(1, int(half_open_probes))
        self.clock = clock
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], _BreakerEntry] = {}

    def _entry(self, key: Tuple[str, str]) -> _BreakerEntry:
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = _BreakerEntry()
        return e

    def _transition(
        self, key: Tuple[str, str], e: _BreakerEntry, state: str
    ) -> None:
        e.state = state
        obs_events.record(
            f"breaker_{state}", backend=key[0], coll=key[1],
            consecutive=e.consecutive,
        )
        obs_metrics.get_registry().gauge(
            "repro_breaker_state",
            "circuit-breaker state (0 closed, 1 half-open, 2 open)",
            labelnames=("backend", "coll"),
        ).set(
            {"closed": 0, "half_open": 1, "open": 2}[state],
            backend=key[0], coll=key[1],
        )

    def allow(self, key: Tuple[str, str]) -> bool:
        with self._lock:
            e = self._entry(key)
            if e.state == "closed":
                return True
            if e.state == "open":
                if self.clock() - e.opened_at < self.cooldown_s:
                    return False
                e.probes = 0
                self._transition(key, e, "half_open")
            # half-open: admit a bounded number of probes
            if e.probes >= self.half_open_probes:
                return False
            e.probes += 1
            return True

    def record_success(self, key: Tuple[str, str]) -> None:
        with self._lock:
            e = self._entry(key)
            e.consecutive = 0
            if e.state != "closed":
                self._transition(key, e, "closed")

    def record_failure(self, key: Tuple[str, str]) -> None:
        with self._lock:
            e = self._entry(key)
            e.consecutive += 1
            if e.state == "half_open" or (
                e.state == "closed"
                and e.consecutive >= self.failure_threshold
            ):
                e.opened_at = self.clock()
                e.trips += 1
                self._transition(key, e, "open")

    def state(self, key: Tuple[str, str]) -> str:
        with self._lock:
            return self._entry(key).state

    def open_keys(self) -> List[Tuple[str, str]]:
        with self._lock:
            return [
                k for k, e in self._entries.items() if e.state != "closed"
            ]

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """JSON-ready state by ``"backend|coll"`` key (``/healthz`` body)."""
        with self._lock:
            return {
                f"{k[0]}|{k[1]}": {
                    "state": e.state,
                    "consecutive_failures": e.consecutive,
                    "trips": e.trips,
                }
                for k, e in self._entries.items()
            }


# ---------------------------------------------------------------------------
# Plain reference (last rung of the degradation ladder)
# ---------------------------------------------------------------------------


def reference_collective(
    desc: "CollectiveDescriptor | np.ndarray",
    x: Optional[PyTree],
    *,
    device: "torch.device | str" = "cuda",
) -> PyTree:
    """Run the descriptor's collective with the direct schedules of
    ``repro_torch.core`` in plain PyTorch on ``device`` (the card unless
    the caller passes ``"cpu"``) — no planner, no optimizer, no schedule
    cache, no chunking, no kernel, and a fresh ``SimBackend`` that no chaos
    wrapper ever touches.

    This is the degradation chain's floor: slower (whole-mesh flat
    schedules, rebuilt per call) but structurally incapable of failing
    for any reason the fancier paths can. Payload contract is the sim
    layout: stacked ``(p, ...)`` leaves in the plan's logical rank order,
    on ``device``. For exact operators (int dtypes, MAX/MIN) the result is
    bitwise-equal to the planned schedule; float SUM may differ in
    rounding (different combine tree), which is the documented accuracy
    cost of degrading.
    """
    from repro_torch.core import algorithms as alg
    from repro_torch.core.operators import get_operator
    from repro_torch.core.reduce_ops import (
        allreduce_schedule,
        barrier_schedule,
        reduce_schedule,
    )
    from repro_torch.core.scan_collective import sim_scan
    from repro_torch.offload.engine import OffloadEngine, wire_op_name

    device = checked_device(device, "reference_collective(device='cuda')")
    desc = OffloadEngine._as_descriptor(desc)
    op = get_operator(wire_op_name(desc.operation))
    p = int(desc.comm_size)
    if desc.coll_type == CollType.BARRIER:
        return barrier_schedule(alg.SimBackend(p, device))
    if x is None:
        raise ValueError("reference_collective needs a payload")
    if tree_device(x) != device:
        raise ValueError(
            f"payload lives on {tree_device(x)} but reference_collective "
            f"runs on {device}; move it explicitly"
        )
    if desc.coll_type == CollType.SCAN:
        return sim_scan(x, op, p, algorithm="recursive_doubling")
    if desc.coll_type == CollType.EXSCAN:
        return sim_scan(
            x, op, p, algorithm="recursive_doubling", inclusive=False
        )
    if desc.coll_type == CollType.REDUCE:
        return reduce_schedule(
            alg.SimBackend(p, device), x, op, root=int(desc.root)
        )
    if desc.coll_type == CollType.ALLREDUCE:
        return allreduce_schedule(alg.SimBackend(p, device), x, op)
    raise ValueError(f"unknown coll_type {desc.coll_type!r}")


# ---------------------------------------------------------------------------
# The reliable dispatcher
# ---------------------------------------------------------------------------

#: faults the degradation ladder may step down on; anything else (caller
#: bugs, SimulatedFailure host loss, a kernel's build or launch failure —
#: a plain RuntimeError) propagates to its owner undegraded
DEGRADABLE_ERRORS: Tuple[type, ...] = (
    RetryExhaustedError,
    TransportError,
    IntegrityError,
    CircuitOpenError,
    NotImplementedError,
)


@dataclasses.dataclass
class ReliabilityPolicy:
    """Broker-facing configuration bundle for the reliable dispatch path.

    ``checksums`` gates submit-time payload checksums; ``bisect`` gates
    group bisection on fused-dispatch failure; ``degrade`` gates the
    fallback ladder (off = retries only, then fail).
    """

    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    breaker: Optional[CircuitBreaker] = dataclasses.field(
        default_factory=CircuitBreaker
    )
    degrade: bool = True
    checksums: bool = True
    bisect: bool = True


class ReliableDispatcher:
    """``engine.offload`` with retries, breakers, and degradation.

    ``fault_injector`` optionally hooks a
    ``repro_torch.runtime.fault.FailureInjector`` whose ``check_dispatch()``
    runs before every attempt (probabilistic per-dispatch fault mode).
    ``clock``/``sleep`` are injectable for tests.
    """

    def __init__(
        self,
        engine: Any,
        *,
        retry: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        degrade: bool = True,
        fault_injector: Optional[Any] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.engine = engine
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = breaker
        self.degrade = bool(degrade)
        self.fault_injector = fault_injector
        self._clock = clock
        self._sleep = sleep
        self.counts: Dict[str, int] = {
            "dispatches": 0,
            "retries": 0,
            "degrades": 0,
            "breaker_skips": 0,
            "reference_dispatches": 0,
        }
        # (coll_name, ladder) per descriptor — building the ladder costs
        # two dataclasses.replace calls, too much for the happy path's
        # per-dispatch budget (the < 2% overhead gate)
        self._chains: Dict[
            CollectiveDescriptor,
            Tuple[str, List[Tuple[str, Optional[CollectiveDescriptor]]]],
        ] = {}

    @classmethod
    def from_policy(
        cls, engine: Any, policy: ReliabilityPolicy, **kw: Any
    ) -> "ReliableDispatcher":
        return cls(
            engine,
            retry=policy.retry,
            breaker=policy.breaker,
            degrade=policy.degrade,
            **kw,
        )

    # -- the degradation ladder -------------------------------------------

    @staticmethod
    def strategies(
        desc: CollectiveDescriptor, *, degrade: bool = True
    ) -> List[Tuple[str, Optional[CollectiveDescriptor]]]:
        """``(stage_label, descriptor)`` rungs, strongest first; the
        ``None`` descriptor marks the :func:`reference_collective` rung."""
        chain: List[Tuple[str, Optional[CollectiveDescriptor]]] = [
            (desc.backend or "default", desc)
        ]
        if degrade:
            if desc.backend:
                chain.append(
                    ("default", dataclasses.replace(desc, backend=""))
                )
            if desc.optimized or desc.chunks > 1:
                chain.append(
                    (
                        "raw",
                        dataclasses.replace(
                            desc, backend="", optimized=False, chunks=1
                        ),
                    )
                )
            chain.append(("reference", None))
        return chain

    def _note(self, kind: str, **fields: Any) -> None:
        obs_events.record(kind, **fields)
        obs_metrics.get_registry().counter(
            "repro_reliability_events_total",
            "reliable-dispatch retries/degrades/breaker skips",
            labelnames=("kind",),
        ).inc(kind=kind)

    def offload(
        self,
        descriptor: "CollectiveDescriptor | np.ndarray",
        x: Optional[PyTree] = None,
        axis_name: Any = None,
        mesh: Any = None,
        *,
        deadline: Optional[float] = None,
    ) -> PyTree:
        """Dispatch with the full reliability stack; see class docs.

        ``deadline`` is an absolute ``time.monotonic`` instant (the
        broker passes its tickets' ``deadline_at``); retries never sleep
        past it.
        """
        desc = self.engine._as_descriptor(descriptor)
        self.counts["dispatches"] += 1
        cached = self._chains.get(desc)
        if cached is None:
            cached = (
                desc.coll_type.name.lower(),
                self.strategies(desc, degrade=self.degrade),
            )
            if len(self._chains) < 256:
                self._chains[desc] = cached
        coll, chain = cached
        last_err: Optional[BaseException] = None
        for i, (label, d) in enumerate(chain):
            key = (label, coll)
            if self.breaker is not None and not self.breaker.allow(key):
                self.counts["breaker_skips"] += 1
                self._note(
                    "breaker_skip", backend=label, coll=coll,
                    stage=i, of=len(chain),
                )
                if i == len(chain) - 1:
                    raise CircuitOpenError(
                        f"no dispatch stage available for {coll}: circuit "
                        f"open through {label!r}"
                    ) from last_err
                continue

            if d is None:
                run = lambda: reference_collective(  # noqa: E731
                    desc, x,
                    device=self.engine.device if mesh is None else mesh.device,
                )
            else:
                run = lambda d=d: self.engine.offload(  # noqa: E731
                    d, x, axis_name, mesh
                )

            def attempt(run=run):
                if self.fault_injector is not None:
                    self.fault_injector.check_dispatch()
                return run()

            def on_retry(n: int, err: BaseException) -> None:
                self.counts["retries"] += 1
                self._note(
                    "retry", backend=label, coll=coll, attempt=n + 1,
                    error=type(err).__name__,
                )

            try:
                out = self.retry.run(
                    attempt,
                    deadline=deadline,
                    clock=self._clock,
                    sleep=self._sleep,
                    on_retry=on_retry,
                )
            except DEGRADABLE_ERRORS as err:
                if self.breaker is not None:
                    self.breaker.record_failure(key)
                last_err = err
                if i == len(chain) - 1:
                    raise
                self.counts["degrades"] += 1
                self._note(
                    "degrade",
                    coll=coll,
                    frm=label,
                    to=chain[i + 1][0],
                    error=type(err).__name__,
                )
                continue
            except Exception:
                # caller bugs and host failures are not transport faults:
                # no fallback may mask them, and they say nothing about
                # the backend's health, so the breaker ignores them
                raise
            if self.breaker is not None:
                self.breaker.record_success(key)
            if label == "reference":
                self.counts["reference_dispatches"] += 1
            return out
        raise CircuitOpenError(
            f"no dispatch stage available for {coll}"
        ) from last_err
