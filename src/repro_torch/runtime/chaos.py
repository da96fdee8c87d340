"""Message-level chaos injection for the sim backend's eager interpreter
(counterpart of ``repro.runtime.chaos``).

The paper's NetFPGA moves descriptors and partial sums over raw Ethernet
media-access frames — a medium that drops, duplicates, reorders, corrupts,
and delays packets. The stack's reliability layer
(``repro_torch.offload.reliability``, the broker's retry/bisection path)
claims to survive that; this module is the adversary that keeps the claim
honest.

:class:`ChaosInjector` perturbs *individual messages* — one (src, dst)
pair of one communication round — on the sim backend's eager/traced
interpreter path (``repro_torch.offload.planner.lower_sim(traced=True)``;
the engine routes planned sim dispatches through it whenever an injector
scope is active, under the same cache key the tracer uses). A dispatch whose
descriptor names the fused backend (K1) runs that interpreter too while a
scope is active: one kernel launch runs every message of a phase, so it
cannot fail one of them. Single-axis descriptors and driver mode run as
they do without a scope, as in the reference. Five
fault kinds, each with an independent seeded rate (a float or a
:class:`RateSchedule` over the injector's global message counter):

``drop``       the message never arrives. Unless ``silent``, the sender's
               delivery timeout surfaces as :class:`TransportError` — the
               software analogue of a NIC ACK/retransmit protocol
               declaring the link dead (PAPERS.md, cs/0402027). Silent
               drops deliver the permute's zero fill (exactly what a lost
               in-edge looks like).
``duplicate``  the message is delivered twice. Benign by construction:
               the sim permute's per-destination row *set* is idempotent,
               which is the receiver-side dedup contract.
``reorder``    messages within the round are delivered in reversed
               order. Benign: a round's destinations are unique, so
               delivery order cannot change the merged result.
``corrupt``    one bit of the payload row flips in flight. Unless
               ``silent``, the modeled receiver-side CRC rejects the
               message as :class:`~repro_torch.core.packet.IntegrityError`.
               Silent corruption actually flips the delivered bit — the
               demonstration of why the broker checksums payloads.
``delay``      ``delay_s`` seconds of extra latency (plus any per-link
               ``delays`` table entry — the delay table *is* the old
               ``repro_torch.obs.health.LinkDelayInjector`` contract, so a
               ChaosInjector drops into ``Tracer(link_injector=...)`` and
               every other place the delay-only injector was used).

Faults are deterministic: each message's decision derives from
``(seed, message_index, axis, src, dst)``, so a run either always passes
or always fails for a given seed and dispatch order — chaos tests are
reproducible, never flaky. A retry naturally advances the message
counter, so a retried dispatch draws fresh (usually clean) decisions:
that is what lets the CI gate demand *bitwise* recovery under sustained
fault rates.

Every injected fault is recorded in the flight recorder (``chaos_fault``
events) and counted in ``repro_chaos_faults_total{fault=...}``.

Scope: install with ``with injector.scope(): ...`` (or
:func:`set_injector` for manual control). The scope is process-global,
like the tracer — the broker's flush thread must see the injector the
test thread installed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.core.packet import IntegrityError
from repro_torch.core.trees import tree_map
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics

__all__ = [
    "ChaosBackend",
    "ChaosInjector",
    "RateSchedule",
    "TransportError",
    "active",
    "get_injector",
    "set_injector",
]

LinkKey = Tuple[int, int, int]  # (axis/level, src, dst)


class TransportError(RuntimeError):
    """A message was lost in flight (modeled NIC delivery timeout).

    Raised by :class:`ChaosBackend` for non-silent drops; the reliability
    layer treats it as retryable (a retransmit fixes a lost frame) and the
    recovery loop treats it as **non**-recoverable (losing a message is
    not losing a host — see ``repro_torch.runtime.fault.is_recoverable``).
    """


class RateSchedule:
    """A fault rate as a function of the injector's message counter.

    Plain floats are constant rates; schedules let a test script a fault
    *storm* (e.g. 100% drop for the first N messages, then clean) so
    breaker trip/recovery cycles are driven deterministically.
    """

    def __init__(self, fn: Callable[[int], float]):
        self._fn = fn

    def __call__(self, n: int) -> float:
        return float(self._fn(n))

    @classmethod
    def constant(cls, rate: float) -> "RateSchedule":
        r = float(rate)
        return cls(lambda _n: r)

    @classmethod
    def burst(cls, rate: float, until: int) -> "RateSchedule":
        """``rate`` for the first ``until`` messages, 0 afterwards."""
        r, u = float(rate), int(until)
        return cls(lambda n: r if n < u else 0.0)

    @classmethod
    def steps(cls, steps: List[Tuple[int, float]]) -> "RateSchedule":
        """Piecewise-constant: ``[(until_n, rate), ...]`` in order; a
        message index past every step gets rate 0."""
        table = [(int(u), float(r)) for u, r in steps]

        def fn(n: int) -> float:
            for until, rate in table:
                if n < until:
                    return rate
            return 0.0

        return cls(fn)


def _as_rate(r: "float | RateSchedule | Callable[[int], float]") -> RateSchedule:
    if isinstance(r, RateSchedule):
        return r
    if callable(r):
        return RateSchedule(r)
    return RateSchedule.constant(float(r))


@dataclasses.dataclass
class FaultDecision:
    """The seeded verdict for one message."""

    drop: bool = False
    duplicate: bool = False
    reorder: bool = False
    corrupt: bool = False
    corrupt_bit: int = 0
    delay_s: float = 0.0

    @property
    def any(self) -> bool:
        return (
            self.drop or self.duplicate or self.reorder or self.corrupt
            or self.delay_s > 0.0
        )


class ChaosInjector:
    """Deterministic seeded per-message fault source (see module doc).

    Rates accept floats or :class:`RateSchedule`; ``links`` optionally
    restricts faults to a set of (axis, src, dst) keys. ``delays`` is the
    per-link delay table absorbed from ``LinkDelayInjector`` (same
    ``delay``/``set_delay`` protocol), applied *on top of* the rate-based
    ``delay`` fault.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        drop: "float | RateSchedule" = 0.0,
        duplicate: "float | RateSchedule" = 0.0,
        reorder: "float | RateSchedule" = 0.0,
        corrupt: "float | RateSchedule" = 0.0,
        delay: "float | RateSchedule" = 0.0,
        delay_s: float = 0.001,
        delays: Optional[Dict[LinkKey, float]] = None,
        links: Optional[Any] = None,
        silent: bool = False,
        recorder: Optional[obs_events.FlightRecorder] = None,
    ):
        self.seed = int(seed)
        self.rates: Dict[str, RateSchedule] = {
            "drop": _as_rate(drop),
            "duplicate": _as_rate(duplicate),
            "reorder": _as_rate(reorder),
            "corrupt": _as_rate(corrupt),
            "delay": _as_rate(delay),
        }
        self.delay_fault_s = float(delay_s)
        self.delays: Dict[LinkKey, float] = {
            (int(a), int(s), int(d)): float(v)
            for (a, s, d), v in (delays or {}).items()
        }
        self.links = (
            None if links is None
            else {(int(a), int(s), int(d)) for a, s, d in links}
        )
        self.silent = bool(silent)
        self._recorder = recorder
        self._lock = threading.Lock()
        self.messages = 0
        self.counts: Dict[str, int] = {}

    # -- LinkDelayInjector protocol (absorbed) ----------------------------

    def set_delay(self, axis: int, src: int, dst: int, seconds: float) -> None:
        self.delays[(int(axis), int(src), int(dst))] = float(seconds)

    def delay(self, axis: int, src: int, dst: int) -> float:
        return self.delays.get((int(axis), int(src), int(dst)), 0.0)

    # -- decisions ---------------------------------------------------------

    @property
    def recorder(self) -> obs_events.FlightRecorder:
        if self._recorder is not None:
            return self._recorder
        return obs_events.get_recorder()

    def faults_injected(self) -> int:
        with self._lock:
            return sum(self.counts.values())

    def reset_counts(self) -> None:
        with self._lock:
            self.counts.clear()
            self.messages = 0

    def decide(self, axis: int, src: int, dst: int) -> FaultDecision:
        """The (deterministic) fault verdict for the next message on the
        given link; advances the global message counter."""
        key: LinkKey = (int(axis), int(src), int(dst))
        with self._lock:
            n = self.messages
            self.messages += 1
        if self.links is not None and key not in self.links:
            return FaultDecision()
        rng = np.random.default_rng((self.seed, n) + key)
        u = rng.random(5)
        dec = FaultDecision(
            drop=bool(u[0] < self.rates["drop"](n)),
            duplicate=bool(u[1] < self.rates["duplicate"](n)),
            reorder=bool(u[2] < self.rates["reorder"](n)),
            corrupt=bool(u[3] < self.rates["corrupt"](n)),
            corrupt_bit=int(rng.integers(0, 64)),
            delay_s=(
                self.delay_fault_s
                if u[4] < self.rates["delay"](n) else 0.0
            ),
        )
        if dec.any:
            self._note(dec, key, n)
        return dec

    def _note(self, dec: FaultDecision, key: LinkKey, n: int) -> None:
        counter = obs_metrics.get_registry().counter(
            "repro_chaos_faults_total",
            "chaos-injected message faults",
            labelnames=("fault",),
        )
        kinds = [
            k for k in ("drop", "duplicate", "reorder", "corrupt")
            if getattr(dec, k)
        ]
        if dec.delay_s > 0.0:
            kinds.append("delay")
        with self._lock:
            for k in kinds:
                self.counts[k] = self.counts.get(k, 0) + 1
        for k in kinds:
            counter.inc(fault=k)
            self.recorder.record(
                "chaos_fault",
                fault=k,
                axis=key[0],
                src=key[1],
                dst=key[2],
                msg=n,
                silent=self.silent,
            )

    # -- scope -------------------------------------------------------------

    @contextlib.contextmanager
    def scope(self) -> Iterator["ChaosInjector"]:
        """Install this injector process-globally for the block."""
        prev = set_injector(self)
        try:
            yield self
        finally:
            set_injector(prev)


_ACTIVE: Optional[ChaosInjector] = None


def set_injector(inj: Optional[ChaosInjector]) -> Optional[ChaosInjector]:
    """Install (or clear, with None) the global injector; returns the
    previous one so callers can restore it."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, inj
    return prev


def get_injector() -> Optional[ChaosInjector]:
    return _ACTIVE


def active() -> bool:
    """Whether a chaos scope is currently installed (the engine checks
    this to route planned sim dispatches onto the eager interpreter)."""
    return _ACTIVE is not None


# ---------------------------------------------------------------------------
# The lossy backend wrapper
# ---------------------------------------------------------------------------


_SIGNED = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}


def _bit_mask(bit: int, nbits: int) -> int:
    """``1 << bit`` as a signed ``nbits``-wide integer (negative for the
    sign bit), built through numpy's unsigned 64-bit view so bit 31 and bit
    63 wrap exactly instead of overflowing a signed dtype."""
    m = np.array([1 << bit], dtype=np.uint64).view(np.int64)
    return int(m.astype(f"int{nbits}")[0])


def _flip_row_bit(tree: Any, dst: int, bit: int) -> Any:
    """Flip one bit of every leaf's ``dst`` row (bit index taken modulo
    the leaf's element width) — the silent-corruption payload mutation.

    Each leaf is viewed as the signed integer type of its width (bf16 and
    fp16 through ``int16``) and XORed with the mask; the reference's
    ``bitcast_convert_type`` to an unsigned type flips the same bit."""

    def leaf(a):
        nbits = a.element_size() * 8
        out = a.clone()
        row = out[dst].view(_SIGNED[nbits])
        row.bitwise_xor_(_bit_mask(bit % nbits, nbits))
        return out

    return tree_map(leaf, tree)


class ChaosBackend:
    """Wrap a schedule :class:`~repro_torch.core.algorithms.Backend` with the
    injector's per-message faults.

    Sits directly over ``SimBackend`` in the eager interpreter (under any
    tracing/link-probe wrappers, so probed single-pair permutes still get
    per-message decisions). The pairs it hands on may repeat (duplicates)
    or come reversed; ``SimBackend.permute`` takes them as they come. A
    round raises at most once: the first non-silent drop wins (:class:`TransportError`), then the first
    non-silent corruption (:class:`IntegrityError`) — every message of
    the round still *draws* its decision first, so the seeded stream
    stays aligned across retries regardless of which fault fired.
    """

    def __init__(self, inner: Any, injector: ChaosInjector, *, level: int = 0):
        self.inner = inner
        self.injector = injector
        self.level = int(level)

    @property
    def p(self) -> int:
        return self.inner.p

    def rank(self):
        return self.inner.rank()

    def permute(self, tree: Any, perm: Any) -> Any:
        pairs = [(int(s), int(d)) for s, d in perm]
        if not pairs:
            return self.inner.permute(tree, perm)
        inj = self.injector
        decisions = [inj.decide(self.level, s, d) for s, d in pairs]
        total_delay = sum(f.delay_s for f in decisions) + sum(
            inj.delay(self.level, s, d) for s, d in pairs
        )
        if total_delay > 0.0:
            time.sleep(total_delay)
        if not inj.silent:
            for (s, d), f in zip(pairs, decisions):
                if f.drop:
                    raise TransportError(
                        f"chaos: message L{self.level} {s}->{d} dropped "
                        f"(delivery timeout; retransmit required)"
                    )
            for (s, d), f in zip(pairs, decisions):
                if f.corrupt:
                    raise IntegrityError(
                        f"chaos: message L{self.level} {s}->{d} failed "
                        f"receiver CRC (bit flip in flight)"
                    )
        kept = [
            p for p, f in zip(pairs, decisions) if not (f.drop and inj.silent)
        ]
        kept += [
            p
            for p, f in zip(pairs, decisions)
            if f.duplicate and not f.drop
        ]
        if any(f.reorder for f in decisions):
            kept = kept[::-1]
        out = self.inner.permute(tree, kept)
        if inj.silent:
            for (s, d), f in zip(pairs, decisions):
                if f.corrupt and not f.drop:
                    out = _flip_row_bit(out, d, f.corrupt_bit)
        return out
