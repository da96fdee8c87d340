"""Per-tenant service telemetry, layered on the engine's counters
(counterpart of ``repro.service.telemetry``).

The broker is the NIC's request FIFO made multi-tenant: every client stream
gets its own submitted/completed/rejected/deadline-missed counters, a queue
depth gauge, and a log-bucketed latency histogram (submit-to-result wall
clock, the host-visible latency the paper's Fig. 4/5 measures), while the
coalescing stats (fused dispatches vs. fused requests) quantify how much
network-level combining the broker achieves — the software twin of the
NetFPGA combining packets from many host ranks in one pipeline pass.
:class:`ServiceTelemetry` snapshots all of it alongside the wrapped
:class:`~repro_torch.offload.engine.EngineTelemetry` so one dict shows the whole
stack: tenant queues -> broker coalescing -> engine schedule cache.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

from repro_torch.obs import metrics as obs_metrics

#: histogram bucket upper edges in microseconds (last bucket is open-ended)
LATENCY_BUCKETS_US = (
    50.0, 100.0, 250.0, 500.0, 1e3, 2.5e3, 5e3, 1e4, 2.5e4, 5e4, 1e5,
    2.5e5, 5e5, 1e6, 5e6,
)


@dataclasses.dataclass
class LatencyHistogram:
    """Log-bucketed latency histogram with count/sum/min/max (microseconds).

    Thread-safe on its own: ``record`` and the readers take the instance
    lock, so a histogram shared across tenant threads (or read by a
    snapshot mid-record) never shows torn count/sum/bucket state —
    ``ServiceTelemetry``'s outer lock is then a consistency guarantee
    across *tenants*, not the histogram's only defense.
    """

    counts: List[int] = dataclasses.field(
        default_factory=lambda: [0] * (len(LATENCY_BUCKETS_US) + 1)
    )
    count: int = 0
    total_us: float = 0.0
    max_us: float = 0.0
    min_us: float = 0.0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def record(self, seconds: float) -> None:
        us = seconds * 1e6
        with self._lock:
            self.count += 1
            self.total_us += us
            self.max_us = max(self.max_us, us)
            self.min_us = us if self.count == 1 else min(self.min_us, us)
            for i, edge in enumerate(LATENCY_BUCKETS_US):
                if us <= edge:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    @property
    def mean_us(self) -> float:
        with self._lock:
            return self.total_us / self.count if self.count else 0.0

    def percentile_us(self, q: float) -> float:
        """Bucket-resolution percentile, clamped to the observed range.

        ``q`` is a quantile in [0, 1]. An empty histogram reports 0.0;
        ``q=0`` reports the observed minimum; ``q=1`` the observed maximum.
        In between, the answer is the upper edge of the bucket holding the
        q-quantile sample, clamped into ``[min_us, max_us]`` — so a single
        10 µs sample reports 10 at every quantile instead of the 50 µs
        bucket edge, and no percentile ever exceeds the recorded max (or
        undercuts the recorded min).
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} not in [0, 1]")
        with self._lock:
            if self.count == 0:
                return 0.0
            if q <= 0.0:
                return self.min_us
            rank = q * self.count
            seen = 0
            for i, c in enumerate(self.counts):
                seen += c
                if seen >= rank and c:
                    if i < len(LATENCY_BUCKETS_US):
                        return min(
                            max(LATENCY_BUCKETS_US[i], self.min_us),
                            self.max_us,
                        )
                    return self.max_us
            return self.max_us

    def count_at_or_below(self, threshold_us: float) -> int:
        """Samples that landed in buckets whose upper edge is within
        ``threshold_us`` — the "good event" count for a latency SLO.
        Bucket-resolution: a threshold between edges counts only the
        buckets entirely under it (conservative; never overcounts)."""
        with self._lock:
            n = 0
            for i, edge in enumerate(LATENCY_BUCKETS_US):
                if edge <= threshold_us:
                    n += self.counts[i]
            return n

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean_us": self.mean_us,
            "p50_us": self.percentile_us(0.50),
            "p99_us": self.percentile_us(0.99),
            "max_us": self.max_us,
            "min_us": self.min_us,
        }


@dataclasses.dataclass
class TenantStats:
    """One client stream's counters (the per-host NIC doorbell registers)."""

    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    errors: int = 0
    deadline_missed: int = 0
    queue_depth: int = 0
    max_queue_depth: int = 0
    latency: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram
    )

    def snapshot(self) -> Dict[str, Any]:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "errors": self.errors,
            "deadline_missed": self.deadline_missed,
            "queue_depth": self.queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "latency": self.latency.snapshot(),
        }


class ServiceTelemetry:
    """Broker-wide counters + per-tenant stats, thread-safe.

    ``coalesce_factor`` is requests-per-engine-dispatch over everything the
    broker has flushed — the service's headline number: > 1 means concurrent
    tenants are genuinely sharing compiled collective dispatches.
    """

    def __init__(self, engine_telemetry: Any = None):
        self._lock = threading.Lock()
        self._engine_telemetry = engine_telemetry
        self.tenants: Dict[str, TenantStats] = {}
        self.fused_dispatches = 0
        self.fused_requests = 0
        self.flushes = 0
        self.deadline_flushes = 0

    def tenant(self, name: str) -> TenantStats:
        with self._lock:
            stats = self.tenants.get(name)
            if stats is None:
                stats = self.tenants[name] = TenantStats()
            return stats

    # -- recording (all called with the broker holding its own lock or from
    #    the single dispatch thread; the internal lock guards snapshots) ----

    @staticmethod
    def _requests_counter() -> "obs_metrics.Counter":
        return obs_metrics.get_registry().counter(
            "repro_service_requests_total",
            "service requests by tenant and outcome",
            labelnames=("tenant", "outcome"),
        )

    def record_submit(self, tenant: str) -> None:
        with self._lock:
            t = self.tenants.setdefault(tenant, TenantStats())
            t.submitted += 1
            t.queue_depth += 1
            t.max_queue_depth = max(t.max_queue_depth, t.queue_depth)
        self._requests_counter().inc(tenant=tenant, outcome="submitted")

    def record_reject(self, tenant: str) -> None:
        with self._lock:
            self.tenants.setdefault(tenant, TenantStats()).rejected += 1
        self._requests_counter().inc(tenant=tenant, outcome="rejected")

    def record_complete(
        self,
        tenant: str,
        latency_s: float,
        *,
        error: bool = False,
        deadline_missed: bool = False,
    ) -> None:
        with self._lock:
            t = self.tenants.setdefault(tenant, TenantStats())
            t.queue_depth = max(0, t.queue_depth - 1)
            if error:
                t.errors += 1
            else:
                t.completed += 1
                t.latency.record(latency_s)
            if deadline_missed:
                t.deadline_missed += 1
        self._requests_counter().inc(
            tenant=tenant, outcome="error" if error else "completed"
        )
        if deadline_missed:
            obs_metrics.get_registry().counter(
                "repro_service_deadline_misses_total",
                "requests completing after their deadline, by tenant",
                labelnames=("tenant",),
            ).inc(tenant=tenant)
        if not error:
            obs_metrics.get_registry().histogram(
                "repro_service_request_latency_us",
                "submit-to-result wall-clock latency per tenant",
                labelnames=("tenant",),
                buckets=LATENCY_BUCKETS_US,
            ).observe(latency_s * 1e6, tenant=tenant)

    def record_flush(
        self, n_requests: int, n_dispatches: int, *, deadline: bool = False
    ) -> None:
        with self._lock:
            self.flushes += 1
            self.fused_requests += n_requests
            self.fused_dispatches += n_dispatches
            if deadline:
                self.deadline_flushes += 1
        obs_metrics.get_registry().counter(
            "repro_service_flushes_total",
            "broker flush dispatches",
            labelnames=("deadline",),
        ).inc(deadline=str(bool(deadline)).lower())

    # -- reading -----------------------------------------------------------

    @property
    def coalesce_factor(self) -> float:
        with self._lock:
            if not self.fused_dispatches:
                return 0.0
            return self.fused_requests / self.fused_dispatches

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            snap: Dict[str, Any] = {
                "tenants": {
                    name: t.snapshot() for name, t in self.tenants.items()
                },
                "fused_requests": self.fused_requests,
                "fused_dispatches": self.fused_dispatches,
                "coalesce_factor": (
                    self.fused_requests / self.fused_dispatches
                    if self.fused_dispatches
                    else 0.0
                ),
                "flushes": self.flushes,
                "deadline_flushes": self.deadline_flushes,
            }
        if self._engine_telemetry is not None:
            snap["engine"] = self._engine_telemetry.snapshot()
        return snap


__all__ = [
    "LATENCY_BUCKETS_US",
    "LatencyHistogram",
    "ServiceTelemetry",
    "TenantStats",
]
