"""SLO health monitoring and per-link straggler attribution (counterpart of
``repro.obs.health``).

Two halves of "is the offload stack healthy?":

**SLOs.** :class:`SLO` declares an objective over a good/bad event ratio
(per-tenant latency under a target, deadline misses, schedule-cache
hits, lowering-backend fallbacks). :class:`HealthMonitor` ingests the
existing cumulative telemetry
(:class:`~repro_torch.service.telemetry.ServiceTelemetry`,
:class:`~repro_torch.offload.engine.EngineTelemetry`),
converts counter snapshots to increments, and evaluates each SLO over
two sliding windows with **multi-window burn-rate alerting** (the SRE
playbook shape): burn rate is ``error_rate / error_budget`` and an
alert fires only when *both* the fast and the slow window burn faster
than ``burn_threshold`` — the fast window gives detection latency, the
slow window stops a single bad flush from paging. Alerts land in the
flight recorder (``slo_alert``), in Prometheus
(``repro_slo_alerts_total`` / ``repro_slo_burn_rate``), and in
:meth:`HealthMonitor.healthz` (the ``/healthz`` endpoint's payload).

**Per-link attribution.** ``runtime/straggler.py`` flags slow *steps* —
useful, but a remesh decision wants to know *which link* is slow.
:class:`LinkProbeBackend` decomposes each traced sim round's permute
into its individual (src, dst) messages — bitwise-identical merge, one
``link``-category span each — and :class:`LinkStragglerDetector` keeps
a per-(axis, src, dst) latency EWMA, compares each link against the
median of its same-axis peers (peer-relative, so a globally slow host
doesn't flag every link), and after ``report_after`` consecutive flags
names the slow link as a health event that remesh consumers
(``fault.notify_remesh`` listeners) can act on.
:class:`LinkDelayInjector` adds a synthetic per-link delay (sleep only
— values never change) so CI can prove the attribution finds the link
it planted (``repro_torch.testing.health_check``).
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import statistics
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.core.trees import tree_map
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing

__all__ = [
    "SLO",
    "Alert",
    "HealthMonitor",
    "LinkDelayInjector",
    "LinkProbeBackend",
    "LinkStragglerDetector",
    "default_slos",
]

LinkKey = Tuple[int, int, int]  # (axis/level, src, dst)


# ---------------------------------------------------------------------------
# SLO definitions + burn-rate evaluation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective over a good/bad event ratio.

    ``objective`` is the target good fraction (0.99 -> 1% error budget).
    Evaluation is multi-window: an alert fires when the burn rate
    (window error rate / error budget) is at least ``burn_threshold`` on
    *both* the ``fast_window_s`` and ``slow_window_s`` windows, and each
    window saw at least ``min_events`` events (no data is not an alert).
    """

    name: str
    description: str = ""
    objective: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    burn_threshold: float = 1.0
    min_events: int = 1

    def __post_init__(self) -> None:
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: objective must be in (0, 1), "
                f"got {self.objective}"
            )
        if self.fast_window_s > self.slow_window_s:
            raise ValueError(
                f"SLO {self.name!r}: fast window ({self.fast_window_s}s) "
                f"wider than slow window ({self.slow_window_s}s)"
            )

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective


@dataclasses.dataclass(frozen=True)
class Alert:
    """One firing SLO breach (both windows over the burn threshold)."""

    slo: str
    key: str  # e.g. tenant name; "" for global SLOs
    burn_fast: float
    burn_slow: float
    error_rate_fast: float
    error_rate_slow: float
    t: float

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


#: default latency target for the per-tenant latency SLO (microseconds)
DEFAULT_LATENCY_TARGET_US = 1e6


def default_slos() -> Tuple[SLO, ...]:
    """The stack's stock SLOs; pass your own tuple to tune any of them."""
    return (
        SLO(
            "tenant_latency",
            "fraction of tenant requests completing under the latency "
            "target (per-tenant; bucket-resolution good counts)",
            objective=0.99,
        ),
        SLO(
            "deadline_miss",
            "fraction of tenant completions that met their deadline "
            "(per-tenant)",
            objective=0.99,
        ),
        SLO(
            "cache_hit",
            "engine schedule-cache hit fraction",
            objective=0.50,
        ),
        SLO(
            "backend_fallback",
            "fraction of engine dispatches not hitting a lowering-backend "
            "fallback",
            objective=0.95,
        ),
    )


class HealthMonitor:
    """Sliding-window SLO evaluation over cumulative telemetry counters.

    Feed it either raw increments (:meth:`observe`) or whole telemetry
    objects/snapshots (:meth:`ingest`, which diffs against the previous
    ingest so cumulative counters become per-window increments). Then
    :meth:`evaluate` returns the currently-firing :class:`Alert` list;
    rising edges are recorded into the flight recorder and counted in
    ``repro_slo_alerts_total``. ``clock`` is injectable for tests.
    """

    #: retained (t, good, bad) entries per series — prune guard, not policy
    MAX_SERIES_LEN = 4096

    def __init__(
        self,
        slos: Optional[Tuple[SLO, ...]] = None,
        *,
        latency_target_us: float = DEFAULT_LATENCY_TARGET_US,
        link_detector: Optional["LinkStragglerDetector"] = None,
        breaker: Optional[Any] = None,
        recorder: Optional[obs_events.FlightRecorder] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._lock = threading.Lock()
        self._slos: Dict[str, SLO] = {
            s.name: s for s in (default_slos() if slos is None else slos)
        }
        self.latency_target_us = float(latency_target_us)
        self.link_detector = link_detector
        # a reliability CircuitBreaker (anything with .snapshot()); its
        # per-(backend, coll) state rides /healthz and an open circuit
        # flips overall status to "alert"
        self.breaker = breaker
        self._recorder = recorder
        self._clock = clock
        # (slo, key) -> deque[(t, good, bad)]
        self._series: Dict[Tuple[str, str], Deque[Tuple[float, float, float]]]
        self._series = {}
        # cumulative-counter memory for snapshot diffing
        self._last: Dict[Tuple[str, ...], float] = {}
        self._active: set = set()  # (slo, key) currently firing

    # -- configuration -----------------------------------------------------

    def add_slo(self, slo: SLO) -> None:
        with self._lock:
            self._slos[slo.name] = slo

    def slos(self) -> Tuple[SLO, ...]:
        with self._lock:
            return tuple(self._slos.values())

    @property
    def recorder(self) -> obs_events.FlightRecorder:
        # `is not None`, not `or`: an *empty* FlightRecorder is falsy
        if self._recorder is not None:
            return self._recorder
        return obs_events.get_recorder()

    # -- feeding -----------------------------------------------------------

    def observe(
        self,
        slo: str,
        *,
        key: str = "",
        good: float = 0.0,
        bad: float = 0.0,
        t: Optional[float] = None,
    ) -> None:
        """Add ``good``/``bad`` event increments to one SLO series."""
        if slo not in self._slos:
            raise KeyError(f"unknown SLO {slo!r}; add_slo() it first")
        if good <= 0.0 and bad <= 0.0:
            return
        t = self._clock() if t is None else t
        with self._lock:
            series = self._series.get((slo, key))
            if series is None:
                series = self._series[(slo, key)] = collections.deque(
                    maxlen=self.MAX_SERIES_LEN
                )
            series.append((t, max(0.0, good), max(0.0, bad)))

    def _delta(self, key: Tuple[str, ...], value: float) -> float:
        """Increment of a cumulative counter since the previous ingest.
        A counter going backwards (telemetry reset) re-bases at zero."""
        prev = self._last.get(key, 0.0)
        self._last[key] = value
        return value - prev if value >= prev else value

    @staticmethod
    def _snap(obj: Any) -> Dict[str, Any]:
        return obj.snapshot() if hasattr(obj, "snapshot") else dict(obj or {})

    def ingest(
        self,
        *,
        service: Any = None,
        engine: Any = None,
        t: Optional[float] = None,
    ) -> None:
        """Diff one round of telemetry into the SLO series.

        ``service``/``engine`` accept the live telemetry objects or their
        ``snapshot()`` dicts. The per-tenant latency SLO needs bucket
        counts, so it is only fed when ``service`` is a live
        :class:`ServiceTelemetry` (snapshots carry percentiles, not
        buckets); everything else works from either form.
        """
        t = self._clock() if t is None else t
        if service is not None:
            tenants = getattr(service, "tenants", None)
            snap = self._snap(service)
            for name, ts in (snap.get("tenants") or {}).items():
                done = self._delta(
                    ("svc", name, "done"),
                    float(ts.get("completed", 0) + ts.get("errors", 0)),
                )
                missed = self._delta(
                    ("svc", name, "missed"), float(ts.get("deadline_missed", 0))
                )
                if "deadline_miss" in self._slos:
                    self.observe(
                        "deadline_miss", key=name, t=t,
                        good=max(0.0, done - missed), bad=missed,
                    )
                if "tenant_latency" in self._slos and tenants is not None:
                    stats = tenants.get(name)
                    if stats is not None:
                        fast = self._delta(
                            ("svc", name, "lat_good"),
                            float(stats.latency.count_at_or_below(
                                self.latency_target_us
                            )),
                        )
                        total = self._delta(
                            ("svc", name, "lat_total"),
                            float(stats.latency.count),
                        )
                        self.observe(
                            "tenant_latency", key=name, t=t,
                            good=fast, bad=max(0.0, total - fast),
                        )
        if engine is not None:
            snap = self._snap(engine)
            hits = self._delta(("eng", "hits"), float(snap.get("hits", 0)))
            misses = self._delta(
                ("eng", "misses"), float(snap.get("misses", 0))
            )
            if "cache_hit" in self._slos:
                self.observe("cache_hit", t=t, good=hits, bad=misses)
            falls = self._delta(
                ("eng", "bfall"), float(snap.get("backend_fallbacks", 0))
            )
            disp = self._delta(
                ("eng", "disp"), float(snap.get("dispatches", 0))
            )
            if "backend_fallback" in self._slos:
                self.observe(
                    "backend_fallback", t=t,
                    good=max(0.0, disp - falls), bad=falls,
                )

    # -- evaluation --------------------------------------------------------

    def _window(
        self,
        series: List[Tuple[float, float, float]],
        window_s: float,
        now: float,
    ) -> Tuple[float, float]:
        cutoff = now - window_s
        good = bad = 0.0
        for t, g, b in reversed(series):
            if t < cutoff:
                break
            good += g
            bad += b
        return good, bad

    def evaluate(self, t: Optional[float] = None) -> List[Alert]:
        """The currently-firing alerts; publishes burn-rate gauges and
        records rising edges (flight recorder + alert counter)."""
        now = self._clock() if t is None else t
        reg = obs_metrics.get_registry()
        burn_gauge = reg.gauge(
            "repro_slo_burn_rate",
            "SLO burn rate (window error rate / error budget)",
            labelnames=("slo", "key", "window"),
        )
        alerts: List[Alert] = []
        firing: set = set()
        with self._lock:
            items = [
                (slo_key, self._slos[slo_key[0]], list(series))
                for slo_key, series in self._series.items()
                if slo_key[0] in self._slos
            ]
        for (slo_name, key), slo, series in items:
            gf, bf = self._window(series, slo.fast_window_s, now)
            gs, bs = self._window(series, slo.slow_window_s, now)
            tf, tsl = gf + bf, gs + bs
            if tf < slo.min_events or tsl < slo.min_events:
                continue
            erf = bf / tf if tf else 0.0
            ers = bs / tsl if tsl else 0.0
            burn_f = erf / slo.error_budget
            burn_s = ers / slo.error_budget
            burn_gauge.set(burn_f, slo=slo_name, key=key, window="fast")
            burn_gauge.set(burn_s, slo=slo_name, key=key, window="slow")
            if burn_f >= slo.burn_threshold and burn_s >= slo.burn_threshold:
                firing.add((slo_name, key))
                alerts.append(
                    Alert(
                        slo=slo_name, key=key,
                        burn_fast=burn_f, burn_slow=burn_s,
                        error_rate_fast=erf, error_rate_slow=ers, t=now,
                    )
                )
        with self._lock:
            new = firing - self._active
            self._active = firing
        for alert in alerts:
            if (alert.slo, alert.key) in new:
                self.recorder.record(
                    "slo_alert",
                    slo=alert.slo,
                    key=alert.key,
                    burn_fast=round(alert.burn_fast, 3),
                    burn_slow=round(alert.burn_slow, 3),
                )
                reg.counter(
                    "repro_slo_alerts_total",
                    "SLO burn-rate alerts (rising edges)",
                    labelnames=("slo", "key"),
                ).inc(slo=alert.slo, key=alert.key)
        return alerts

    def healthz(self, t: Optional[float] = None) -> Dict[str, Any]:
        """The ``/healthz`` payload: alerts, stragglers, breaker states.

        Any non-closed circuit breaker (open *or* half-open — a probing
        backend is not healthy yet) flips the status to "alert"."""
        alerts = self.evaluate(t)
        stragglers = (
            self.link_detector.reports() if self.link_detector else []
        )
        breakers = self.breaker.snapshot() if self.breaker else {}
        tripped = [
            k for k, v in breakers.items() if v.get("state") != "closed"
        ]
        return {
            "status": (
                "alert" if (alerts or stragglers or tripped) else "ok"
            ),
            "alerts": [a.as_dict() for a in alerts],
            "stragglers": stragglers,
            "breakers": breakers,
            "slos": [s.name for s in self.slos()],
        }


# ---------------------------------------------------------------------------
# Per-link straggler attribution
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _LinkStats:
    ewma_us: float = 0.0
    samples: int = 0
    consecutive: int = 0
    flags: int = 0


class LinkStragglerDetector:
    """Per-(axis, src, dst) latency EWMA with peer-relative flagging.

    Each observed link keeps its own EWMA of message latency (always
    updated — a slow link must *stay* visibly slow, unlike the step
    detector where a spike would poison its own baseline). A link is
    flagged when its EWMA exceeds ``threshold`` x the median EWMA of the
    *other* links on the same axis (peer-relative: a globally slow round
    moves every link and flags none). ``report_after`` consecutive flags
    promote the link to a report: recorded as a ``straggler_link``
    flight event, counted in ``repro_link_straggler_reports_total``, and
    handed to any :meth:`on_report` callbacks — the hook remesh
    consumers use.
    """

    def __init__(
        self,
        *,
        alpha: float = 0.25,
        threshold: float = 2.0,
        min_samples: int = 3,
        report_after: int = 3,
        recorder: Optional[obs_events.FlightRecorder] = None,
    ):
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.report_after = int(report_after)
        self._recorder = recorder
        self._lock = threading.Lock()
        self._links: Dict[LinkKey, _LinkStats] = {}
        self._reports: Dict[LinkKey, Dict[str, Any]] = {}
        self._callbacks: List[Callable[[Dict[str, Any]], None]] = []

    @property
    def recorder(self) -> obs_events.FlightRecorder:
        # `is not None`, not `or`: an *empty* FlightRecorder is falsy
        if self._recorder is not None:
            return self._recorder
        return obs_events.get_recorder()

    def on_report(self, cb: Callable[[Dict[str, Any]], None]) -> None:
        """Register a callback for newly-reported straggler links."""
        self._callbacks.append(cb)

    def observe(
        self, axis: int, src: int, dst: int, dur_us: float
    ) -> Dict[str, Any]:
        """Feed one link-message latency; returns {flagged, report,
        ewma_us, peer_us} (the step detector's dict-contract shape)."""
        key: LinkKey = (int(axis), int(src), int(dst))
        with self._lock:
            st = self._links.get(key)
            if st is None:
                st = self._links[key] = _LinkStats()
            st.samples += 1
            st.ewma_us = (
                dur_us if st.samples == 1
                else (1 - self.alpha) * st.ewma_us + self.alpha * dur_us
            )
            peers = [
                o.ewma_us
                for k, o in self._links.items()
                if k[0] == key[0] and k != key and o.samples >= self.min_samples
            ]
            peer_us = statistics.median(peers) if peers else 0.0
            flagged = (
                st.samples >= self.min_samples
                and peer_us > 0.0
                and st.ewma_us > self.threshold * peer_us
            )
            if flagged:
                st.consecutive += 1
                st.flags += 1
            else:
                st.consecutive = 0
            new_report = flagged and st.consecutive == self.report_after
            report = flagged and st.consecutive >= self.report_after
            if report:
                self._reports[key] = {
                    "axis": key[0], "src": key[1], "dst": key[2],
                    "ewma_us": st.ewma_us, "peer_us": peer_us,
                    "consecutive": st.consecutive, "samples": st.samples,
                }
            rep = self._reports.get(key)
        if new_report and rep is not None:
            self.recorder.record("straggler_link", **rep)
            obs_metrics.get_registry().counter(
                "repro_link_straggler_reports_total",
                "per-link straggler reports (rising edges)",
                labelnames=("axis", "src", "dst"),
            ).inc(axis=str(key[0]), src=str(key[1]), dst=str(key[2]))
            for cb in self._callbacks:
                cb(dict(rep))
        return {
            "flagged": flagged,
            "report": report,
            "ewma_us": st.ewma_us,
            "peer_us": peer_us,
        }

    def observe_spans(self, spans: Any) -> int:
        """Feed every ``link``-category span (as emitted by
        :class:`LinkProbeBackend`); returns how many were consumed."""
        n = 0
        for s in spans:
            if getattr(s, "cat", None) != "link":
                continue
            a = s.args
            self.observe(a["axis"], a["src"], a["dst"], s.dur_us)
            n += 1
        return n

    def reports(self) -> List[Dict[str, Any]]:
        """All links ever promoted to a straggler report (worst first)."""
        with self._lock:
            reps = [dict(r) for r in self._reports.values()]
        reps.sort(key=lambda r: r["ewma_us"] / max(r["peer_us"], 1e-9),
                  reverse=True)
        return reps

    def straggler(self) -> Optional[Dict[str, Any]]:
        """The worst reported link, or None."""
        reps = self.reports()
        return reps[0] if reps else None

    def summary(self) -> List[Dict[str, Any]]:
        """Per-link EWMA table (sorted by axis then ewma, slowest first)."""
        with self._lock:
            rows = [
                {
                    "axis": k[0], "src": k[1], "dst": k[2],
                    "ewma_us": st.ewma_us, "samples": st.samples,
                    "consecutive": st.consecutive, "flags": st.flags,
                }
                for k, st in self._links.items()
            ]
        rows.sort(key=lambda r: (r["axis"], -r["ewma_us"]))
        return rows


class LinkDelayInjector:
    """Synthetic per-link delay table for fault-injection tests.

    ``delays`` maps (axis, src, dst) -> seconds added inside that link's
    probe span, which :class:`LinkProbeBackend` spends repeating the
    link's own fault-free exchange (the reference sleeps; see there). The
    delay changes *timing only* — the permuted values are untouched,
    which is what lets the health check assert bitwise-identical results
    with the injector active.

    The general fault mechanism is
    ``repro_torch.runtime.chaos.ChaosInjector``,
    which implements this exact ``delays``/``set_delay``/``delay``
    protocol (so it drops into ``Tracer(link_injector=...)`` unchanged)
    and adds seeded drop/duplicate/reorder/corrupt faults with rate
    schedules. This class stays as the dependency-free delay-only table
    (obs must not import the runtime package).
    """

    def __init__(self, delays: Optional[Dict[LinkKey, float]] = None):
        self.delays: Dict[LinkKey, float] = {
            (int(a), int(s), int(d)): float(v)
            for (a, s, d), v in (delays or {}).items()
        }

    def set_delay(self, axis: int, src: int, dst: int, seconds: float) -> None:
        self.delays[(int(axis), int(src), int(dst))] = float(seconds)

    def delay(self, axis: int, src: int, dst: int) -> float:
        return self.delays.get((int(axis), int(src), int(dst)), 0.0)


#: exchanges a link probe times for each message; the message's cost is
#: the least of them
TIMED_EXCHANGES = 3


class LinkProbeBackend:
    """Decompose each sim round's permute into per-link probed messages.

    Sits *under* :class:`~repro_torch.obs.tracing.TracingBackend` in the traced
    sim interpreter (round span parent, link spans children). The full
    permute ``[(s0,d0),(s1,d1),...]`` becomes one single-pair permute per
    message, each timed in a ``link``-category span carrying
    ``(axis, src, dst, round)``, then merged exactly: destination row
    ``d`` is *set* (not accumulated) from the pair result that carries
    it, which reproduces the vectorized permute bit-for-bit (same zero
    fill, same row writes — sign of zero included). Per-pair timing is
    what makes (axis, src, dst) attribution possible at all: the
    vectorized round is one device op covering every same-distance link
    simultaneously. Each message's span waits for its device work
    (``torch.cuda.synchronize`` on a card), so its duration is the
    message's whole cost.

    Probing costs one dispatch per message instead of one per round, so
    it is opt-in via ``Tracer(link_probe=True)`` — a diagnosis mode, not
    the default traced path. ``injector`` adds synthetic delay;
    ``detector`` gets a live ``observe`` per message.

    A message here is far cheaper than one of the reference's eager JAX
    interpreter, so host effects that the reference's messages absorb can
    reach the detector's 2x threshold. Three of them are kept out of the
    timings:

    * the cyclic garbage collector is held off for the round, as
      ``timeit`` does, and runs after it (``gc.isenabled()`` restored);
    * a delayed link spends its delay repeating its own exchange on
      ``plain`` — the level's fault-free backend, so no chaos decision is
      drawn; by default ``inner`` — where the reference sleeps. A host
      that has idled for 10 ms returns cold: its next operations run
      several times slower, and that warm-up would land on the *next*
      message and double it;
    * on a fault-free level (``inner`` is ``plain``) a message's cost is
      the least time of :data:`TIMED_EXCHANGES` exchanges of the pair, as
      ``timeit`` takes the least of its repeats: a preempted thread or a
      cold cache inflates one exchange, not all of them. Under chaos
      ``inner`` draws a fault decision per exchange (a delay among them),
      so its one exchange is timed alone. The detector reads that cost
      plus the time the planted delay held the link.
    """

    def __init__(
        self,
        inner: Any,
        tracer: Any,
        *,
        level: int = 0,
        injector: Optional[LinkDelayInjector] = None,
        detector: Optional[LinkStragglerDetector] = None,
        plain: Any = None,
    ):
        self.inner = inner
        self.plain = inner if plain is None else plain
        self.tracer = tracer
        self.level = int(level)
        self.injector = injector
        self.detector = detector
        self.rounds = 0

    @property
    def p(self) -> int:
        return self.inner.p

    def rank(self):
        return self.inner.rank()

    def permute(self, tree: Any, perm: Any) -> Any:
        pairs = [(int(s), int(d)) for s, d in perm]
        rnd = self.rounds
        self.rounds += 1
        if not pairs:
            return self.inner.permute(tree, perm)
        out = None
        collecting = gc.isenabled()
        gc.disable()
        try:
            for src, dst in pairs:
                delay_s = (
                    self.injector.delay(self.level, src, dst)
                    if self.injector is not None else 0.0
                )
                held_us = 0.0
                with self.tracer.span(
                    f"plan.link:L{self.level}:{src}->{dst}",
                    "link",
                    axis=self.level,
                    src=src,
                    dst=dst,
                    round=rnd,
                ):
                    if delay_s > 0.0:
                        held_us = self._hold(tree, src, dst, delay_s)
                    part, cost_us = self._exchange(tree, src, dst)
                dur_us = held_us + cost_us
                if self.detector is not None:
                    self.detector.observe(self.level, src, dst, dur_us)
                if out is None:
                    out = part
                else:
                    out = tree_map(lambda o, q, _d=dst: _set_row(o, q, _d),
                                   out, part)
        finally:
            if collecting:
                gc.enable()
        return out

    def _exchange(self, tree: Any, src: int, dst: int) -> Tuple[Any, float]:
        """One message: the result of ``inner``'s exchange of the pair, and
        its cost in µs; on a fault-free level the least of
        :data:`TIMED_EXCHANGES` timed exchanges."""
        t0 = obs_tracing.now_us()
        part = obs_tracing._block(self.inner.permute(tree, [(src, dst)]))
        cost_us = obs_tracing.now_us() - t0
        repeats = TIMED_EXCHANGES - 1 if self.inner is self.plain else 0
        for _ in range(repeats):
            t0 = obs_tracing.now_us()
            obs_tracing._block(self.plain.permute(tree, [(src, dst)]))
            cost_us = min(cost_us, obs_tracing.now_us() - t0)
        return part, cost_us

    def _hold(self, tree: Any, src: int, dst: int, seconds: float) -> float:
        """Spend ``seconds`` on this link's own fault-free exchange; returns
        the µs it held the link."""
        t0 = obs_tracing.now_us()
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            obs_tracing._block(self.plain.permute(tree, [(src, dst)]))
        return obs_tracing.now_us() - t0


def _set_row(out: torch.Tensor, src: torch.Tensor, row: int) -> torch.Tensor:
    """``out`` with row ``row`` *set* from ``src`` (a new tensor)."""
    out = out.clone()
    out[row] = src[row]
    return out
