"""Common metrics registry: counters, gauges, histograms, Prometheus text
(the port's copy of ``repro.obs.metrics``, standard library only).

:class:`~repro_torch.offload.engine.EngineTelemetry` keeps its snapshot dict
untouched; this module gives it (and the tracing layer) a *shared* registry
to ALSO publish into, so one scrape shows the whole stack. Metric names
follow the Prometheus conventions (``repro_<subsystem>_<thing>_<unit>``)
and are the reference's, so one dashboard reads either package.

Key series:

  * ``repro_engine_dispatches_total{coll=...}`` / ``..._cache_hits_total``
    / ``..._compiles_total`` — the engine's NIC status registers;
  * ``repro_engine_profiler_fallbacks_total{reason=...}`` — every time a
    profiled dispatch degraded to the wall-clock source (alerting on
    profiler degradation instead of quietly trusting wall numbers);
  * ``repro_service_requests_total{tenant=..., outcome=...}`` and
    ``repro_service_request_latency_us{tenant=...}`` — the broker's
    per-tenant view;
  * ``repro_round_latency_us{coll=..., phase_kind=..., round_bucket=...}``
    — the per-round host-constant attribution from traced sim dispatches:
    round indices bucket as 0,1,2,3,"4-7","8-15",... so the label set
    stays bounded while still separating early rounds (where the fused
    schedule's extra payload lives) from the tail;
  * ``repro_span_total{span=...}`` / ``repro_span_seconds_total{span=...}``
    — :mod:`repro_torch.obs.tracing`'s span totals outside profiler
    sessions, kept there and read at every scrape of the process registry
    (:func:`add_process_series`).

Everything is thread-safe (one lock per registry) and dependency-free.
:func:`render_prometheus` emits the text exposition format
(``# HELP`` / ``# TYPE`` + samples), suitable for a file-based scrape or a
trivial HTTP handler.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CallbackCounter",
    "CallbackGauge",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ROUND_LATENCY_BUCKETS_US",
    "add_process_series",
    "get_registry",
    "render_prometheus",
    "reset_registry",
    "round_bucket",
    "set_registry",
]

#: default histogram bucket upper bounds (microseconds; +Inf is implicit)
ROUND_LATENCY_BUCKETS_US: Tuple[float, ...] = (
    5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1e3, 2.5e3, 5e3, 1e4,
    5e4, 1e5,
)

LabelValues = Tuple[str, ...]


def round_bucket(index: int) -> str:
    """Bucket a round index for the ``round_bucket`` label: rounds 0-3 are
    individually labeled, then power-of-two ranges ("4-7", "8-15", ...)."""
    index = int(index)
    if index < 4:
        return str(index)
    lo = 1 << index.bit_length() - 1
    return f"{lo}-{2 * lo - 1}"


def _escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _fmt_labels(names: Sequence[str], values: LabelValues) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Metric:
    """Shared labeled-series plumbing."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, Any]) -> LabelValues:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)


class Counter(_Metric):
    """Monotonically increasing per-label-set total."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelValues, float] = {}

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        self._add(self._key(labels), amount)

    def _add(self, key: LabelValues, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def child(self, **labels: Any) -> Callable[..., None]:
        """``inc`` of one label set, its labels checked here once: the
        returned function takes the amount alone (default 1)."""
        return functools.partial(self._add, self._key(labels))

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def collect(self) -> Dict[LabelValues, float]:
        with self._lock:
            return dict(self._values)

    def render(self) -> List[str]:
        lines = []
        for key, v in sorted(self.collect().items()):
            lines.append(
                f"{self.name}{_fmt_labels(self.labelnames, key)} {_num(v)}"
            )
        return lines


class CallbackCounter(_Metric):
    """A counter whose totals are kept elsewhere and read at every scrape:
    ``fn() -> {label values: total}``."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=(), *, fn: Callable[[], Dict]):
        super().__init__(name, help, labelnames)
        self._fn = fn

    def collect(self) -> Dict[LabelValues, float]:
        return {tuple(map(str, k)): float(v) for k, v in self._fn().items()}

    render = Counter.render


class Gauge(_Metric):
    """Set-to-current-value metric."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelValues, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def collect(self) -> Dict[LabelValues, float]:
        with self._lock:
            return dict(self._values)

    def render(self) -> List[str]:
        return [
            f"{self.name}{_fmt_labels(self.labelnames, key)} {_num(v)}"
            for key, v in sorted(self.collect().items())
        ]


class CallbackGauge(_Metric):
    """A gauge whose value is kept elsewhere and read at every scrape:
    ``fn() -> {label values: value}`` (a value the hot path cannot read
    without waiting, such as a number still on the card)."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=(), *, fn: Callable[[], Dict]):
        super().__init__(name, help, labelnames)
        self._fn = fn

    collect = CallbackCounter.collect
    render = Gauge.render


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: ``le`` buckets
    are cumulative, ``+Inf`` == count)."""

    kind = "histogram"

    def __init__(
        self,
        name,
        help="",
        labelnames=(),
        buckets: Sequence[float] = ROUND_LATENCY_BUCKETS_US,
    ):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self._counts: Dict[LabelValues, List[int]] = {}
        self._sums: Dict[LabelValues, float] = {}

    def observe(self, value: float, **labels: Any) -> None:
        self._observe(self._key(labels), value)

    def child(self, **labels: Any) -> Callable[[float], None]:
        """``observe`` of one label set, its labels checked here once."""
        return functools.partial(self._observe, self._key(labels))

    def _observe(self, key: LabelValues, value: float) -> None:
        value = float(value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def collect(self) -> Dict[LabelValues, Dict[str, Any]]:
        with self._lock:
            out = {}
            for key, counts in self._counts.items():
                out[key] = {
                    "buckets": list(counts),
                    "sum": self._sums.get(key, 0.0),
                    "count": sum(counts),
                }
            return out

    def render(self) -> List[str]:
        lines = []
        for key, data in sorted(self.collect().items()):
            cum = 0
            for i, edge in enumerate(self.buckets):
                cum += data["buckets"][i]
                labels = dict(zip(self.labelnames, key))
                labels["le"] = _num(edge)
                names = tuple(self.labelnames) + ("le",)
                values = key + (_num(edge),)
                lines.append(
                    f"{self.name}_bucket{_fmt_labels(names, values)} {cum}"
                )
            names = tuple(self.labelnames) + ("le",)
            values = key + ("+Inf",)
            lines.append(
                f"{self.name}_bucket{_fmt_labels(names, values)} "
                f"{data['count']}"
            )
            lines.append(
                f"{self.name}_sum{_fmt_labels(self.labelnames, key)} "
                f"{_num(data['sum'])}"
            )
            lines.append(
                f"{self.name}_count{_fmt_labels(self.labelnames, key)} "
                f"{data['count']}"
            )
        return lines


def _num(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class MetricsRegistry:
    """Name -> metric map with get-or-create constructors.

    Re-registering the same name must agree on kind and label names (a
    mismatch raises — two subsystems silently sharing one series under
    different schemas is how dashboards lie).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or tuple(
                    existing.labelnames
                ) != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames}; requested "
                        f"{cls.kind}{tuple(labelnames)}"
                    )
                return existing
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name, help="", labelnames=(),
        buckets: Sequence[float] = ROUND_LATENCY_BUCKETS_US,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def callback_counter(
        self, name, help, labelnames, fn: Callable[[], Dict],
    ) -> CallbackCounter:
        return self._get_or_create(
            CallbackCounter, name, help, labelnames, fn=fn
        )

    def callback_gauge(
        self, name, help, labelnames, fn: Callable[[], Dict],
    ) -> CallbackGauge:
        return self._get_or_create(
            CallbackGauge, name, help, labelnames, fn=fn
        )

    def metrics(self) -> Dict[str, _Metric]:
        with self._lock:
            return dict(self._metrics)

    def collect(self) -> Dict[str, Any]:
        """Structured snapshot of every registered series."""
        return {
            name: {
                "kind": m.kind,
                "help": m.help,
                "labelnames": list(m.labelnames),
                "series": {
                    ",".join(k) if k else "": v
                    for k, v in m.collect().items()
                },
            }
            for name, m in sorted(self.metrics().items())
        }

    def render(self) -> str:
        """Prometheus text exposition format."""
        out: List[str] = []
        for name, m in sorted(self.metrics().items()):
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {m.kind}")
            out.extend(m.render())
        return "\n".join(out) + ("\n" if out else "")


_default = MetricsRegistry()
_default_lock = threading.Lock()
#: ``fn(registry)`` calls that add the process-wide series kept outside any
#: registry (``obs.tracing``'s span totals) to the process registry
_process_series: List[Callable[[MetricsRegistry], None]] = []


def add_process_series(fn: Callable[[MetricsRegistry], None]) -> None:
    """Have ``fn`` add its series to the process registry now and to every
    registry :func:`set_registry` installs later."""
    _process_series.append(fn)
    fn(_default)


def get_registry() -> MetricsRegistry:
    """The process-wide default registry everything publishes into."""
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the default registry; returns the previous one."""
    global _default
    with _default_lock:
        prev = _default
        _default = registry
    for fn in _process_series:
        fn(registry)
    return prev


def reset_registry() -> MetricsRegistry:
    """Install a fresh empty default registry (tests)."""
    return set_registry(MetricsRegistry()) and _default


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Text exposition of ``registry`` (default: the process registry)."""
    return (get_registry() if registry is None else registry).render()


# -- canonical series helpers ------------------------------------------------


def observe_round(
    coll: str, phase_kind: str, round_index: int, dur_us: float,
    registry: Optional[MetricsRegistry] = None,
) -> None:
    """Record one traced communication round into the shared
    per-(coll, phase_kind, round-bucket) latency histogram."""
    reg = get_registry() if registry is None else registry
    reg.histogram(
        "repro_round_latency_us",
        "host-side latency of one traced communication round",
        labelnames=("coll", "phase_kind", "round_bucket"),
    ).observe(
        dur_us,
        coll=coll,
        phase_kind=phase_kind,
        round_bucket=round_bucket(round_index),
    )


def observe_phase(
    coll: str, phase_kind: str, dur_us: float,
    registry: Optional[MetricsRegistry] = None,
) -> None:
    """Record one traced plan phase's host-side latency."""
    reg = get_registry() if registry is None else registry
    reg.histogram(
        "repro_phase_latency_us",
        "host-side latency of one traced plan phase",
        labelnames=("coll", "phase_kind"),
    ).observe(dur_us, coll=coll, phase_kind=phase_kind)
