"""Unified observability (PyTorch port of ``repro.obs``): spans,
Chrome/Perfetto export, metrics registry, flight recorder.

* :mod:`repro_torch.obs.tracing` — in-process spans with parent links
  covering engine dispatch -> plan phase -> comm round; a no-op tracer is
  installed by default so the instrumented hot paths are zero-cost until
  :func:`~repro_torch.obs.tracing.install_tracer` (or the
  :func:`~repro_torch.obs.tracing.tracing` context manager) enables
  collection.
* :mod:`repro_torch.obs.export` — spans -> Chrome trace JSON
  (Perfetto-openable) and the host+device merge with ``torch.profiler``
  traces.
* :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry with
  Prometheus text exposition; the engine's telemetry publishes here in
  addition to its snapshot dict.
* :mod:`repro_torch.obs.events` — the always-on bounded flight recorder of
  structured events (dispatch, cache miss, fallbacks), dumpable to JSON.
* :mod:`repro_torch.obs.health` — declarative SLOs with multi-window
  burn-rate alerting over the engine/service telemetry, plus per-link
  straggler attribution (link-probe mode of the traced sim lowering).
* :mod:`repro_torch.obs.dashboard` — text dashboard + stdlib HTTP endpoint
  (``/healthz``, ``/metrics``, ``/events``).
"""

from repro_torch.obs.dashboard import render_dashboard, start_http_server
from repro_torch.obs.events import (
    FlightRecorder,
    auto_dump,
    get_recorder,
    record,
    set_recorder,
)
from repro_torch.obs.export import (
    chrome_to_spans,
    load_chrome_trace,
    merge_device_trace,
    spans_to_chrome,
    write_trace,
)
from repro_torch.obs.health import (
    SLO,
    HealthMonitor,
    LinkDelayInjector,
    LinkProbeBackend,
    LinkStragglerDetector,
    default_slos,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    render_prometheus,
    reset_registry,
    round_bucket,
    set_registry,
)
# NB: the submodules are the package attributes ``tracing`` / ``metrics`` /
# ``export``; the tracing() context manager is deliberately NOT re-exported
# here (it would shadow the submodule) — use
# ``repro_torch.obs.tracing.tracing``.
from repro_torch.obs.tracing import (
    NoopTracer,
    Span,
    Tracer,
    TracingBackend,
    get_tracer,
    install_tracer,
    now_us,
    set_tracer,
)

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "HealthMonitor",
    "Histogram",
    "LinkDelayInjector",
    "LinkProbeBackend",
    "LinkStragglerDetector",
    "MetricsRegistry",
    "NoopTracer",
    "SLO",
    "Span",
    "Tracer",
    "TracingBackend",
    "auto_dump",
    "chrome_to_spans",
    "default_slos",
    "get_recorder",
    "get_registry",
    "get_tracer",
    "install_tracer",
    "load_chrome_trace",
    "merge_device_trace",
    "now_us",
    "record",
    "render_dashboard",
    "render_prometheus",
    "reset_registry",
    "round_bucket",
    "set_recorder",
    "set_registry",
    "set_tracer",
    "spans_to_chrome",
    "start_http_server",
    "write_trace",
]
