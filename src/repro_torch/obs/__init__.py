"""Unified observability (PyTorch port of ``repro.obs``): spans,
Chrome/Perfetto export, metrics registry, flight recorder.

* :mod:`repro_torch.obs.tracing` — in-process spans at the port's layer
  boundaries: engine dispatch (``engine.offload`` ⊃ ``engine.prepare``
  (⊃ ``engine.compile`` on a miss), ``engine.drain``, ``engine.schedule``,
  ``engine.wait``, ``engine.record``) -> K1's ``k1.stage`` / ``k1.launch``
  -> plan phase -> comm round, the model step (``step.train`` ⊃
  ``step.forward``, ``step.backward``, ``step.optimizer``;
  ``step.prefill``) and K3's ``k3.call``. Each span has three sinks: a
  process-wide ``(count, total ns)`` counter, always, except while a
  ``torch.profiler`` session records (0.3-0.75 µs a site on an H100
  machine's host, ``PERF.md``), published as
  ``repro_span_total`` / ``repro_span_seconds_total``; a
  ``record_function`` range while a profiler records, on the profiler's
  clock; and the collecting tracer that
  :func:`~repro_torch.obs.tracing.install_tracer` (or the
  :func:`~repro_torch.obs.tracing.tracing` context manager) installs,
  with parent links. Only the collecting tracer changes what runs (the
  traced lowering).
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
    span_totals,
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
    "span_totals",
    "spans_to_chrome",
    "start_http_server",
    "write_trace",
]
