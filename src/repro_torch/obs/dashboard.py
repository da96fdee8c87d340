"""Operator dashboard: text rendering + a stdlib HTTP scrape endpoint
(counterpart of ``repro.obs.dashboard``).

The last mile of the observability stack: everything the flight
recorder, metrics registry, health monitor, and telemetry snapshots
already know, in two operator-consumable forms —

* :func:`render_dashboard` — a fixed-width text panel (engine cache and
  latency, per-tenant service table, SLO burn rates, straggler links,
  the tail of the flight recorder).
* :func:`start_http_server` — a ``http.server`` daemon thread serving

  ============  ==========================================================
  endpoint      payload
  ============  ==========================================================
  ``/healthz``  :meth:`HealthMonitor.healthz` JSON; HTTP 200 when ``ok``,
                503 while any SLO alert or straggler report is active
  ``/metrics``  Prometheus text exposition (the existing
                :func:`repro_torch.obs.metrics.render_prometheus`)
  ``/events``   flight-recorder ring as JSON (``?kind=`` filter,
                ``?limit=`` newest-N)
  ``/``         the text dashboard
  ============  ==========================================================

Stdlib only (``http.server`` + ``threading``): no new dependencies, and
binding port 0 lets tests grab an ephemeral port.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics

__all__ = [
    "DashboardServer",
    "render_dashboard",
    "start_http_server",
]


def _rule(title: str, width: int) -> str:
    pad = max(0, width - len(title) - 4)
    return f"-- {title} " + "-" * pad


def _table(rows: List[List[str]], header: List[str]) -> List[str]:
    cols = [header] + rows
    widths = [max(len(str(r[i])) for r in cols) for i in range(len(header))]
    out = ["  ".join(str(h).ljust(w) for h, w in zip(header, widths))]
    for r in rows:
        out.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    return out


def render_dashboard(
    *,
    engine: Any = None,
    broker: Any = None,
    monitor: Any = None,
    recorder: Optional[obs_events.FlightRecorder] = None,
    events_tail: int = 12,
    width: int = 76,
) -> str:
    """One text panel over whatever subset of the stack is wired in.

    ``engine``/``broker`` are the live objects (their ``telemetry``
    attributes are snapshotted); every argument is optional and a
    missing one just drops its section.
    """
    # `is None` check, not `or`: an *empty* FlightRecorder is falsy
    if recorder is None:
        recorder = obs_events.get_recorder()
    lines: List[str] = ["=" * width, "offload stack dashboard".center(width),
                        "=" * width]
    if engine is not None:
        t = engine.telemetry.snapshot()
        lines.append(_rule("engine", width))
        lines.append(
            f"dispatches {t['dispatches']}  cache {t['hits']}h/"
            f"{t['misses']}m (hit rate {t['hit_rate']:.2f})  "
            f"size {t['cache_size']}  compiles {t['compiles']}  "
            f"errors {t['errors']}"
        )
        lines.append(
            f"backend fallbacks {t['backend_fallbacks']}  "
            f"profiler fallbacks {t['profiler_fallbacks']}"
        )
        if t["latency_by_coll_us"]:
            rows = [
                [coll, f"{us:.0f}",
                 f"{t['device_latency_by_coll_us'].get(coll, 0.0):.0f}",
                 t["latency_source_by_coll"].get(coll, "-")]
                for coll, us in sorted(t["latency_by_coll_us"].items())
            ]
            lines += _table(rows, ["coll", "wall_us", "device_us", "source"])
    if broker is not None:
        t = broker.telemetry.snapshot()
        lines.append(_rule("service", width))
        lines.append(
            f"flushes {t['flushes']} (deadline {t['deadline_flushes']})  "
            f"coalesce {t['coalesce_factor']:.2f} "
            f"({t['fused_requests']} req / {t['fused_dispatches']} disp)"
        )
        rows = [
            [name, ts["submitted"], ts["completed"], ts["rejected"],
             ts["errors"], ts["deadline_missed"],
             f"{ts['latency']['p50_us']:.0f}",
             f"{ts['latency']['p99_us']:.0f}"]
            for name, ts in sorted(t["tenants"].items())
        ]
        if rows:
            lines += _table(
                rows,
                ["tenant", "sub", "done", "rej", "err", "miss",
                 "p50_us", "p99_us"],
            )
    if monitor is not None:
        hz = monitor.healthz()
        lines.append(_rule(f"health: {hz['status'].upper()}", width))
        for a in hz["alerts"]:
            lines.append(
                f"ALERT {a['slo']}[{a['key']}] burn "
                f"fast={a['burn_fast']:.1f}x slow={a['burn_slow']:.1f}x"
            )
        for s in hz["stragglers"]:
            lines.append(
                f"STRAGGLER link axis={s['axis']} {s['src']}->{s['dst']} "
                f"ewma {s['ewma_us']:.0f}us vs peers {s['peer_us']:.0f}us"
            )
        if not hz["alerts"] and not hz["stragglers"]:
            lines.append(f"all {len(hz['slos'])} SLOs within budget")
    lines.append(_rule("flight recorder", width))
    counts = recorder.counts()
    lines.append(
        f"{len(recorder)}/{recorder.capacity} events retained; totals: "
        + (", ".join(f"{k}={v}" for k, v in sorted(counts.items())) or "none")
    )
    for e in recorder.events(limit=events_tail):
        extras = {
            k: v for k, v in e.items()
            if k not in ("seq", "t", "ts_us", "kind")
        }
        body = " ".join(f"{k}={v}" for k, v in extras.items())
        lines.append(f"  [{e['seq']:>6}] {e['kind']:<18} {body}"[:width])
    lines.append("=" * width)
    return "\n".join(lines)


class DashboardServer:
    """A running scrape endpoint; ``close()`` (or context-exit) stops it."""

    def __init__(self, server: ThreadingHTTPServer, thread: threading.Thread):
        self.server = server
        self.thread = thread

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    @property
    def url(self) -> str:
        host = self.server.server_address[0]
        return f"http://{host}:{self.port}"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5.0)

    def __enter__(self) -> "DashboardServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def start_http_server(
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    engine: Any = None,
    broker: Any = None,
    monitor: Any = None,
    recorder: Optional[obs_events.FlightRecorder] = None,
    registry: Optional[obs_metrics.MetricsRegistry] = None,
) -> DashboardServer:
    """Serve ``/healthz`` + ``/metrics`` + ``/events`` + the dashboard on a
    daemon thread. ``port=0`` binds an ephemeral port (see ``.url``)."""

    # `is None` check, not `or`: an *empty* FlightRecorder is falsy
    rec = recorder if recorder is not None else obs_events.get_recorder()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a: Any) -> None:  # keep test output clean
            return None

        def _send(
            self, body: str, status: int = 200,
            ctype: str = "application/json",
        ) -> None:
            data = body.encode()
            self.send_response(status)
            self.send_header("Content-Type", f"{ctype}; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self) -> None:  # noqa: N802 - http.server contract
            parsed = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(parsed.query)
            try:
                if parsed.path == "/healthz":
                    hz: Dict[str, Any] = (
                        monitor.healthz() if monitor is not None
                        else {"status": "ok", "alerts": [], "stragglers": []}
                    )
                    self._send(
                        json.dumps(hz, default=str),
                        status=200 if hz["status"] == "ok" else 503,
                    )
                elif parsed.path == "/metrics":
                    self._send(
                        obs_metrics.render_prometheus(
                            registry or obs_metrics.get_registry()
                        ),
                        ctype="text/plain",
                    )
                elif parsed.path == "/events":
                    kind = q.get("kind", [None])[0]
                    limit = q.get("limit", [None])[0]
                    self._send(
                        json.dumps(
                            {
                                "counts": rec.counts(),
                                "events": rec.events(
                                    kind=kind,
                                    limit=int(limit) if limit else None,
                                ),
                            },
                            default=str,
                        )
                    )
                elif parsed.path in ("/", "/dashboard"):
                    self._send(
                        render_dashboard(
                            engine=engine, broker=broker, monitor=monitor,
                            recorder=rec,
                        ),
                        ctype="text/plain",
                    )
                else:
                    self._send(json.dumps({"error": "not found"}), status=404)
            except Exception as e:  # surface handler bugs to the scraper
                self._send(json.dumps({"error": str(e)}), status=500)

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    thread = threading.Thread(
        target=server.serve_forever, name="repro-dashboard", daemon=True
    )
    thread.start()
    return DashboardServer(server, thread)
