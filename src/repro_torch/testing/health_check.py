"""Health-stack validation: link attribution, SLO alerting, flight recorder
(counterpart of ``repro.testing.health_check``).

    python -m repro_torch.testing.health_check [OUTER INNER] [--device cpu]

One run over an (OUTER, INNER) mesh shape (default (2, 2)) on the card, or
on the CPU with ``--device cpu``, exercises the whole
:mod:`repro_torch.obs.health` contract end to end:

  1. **Bitwise invariance** — the same planned SCAN dispatches three ways:
     sim baseline, **driver mode** on a co-resident (pod, data)
     :class:`repro_torch.compat.Mesh`, and sim under a link-probing tracer
     with a synthetic 10 ms delay planted on one link. All three results
     must be bitwise identical: neither the per-link probe decomposition
     nor the injected delay may change a single bit.
  2. **Attribution** — after warmup dispatches, a
     :class:`LinkStragglerDetector` watches the probed dispatches and must
     name *exactly* the planted link (axis, src, dst) — no false positives
     on its same-axis peers or on the other axis — and hand the report to
     an ``on_report`` callback (the remesh-consumer hook).
  3. **SLO breach** — a broker tenant submits with an impossible deadline;
     ingesting the service telemetry into a :class:`HealthMonitor` must
     fire a multi-window burn-rate alert for that tenant, flip
     ``healthz()`` to "alert", and count the miss in
     ``repro_service_deadline_misses_total``.
  4. **Flight recorder** — the ring must contain the ``deadline_miss``,
     ``straggler_link`` and ``slo_alert`` events the run produced, and
     :meth:`FlightRecorder.dump` must write valid, self-consistent JSON.

Emits a ``health_check_summary`` CSV row and a final ALL-OK; exits
nonzero on any violation.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from typing import List

import numpy as np
import torch

from repro_torch.compat import Mesh
from repro_torch.obs import events as obs_events
from repro_torch.obs import health as obs_health
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.offload import OffloadEngine
from repro_torch.service import DescriptorBroker

AXIS_NAMES = ("pod", "data")
N = 32  # payload columns

#: the link the injector slows — axis 1, because on a 2x2 mesh axis 0 has
#: a single link and peer-relative detection needs a same-axis baseline
SLOW_LINK = (1, 0, 1)
DELAY_S = 0.010

WARMUP_DISPATCHES = 2   # warm per-pair index caches before measuring
PROBED_DISPATCHES = 6   # enough for min_samples + report_after consecutive

FAILURES = 0


def check(name: str, ok: bool) -> None:
    global FAILURES
    print(f"health {name:44s} {'OK' if ok else 'FAIL'}")
    FAILURES += 0 if ok else 1


def main(argv: List[str]) -> int:
    global FAILURES
    FAILURES = 0
    parser = argparse.ArgumentParser(prog="repro_torch.testing.health_check")
    parser.add_argument("sizes", nargs="*", type=int, default=[2, 2])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    axes = tuple(args.sizes)
    if len(axes) != 2 or axes[1] < 2:
        print(f"health_check: need (outer, inner >= 2), got {axes}")
        return 2
    ndev = int(np.prod(axes))

    eng = OffloadEngine(device=args.device)
    desc = eng.make_descriptor(
        "scan", axes=axes, payload_bytes=N * 4, op="sum", optimize=True,
    )
    rng = np.random.default_rng(11)
    x = torch.from_numpy(
        rng.standard_normal((ndev, N)).astype(np.float32)
    ).to(eng.device)

    # ---- 1. bitwise invariance across sim / driver / probed dispatch -----
    baseline = eng.offload(desc, x)

    mesh = Mesh(axes, AXIS_NAMES, device=eng.device)
    driver = eng.offload(desc, x, axis_name=AXIS_NAMES, mesh=mesh)
    check("driver-mode result bitwise == sim", torch.equal(
        driver, baseline,
    ))

    # warm the per-pair index caches so the detector's first measured
    # samples are steady-state link latencies
    with obs_tracing.tracing(obs_tracing.Tracer(link_probe=True)):
        for _ in range(WARMUP_DISPATCHES):
            eng.offload(desc, x)

    detector = obs_health.LinkStragglerDetector(
        min_samples=2, report_after=3, threshold=2.0,
    )
    reported: list = []
    detector.on_report(reported.append)
    injector = obs_health.LinkDelayInjector({SLOW_LINK: DELAY_S})
    tracer = obs_tracing.Tracer(
        link_probe=True, link_injector=injector, link_detector=detector,
    )
    probed = None
    with obs_tracing.tracing(tracer):
        for _ in range(PROBED_DISPATCHES):
            probed = eng.offload(desc, x)
    check("probed+injected result bitwise == sim", torch.equal(
        probed, baseline,
    ))
    bitwise_ok = torch.equal(driver, baseline) and torch.equal(
        probed, baseline
    )

    # ---- 2. the planted link — and only it — is attributed ---------------
    spans = tracer.spans()
    link_spans = [s for s in spans if s.cat == "link"]
    round_ids = {s.span_id for s in spans if s.cat == "round"}
    check("link spans present", len(link_spans) > 0)
    check("link spans parented to round spans", all(
        s.parent_id in round_ids for s in link_spans
    ))

    top = detector.straggler()
    attribution_ok = (
        top is not None
        and (top["axis"], top["src"], top["dst"]) == SLOW_LINK
    )
    check("planted link named as straggler", attribution_ok)
    reports = detector.reports()
    check("no other link reported", len(reports) == 1)
    attribution_ok = attribution_ok and len(reports) == 1
    check("on_report callback fired", len(reported) == 1 and (
        (reported[0]["axis"], reported[0]["src"], reported[0]["dst"])
        == SLOW_LINK
    ))
    slow_rows = [
        r for r in detector.summary()
        if (r["axis"], r["src"], r["dst"]) == SLOW_LINK
    ]
    check("slow link EWMA reflects injected delay", bool(slow_rows) and (
        slow_rows[0]["ewma_us"] >= DELAY_S * 1e6 * 0.5
    ))

    # ---- 3. deadline-miss SLO burns -> alert -----------------------------
    monitor = obs_health.HealthMonitor(
        (
            obs_health.SLO(
                "deadline_miss",
                "tenant completions meeting their deadline",
                objective=0.99,
                fast_window_s=5.0,
                slow_window_s=30.0,
                min_events=1,
            ),
        ),
        link_detector=detector,
    )
    broker = DescriptorBroker(OffloadEngine(device=eng.device)).start()
    try:
        client = broker.client("hurried")
        for _ in range(3):
            # a deadline no dispatch can meet: every completion is a miss
            client.submit(desc, x, deadline_s=1e-6).result(timeout=60.0)
    finally:
        broker.stop()
    monitor.ingest(service=broker.telemetry)
    alerts = monitor.evaluate()
    alert_ok = any(
        a.slo == "deadline_miss" and a.key == "hurried" for a in alerts
    )
    check("deadline-miss burn-rate alert fires", alert_ok)
    hz = monitor.healthz()
    check("healthz reports alert status", hz["status"] == "alert")
    check("healthz names the straggler link", any(
        (s["axis"], s["src"], s["dst"]) == SLOW_LINK
        for s in hz["stragglers"]
    ))
    prom = obs_metrics.render_prometheus()
    check("prometheus: deadline-miss counter", (
        "repro_service_deadline_misses_total" in prom
    ))
    check("prometheus: link straggler counter", (
        "repro_link_straggler_reports_total" in prom
    ))

    # ---- 4. flight recorder saw it all and dumps valid JSON --------------
    rec = obs_events.get_recorder()
    counts = rec.counts()
    check("flight: deadline_miss events", counts.get("deadline_miss", 0) >= 3)
    check("flight: straggler_link event", counts.get("straggler_link", 0) >= 1)
    check("flight: slo_alert event", counts.get("slo_alert", 0) >= 1)

    dump_ok = False
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "flight.json"
        rec.dump(path, reason="health_check")
        try:
            data = json.loads(path.read_text())
            dump_ok = (
                isinstance(data, dict)
                and data.get("reason") == "health_check"
                and data.get("recorded", 0) >= len(data.get("events", []))
                and len(data.get("events", [])) > 0
                and all("kind" in e and "seq" in e for e in data["events"])
            )
        except (OSError, ValueError):
            dump_ok = False
    check("flight-recorder dump is valid JSON", dump_ok)

    top = top or {"axis": -1, "src": -1, "dst": -1}
    print(
        f"health_check_summary,bitwise_equal,{int(bitwise_ok)},"
        f"straggler_axis,{top['axis']},straggler_src,{top['src']},"
        f"straggler_dst,{top['dst']},attribution_ok,{int(attribution_ok)},"
        f"slo_alert,{int(alert_ok)},dump_valid,{int(dump_ok)},"
        f"link_spans,{len(link_spans)}"
    )
    if FAILURES:
        print(f"FAILURES: {FAILURES}")
        return 1
    print("ALL-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
