"""``repro_torch.obs.health`` and ``repro_torch.obs.dashboard`` against
``repro.obs.health`` / ``repro.obs.dashboard``.

* The same observations into both packages' ``HealthMonitor`` (an injected
  clock, SLO windows, telemetry-snapshot ingestion with counter resets, a
  circuit breaker) give the same alerts and the same ``healthz()``; the
  same link latencies into both ``LinkStragglerDetector``s give the same
  verdicts, reports and summary.
* ``LinkProbeBackend`` over the sim backend is bitwise invisible; a traced
  dispatch with ``Tracer(link_probe=True)`` emits the reference's link
  spans (names and arguments, parented to round spans); a planted delay
  is reported on its link and on no other (on a clock that advances a
  fixed step a reading) and tops the detector on the host's clock; under
  a chaos scope the probe sits over the lossy backend.
* ``render_dashboard`` gives the reference's text for the same monitor and
  recorder, and names the engine and broker sections; the HTTP endpoints
  (``/healthz``, ``/metrics``, ``/events``, ``/dashboard``) serve on
  ``127.0.0.1`` port 0.
* ``python -m repro_torch.testing.health_check --device cpu`` prints
  ALL-OK.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.obs import dashboard as jdashboard
from repro.obs import events as jevents
from repro.obs import health as jhealth
from repro.obs import metrics as jmetrics
from repro.obs import tracing as jtracing
from repro.offload import OffloadEngine as JEngine
from repro.offload import reliability as jrel
from repro_torch.core import algorithms as talg
from repro_torch.obs import dashboard as tdashboard
from repro_torch.obs import events as tevents
from repro_torch.obs import health as thealth
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import tracing as ttracing
from repro_torch.offload import OffloadEngine as TEngine
from repro_torch.offload import reliability as trel
from repro_torch.runtime import chaos as tchaos
from repro_torch.service import DescriptorBroker

AXES = (2, 4)
P, N = 8, 16


@pytest.fixture(autouse=True)
def _clean_obs():
    for ev, met, tr in ((jevents, jmetrics, jtracing),
                        (tevents, tmetrics, ttracing)):
        ev.set_recorder(None)
        ev.set_auto_dump_path(None)
        met.reset_registry()
        tr.set_tracer(None)
    yield
    for ev, met, tr in ((jevents, jmetrics, jtracing),
                        (tevents, tmetrics, ttracing)):
        ev.set_recorder(None)
        ev.set_auto_dump_path(None)
        met.reset_registry()
        tr.set_tracer(None)


def _monitor_script(health, rel):
    now = {"t": 1000.0}
    br = rel.CircuitBreaker(failure_threshold=1, clock=lambda: now["t"])
    det = health.LinkStragglerDetector(min_samples=2, report_after=2)
    slos = health.default_slos() + (
        health.SLO("deadline_miss", objective=0.9, fast_window_s=10.0,
                   slow_window_s=60.0),
    )
    mon = health.HealthMonitor(slos, clock=lambda: now["t"],
                               link_detector=det, breaker=br)
    out = [mon.healthz()]
    for i in range(40):
        mon.observe("deadline_miss", key="a", good=3.0, t=950.0 + i)
    mon.observe("deadline_miss", key="a", bad=4.0, t=999.0)
    mon.observe("deadline_miss", key="b", bad=1.0, t=999.5)
    out.append([a.as_dict() for a in mon.evaluate()])
    mon.ingest(engine={"hits": 3, "misses": 9, "dispatches": 12,
                       "backend_fallbacks": 2})
    mon.ingest(engine={"hits": 1, "misses": 9, "dispatches": 14,
                       "backend_fallbacks": 2})  # a reset re-bases
    mon.ingest(service={"tenants": {"a": {"completed": 5, "errors": 1,
                                          "deadline_missed": 3}}})
    for k in range(6):
        for link, us in (((0, 0, 1), 10.0), ((0, 1, 2), 11.0),
                         ((0, 2, 3), 60.0), ((1, 0, 1), 10.0)):
            out.append(det.observe(*link, us + k))
    br.record_failure(("pallas", "scan"))
    now["t"] = 1005.0
    out.append(mon.healthz())
    out.append(det.summary())
    return out


def test_health_monitor_and_detector_match():
    assert _monitor_script(thealth, trel) == _monitor_script(jhealth, jrel)


def test_link_probe_backend_is_bitwise_invisible():
    x = torch.arange(8 * 3, dtype=torch.int32).reshape(8, 3)
    tracer = ttracing.Tracer()
    inner = talg.SimBackend(8, "cpu")
    probe = thealth.LinkProbeBackend(inner, tracer, level=1)
    for perm in ([(i, i + 2) for i in range(6)], [(i, i ^ 1) for i in
                                                  range(8)], [(7, 0)]):
        assert torch.equal(probe.permute((x, -x), perm)[1],
                           inner.permute((x, -x), perm)[1])
    links = [s for s in tracer.spans() if s.cat == "link"]
    assert len(links) == 6 + 8 + 1 and probe.rounds == 3
    assert links[0].name == "plan.link:L1:0->2"


def _probed(eng_cls, tracing, to_x, **eng_kw):
    eng = eng_cls(**eng_kw)
    desc = eng.make_descriptor("scan", axes=AXES, payload_bytes=N * 4,
                               op="sum", optimize=True)
    x = to_x(np.random.default_rng(0).integers(-5, 6, (P, N))
             .astype(np.float32))
    baseline = eng.offload(desc, x)
    tracer = tracing.Tracer(link_probe=True)
    with tracing.tracing(tracer):
        probed = eng.offload(desc, x)
    spans = tracer.spans()
    rounds = {s.span_id for s in spans if s.cat == "round"}
    links = [(s.name, dict(s.args)) for s in spans if s.cat == "link"]
    assert all(s.parent_id in rounds for s in spans if s.cat == "link")
    return np.asarray(baseline), np.asarray(probed), links


def test_traced_link_probe_matches_the_reference():
    import jax.numpy as jnp

    tb, tp, tlinks = _probed(TEngine, ttracing, torch.from_numpy,
                             device="cpu")
    jb, jp, jlinks = _probed(JEngine, jtracing, jnp.asarray)
    np.testing.assert_array_equal(tp, tb)
    np.testing.assert_array_equal(tp, jp)
    assert tlinks == jlinks and tlinks


def _planted_delay_run(slow, delay_s):
    eng = TEngine(device="cpu")
    desc = eng.make_descriptor("scan", axes=AXES, payload_bytes=N * 4,
                               op="sum", optimize=True)
    x = torch.ones((P, N))
    with ttracing.tracing(ttracing.Tracer(link_probe=True)):
        for _ in range(2):  # warm the per-pair index caches first
            eng.offload(desc, x)
    det = thealth.LinkStragglerDetector(min_samples=2, report_after=3)
    inj = thealth.LinkDelayInjector({slow: delay_s})
    tracer = ttracing.Tracer(link_probe=True, link_injector=inj,
                             link_detector=det)
    with ttracing.tracing(tracer):
        for _ in range(6):
            assert torch.equal(eng.offload(desc, x), torch.cumsum(x, 0))
    durations = {}
    for s in tracer.spans():
        if s.cat == "link":
            a = dict(s.args)
            durations.setdefault((a["axis"], a["src"], a["dst"]),
                                 set()).add(s.dur_us)
    return det, durations


def test_planted_delay_is_attributed_to_its_link_only(monkeypatch):
    """On a clock that advances one fixed step a reading, every message
    but the slowed one takes the same time, so the probe, the injector and
    the detector alone decide who is reported: the slowed link, and no
    other. (On the host's clock, host noise as large as a 16-column
    message now and then flags another link: ROADMAP queue 3.)"""
    import time

    clock = {"t": 0.0}

    def perf_counter():
        clock["t"] += 1e-5
        return clock["t"]

    monkeypatch.setattr(time, "perf_counter", perf_counter)
    slow = (1, 1, 2)
    det, durations = _planted_delay_run(slow, 0.01)
    others = set().union(*(d for k, d in durations.items() if k != slow))
    assert max(others) - min(others) < 1e-6  # one step a message
    assert min(durations[slow]) >= 1e4
    assert [(r["axis"], r["src"], r["dst"]) for r in det.reports()] == [slow]
    top = det.straggler()
    assert (top["axis"], top["src"], top["dst"]) == slow


def test_planted_delay_tops_the_detector_on_the_host_clock():
    slow = (1, 1, 2)
    det, _ = _planted_delay_run(slow, 0.01)
    top = det.straggler()
    assert top is not None and (top["axis"], top["src"], top["dst"]) == slow
    assert slow in [(r["axis"], r["src"], r["dst"]) for r in det.reports()]
    row = {(r["axis"], r["src"], r["dst"]): r for r in det.summary()}[slow]
    assert row["ewma_us"] >= 5e3


def test_link_probe_sits_over_the_lossy_backend():
    eng = TEngine(device="cpu")
    desc = eng.make_descriptor("scan", axes=AXES, payload_bytes=N * 4,
                               op="sum", optimize=True)
    x = torch.ones((P, N))
    want = eng.offload(desc, x)
    inj = tchaos.ChaosInjector(5, drop=0.03)
    tracer = ttracing.Tracer(link_probe=True)
    outcomes = []
    with inj.scope(), ttracing.tracing(tracer):
        for _ in range(8):
            try:
                outcomes.append(torch.equal(eng.offload(desc, x), want))
            except tchaos.TransportError:
                outcomes.append("drop")
    assert "drop" in outcomes and True in outcomes
    links = sum(1 for s in tracer.spans() if s.cat == "link")
    assert inj.messages == links  # every probed message drew a decision


def test_dashboard_text_matches_for_the_same_monitor_and_recorder():
    def render(health, events, dashboard):
        rec = events.FlightRecorder(capacity=8)
        for i in range(5):
            rec.record("dispatch", coll="scan", cache="hit", i=i)
        mon = health.HealthMonitor(clock=lambda: 50.0)
        mon.observe("cache_hit", bad=4.0, t=49.0)
        text = dashboard.render_dashboard(monitor=mon, recorder=rec)
        return [line for line in text.splitlines() if "[" not in line]

    assert render(thealth, tevents, tdashboard) == render(
        jhealth, jevents, jdashboard)


def test_dashboard_shows_engine_and_broker():
    broker = DescriptorBroker(TEngine(device="cpu"))
    desc = broker.make_descriptor("scan", axes=AXES, payload_bytes=N * 4)
    for name in ("a", "b"):
        broker.client(name).submit(desc, torch.ones((P, N)))
    broker.drain()
    text = tdashboard.render_dashboard(engine=broker.engine, broker=broker,
                                       monitor=thealth.HealthMonitor())
    assert "dispatches 1" in text and "coalesce 2.00" in text
    assert "health: OK" in text and "flight recorder" in text


def test_http_endpoints_serve_health_metrics_events():
    rec = tevents.get_recorder()
    rec.record("dispatch", coll="SCAN", cache="hit")
    now = {"t": 1000.0}
    mon = thealth.HealthMonitor(
        (thealth.SLO("deadline_miss", objective=0.9, fast_window_s=10.0,
                     slow_window_s=10.0),),
        clock=lambda: now["t"])
    tmetrics.get_registry().counter("repro_probe_total", "probe").inc()

    def get(path):
        try:
            with urllib.request.urlopen(url + path, timeout=10) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    with tdashboard.start_http_server(monitor=mon, recorder=rec) as srv:
        url = srv.url
        assert url.startswith("http://127.0.0.1:") and srv.port > 0
        status, body = get("/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        status, body = get("/metrics")
        assert status == 200 and "repro_probe_total" in body
        status, body = get("/events?kind=dispatch&limit=5")
        assert status == 200
        assert json.loads(body)["events"][0]["coll"] == "SCAN"
        status, body = get("/dashboard")
        assert status == 200 and "flight recorder" in body
        assert get("/nope")[0] == 404
        mon.observe("deadline_miss", key="a", bad=5.0, t=999.0)
        status, body = get("/healthz")
        assert status == 503 and json.loads(body)["status"] == "alert"


def test_broker_deadline_miss_event_and_counter():
    rec = tevents.FlightRecorder()
    prev = tevents.set_recorder(rec)
    try:
        broker = DescriptorBroker(TEngine(device="cpu")).start()
        try:
            desc = broker.make_descriptor("SCAN", p=P, payload_bytes=N * 4)
            broker.client("slowpoke").submit(
                desc, torch.ones((P, N)), deadline_s=1e-6).result(60.0)
        finally:
            broker.stop()
    finally:
        tevents.set_recorder(prev)
    (miss,) = rec.events(kind="deadline_miss")
    assert miss["tenant"] == "slowpoke" and miss["overrun_s"] > 0.0
    assert 'repro_service_deadline_misses_total{tenant="slowpoke"} 1' in \
        tmetrics.render_prometheus()


def test_tracer_link_probe_options():
    t = ttracing.Tracer(link_probe=True, link_injector=1, link_detector=2)
    assert (t.link_probe, t.link_injector, t.link_detector) == (True, 1, 2)
    assert not ttracing.Tracer().link_probe


def test_health_check_prints_all_ok(subprocess_runner):
    out = subprocess_runner("repro_torch.testing.health_check",
                            "--device", "cpu")
    assert ("health_check_summary,bitwise_equal,1,straggler_axis,1,"
            "straggler_src,0,straggler_dst,1,attribution_ok,1,slo_alert,1,"
            "dump_valid,1") in out


class _StallingBackend:
    """A level's exchanges, stalling ``stall_s`` on the first exchange of
    each pair (``first_only``) or on every one."""

    def __init__(self, p, stall_s, first_only):
        self.sim = talg.SimBackend(p, torch.device("cpu"))
        self.stall_s, self.first_only, self.seen = stall_s, first_only, set()

    @property
    def p(self):
        return self.sim.p

    def rank(self):
        return self.sim.rank()

    def permute(self, tree, perm):
        import time

        key = tuple(tuple(map(int, pair)) for pair in perm)
        if not (self.first_only and key in self.seen):
            time.sleep(self.stall_s)
        self.seen.add(key)
        return self.sim.permute(tree, perm)


def _probe_ewma(inner, plain):
    det = thealth.LinkStragglerDetector(min_samples=1, report_after=1)
    probe = thealth.LinkProbeBackend(inner, ttracing.NoopTracer(), level=1,
                                     detector=det, plain=plain)
    x = torch.arange(32.0).reshape(4, 8)
    pairs = [(0, 1), (1, 2), (2, 3)]
    got = probe.permute(x, pairs)
    assert torch.equal(got, talg.SimBackend(4, torch.device("cpu")).permute(x, pairs))
    return {(r["src"], r["dst"]): r["ewma_us"] for r in det.summary()}


def test_a_one_off_stall_on_a_fault_free_level_is_not_the_message_cost():
    """On a fault-free level (``inner`` is ``plain``) a message costs the
    least of its timed exchanges: one stalled exchange (a preempted
    thread, a cold cache) does not reach the detector."""
    level = _StallingBackend(4, 0.02, first_only=True)
    ewma = _probe_ewma(level, level)
    assert set(ewma) == {(0, 1), (1, 2), (2, 3)}
    assert max(ewma.values()) < 10e3, ewma


def test_a_delay_drawn_by_the_lossy_backend_is_the_message_cost():
    """Under chaos ``inner`` draws a fault (a delay among them) on each
    exchange, so its one exchange is the message's cost, delay included."""
    plain = talg.SimBackend(4, torch.device("cpu"))
    ewma = _probe_ewma(_StallingBackend(4, 0.005, first_only=False), plain)
    assert min(ewma.values()) >= 5e3, ewma
