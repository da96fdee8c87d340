"""``repro_torch.service`` (broker, telemetry, registry) against
``repro.service``.

* k tenants' requests coalesced into one fused dispatch give the reference
  broker's results, bitwise, for int32 and float32 SUM over every CollType,
  single-axis, planned (2, 4) and ``backend="pallas"`` at (1, 8) (K1's plain
  version on the CPU), with pow2 padding; pytree payloads too, and driver
  mode over a co-resident ``compat.Mesh`` equals sim mode. The port's own
  results are also held against a direct ``offload`` of each request.
* Each ticket's result is a tensor of its own: writing into one leaves the
  others unchanged (barrier and single-request groups included).
* Flow control (queue bound, admission, stop, deadline misses) leaves the
  reference's per-tenant counters; the latency histogram gives its
  percentiles.
* The registry merges tables of one fingerprint keeping the lower cost,
  refuses a cross-fingerprint merge and any JAX-fingerprinted table, never
  lists a JAX table in a shared directory, and reads
  ``$REPRO_TORCH_TUNING_REGISTRY``.
* ``python -m repro_torch.testing.service_check --device cpu`` prints ALL-OK.
"""

import json

import numpy as np
import pytest
import torch

from repro.core.packet import WireDType as JWire
from repro.core.selector import set_active_tuning as j_set_tuning
from repro.offload import OffloadEngine as JEngine
from repro.service import DescriptorBroker as JBroker
from repro.service import telemetry as jtelemetry
from repro_torch.compat import Mesh
from repro_torch.core.packet import WireDType as TWire
from repro_torch.core.selector import set_active_tuning as t_set_tuning
from repro_torch.offload import OffloadEngine as TEngine
from repro_torch.offload import TuningCache
from repro_torch.service import (
    AdmissionError,
    BrokerStopped,
    DescriptorBroker,
    FileTuningRegistry,
    QueueFullError,
    TuningRegistry,
    default_registry,
    registry as tregistry,
    telemetry as ttelemetry,
)
from test_torch_interop import assert_same, to_both

COLLS = ("SCAN", "EXSCAN", "REDUCE", "ALLREDUCE", "BARRIER")
TOPOLOGIES = {
    "p8": dict(p=8),
    "axes24": dict(axes=(2, 4)),
    "pallas18": dict(axes=(1, 8), backend="pallas", chunks=1),
}


@pytest.fixture(autouse=True)
def _no_active_tuning():
    j_set_tuning(None)
    t_set_tuning(None)
    yield
    j_set_tuning(None)
    t_set_tuning(None)


def _cpu_broker(**kw):
    return DescriptorBroker(TEngine(device="cpu"), **kw)


def _payloads(k, dtype, seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(-50, 50, (8, n)).astype(dtype) for _ in range(k)]


def _run_both(coll, dtype, topo, xs, wire_name, pytree=False):
    outs = []
    for broker, wire in ((JBroker(JEngine()), JWire),
                         (_cpu_broker(), TWire)):
        desc = broker.make_descriptor(
            coll, payload_bytes=24, op="sum",
            data_type=getattr(wire, wire_name), **TOPOLOGIES[topo])
        tickets = []
        for x in xs:
            jx, tx = to_both((x, x * 3) if pytree else x)
            payload = tx if isinstance(broker, DescriptorBroker) else jx
            tickets.append(broker.client().submit(
                desc.encode(), None if coll == "BARRIER" else payload))
        assert broker.drain() == len(xs)
        outs.append((broker, desc, [t.result(30) for t in tickets]))
    return outs


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
@pytest.mark.parametrize("coll", COLLS)
@pytest.mark.parametrize("dtype,wire", [(np.int32, "INT32"),
                                        (np.float32, "FLOAT32")])
def test_coalesced_results_equal_the_reference_brokers(coll, dtype, wire,
                                                       topo):
    xs = _payloads(5, dtype)  # five tenants: padded to a fused width of 8
    (jb, _, jouts), (tb, tdesc, touts) = _run_both(coll, dtype, topo, xs, wire)
    for j, t in zip(jouts, touts):
        assert_same(j, t, what=f"{coll} {topo}")
    assert tb.telemetry.coalesce_factor == jb.telemetry.coalesce_factor == 5.0
    assert tb.engine.telemetry.dispatches == 1
    # REDUCE is no K1 phase: both engines fall back for it, alike
    assert tb.engine.telemetry.backend_fallbacks == \
        jb.engine.telemetry.backend_fallbacks == int(
            topo == "pallas18" and coll == "REDUCE")
    direct = TEngine(device="cpu")
    for x, got in zip(xs, touts):
        want = direct.offload(tdesc, None if coll == "BARRIER"
                              else torch.from_numpy(x))
        assert torch.equal(got, want)


@pytest.mark.parametrize("topo", ["p8", "axes24"])
def test_pytree_payloads_coalesce_like_the_reference(topo):
    xs = _payloads(3, np.int32, seed=4)
    (jb, _, jouts), (tb, _, touts) = _run_both("SCAN", np.int32, topo, xs,
                                               "INT32", pytree=True)
    for j, t in zip(jouts, touts):
        assert_same(j, t)
    assert tb.engine.telemetry.dispatches == 1


def test_driver_mode_broker_equals_sim_mode():
    mesh = Mesh((2, 4), ("pod", "data"), device="cpu")
    driver = _cpu_broker(axis_name=("pod", "data"), mesh=mesh)
    sim = _cpu_broker()
    xs = [torch.from_numpy(x) for x in _payloads(3, np.float32, seed=2)]
    desc = sim.make_descriptor("SCAN", axes=(2, 4), payload_bytes=24,
                               split=(1, 0))
    got = []
    for broker in (driver, sim):
        tickets = [broker.client().submit(desc, x) for x in xs]
        broker.drain()
        got.append([t.result(30) for t in tickets])
    for a, b in zip(*got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("coll,k", [("SCAN", 4), ("ALLREDUCE", 3),
                                    ("BARRIER", 3), ("SCAN", 1)])
def test_each_ticket_owns_its_result(coll, k):
    broker = _cpu_broker()
    desc = broker.make_descriptor(coll, axes=(1, 8), payload_bytes=24,
                                  backend="pallas", chunks=1)
    xs = [torch.from_numpy(x) for x in _payloads(k, np.float32)]
    tickets = [broker.client().submit(desc, None if coll == "BARRIER"
                                      else x) for x in xs]
    broker.drain()
    results = [t.result(5) for t in tickets]
    before = [r.clone() for r in results]
    ptrs = {r.untyped_storage().data_ptr() for r in results}
    assert len(ptrs) == k
    results[0].add_(1000)
    for r, b in zip(results[1:], before[1:]):
        assert torch.equal(r, b)
    assert all(r.is_contiguous() for r in results)


def test_groups_split_by_descriptor_dtype_and_shape():
    broker = _cpu_broker()
    scan = broker.make_descriptor("SCAN", p=8, payload_bytes=24)
    allred = broker.make_descriptor("ALLREDUCE", p=8, payload_bytes=24)
    c = broker.client()
    x = torch.ones((8, 6))
    for desc, payload in ((scan, x), (scan, x), (allred, x),
                          (scan, x.double()), (scan, torch.ones((8, 7)))):
        c.submit(desc, payload)
    broker.drain()
    assert broker.telemetry.snapshot()["fused_dispatches"] == 4


def _flow_control(make_broker, to_x, desc_kw):
    broker = make_broker(max_tenants=3)
    desc = broker.make_descriptor("SCAN", p=8, payload_bytes=24, **desc_kw)
    small = broker.client("small", max_queue_depth=2)
    ok = broker.client("ok")
    x = to_x(np.ones((8, 6), np.float32))
    small.submit(desc, x)
    small.submit(desc, x)
    events = []
    try:
        small.submit(desc, x)
    except Exception as e:
        events.append(type(e).__name__)
    ok.submit(desc, x, deadline_s=-1.0)
    broker.client("third")
    try:
        broker.client("fourth")
    except Exception as e:
        events.append(type(e).__name__)
    broker.drain()
    ok.submit(desc, x)
    broker.stop(drain=False)
    try:
        ok.submit(desc, x)
    except Exception as e:
        events.append(type(e).__name__)
    snap = broker.telemetry.snapshot()
    tenants = {
        name: {k: v for k, v in t.items() if k != "latency"}
        for name, t in snap["tenants"].items()
    }
    return events, tenants, snap["fused_requests"], snap["flushes"]


def test_flow_control_counters_match_the_reference():
    import jax.numpy as jnp

    t = _flow_control(_cpu_broker, torch.from_numpy, {})
    j = _flow_control(lambda **kw: JBroker(JEngine(), **kw), jnp.asarray, {})
    assert t == j
    assert t[0] == [QueueFullError.__name__, AdmissionError.__name__,
                    BrokerStopped.__name__]


def test_latency_histogram_matches():
    samples = [3e-6, 4e-5, 2e-4, 2e-4, 9e-3, 0.3, 7.0, 1e-4]
    th, jh = ttelemetry.LatencyHistogram(), jtelemetry.LatencyHistogram()
    for s in samples:
        th.record(s)
        jh.record(s)
    assert th.snapshot() == jh.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.percentile_us(q) == jh.percentile_us(q)
    assert th.count_at_or_below(250.0) == jh.count_at_or_below(250.0)


def _table(us_scan_01, us_scan_10, device="cpu"):
    t = TuningCache(device=device)
    t.record("scan", "hillis_steele", 8, 1024, us_scan_01)
    t.record_split("scan", (2, 4), (0, 1), 1024, us_scan_01)
    t.record_split("scan", (2, 4), (1, 0), 1024, us_scan_10)
    return t


def test_registry_merges_one_fingerprint_keeping_the_lower_cost():
    reg = TuningRegistry()
    reg.publish(_table(5e-3, 9e-3))
    merged = reg.publish(_table(7e-3, 1e-3))
    assert merged.split_winner("scan", (2, 4), 1024) == (1, 0)
    assert [m.seconds for m in merged.measurements] == [5e-3]
    fetched = reg.fetch(device="cpu")
    assert fetched is not merged and len(fetched.split_measurements) == 2
    assert reg.backends() == [fetched.backend]
    assert fetched.backend.startswith("torch-cpu:")


def test_registry_refuses_other_fingerprints(tmp_path):
    other = TuningCache(backend="torch-cuda:Other:sm_80:x86_64")
    with pytest.raises(ValueError, match="across backends"):
        _table(1e-3, 2e-3).merge(other)
    jax_table = TuningCache(backend="cpu:cpu:x86_64")
    for reg in (TuningRegistry(), FileTuningRegistry(tmp_path)):
        with pytest.raises(ValueError, match="JAX tables"):
            reg.publish(jax_table)
    # a JAX table in a shared directory is never listed or read
    (tmp_path / "jax.json").write_text(json.dumps(
        {"schema_version": 1, "backend": "cpu:cpu:x86_64"}))
    reg = FileTuningRegistry(tmp_path)
    reg.publish(_table(1e-3, 2e-3))
    assert all(b.startswith("torch-") for b in reg.backends())
    assert reg.fetch("cpu:cpu:x86_64") is None
    fresh = FileTuningRegistry(tmp_path).fetch(device="cpu")
    assert fresh is not None and fresh.split_winner(
        "scan", (2, 4), 1024) == (0, 1)


def test_registry_env_and_broker_inheritance(tmp_path, monkeypatch):
    assert tregistry.TUNING_REGISTRY_ENV == "REPRO_TORCH_TUNING_REGISTRY"
    monkeypatch.delenv("REPRO_TORCH_TUNING_REGISTRY", raising=False)
    monkeypatch.setenv("REPRO_TUNING_REGISTRY", str(tmp_path / "jax"))
    assert default_registry() is None
    monkeypatch.setenv("REPRO_TORCH_TUNING_REGISTRY", str(tmp_path))
    reg = default_registry()
    reg.publish(_table(5e-3, 9e-3))
    reg.publish(_table(7e-3, 1e-3))
    broker = _cpu_broker(registry=reg)
    desc = broker.make_descriptor("SCAN", axes=(2, 4), payload_bytes=1024,
                                  split="auto")
    assert desc.split == (1, 0) and broker.tuning_table is not None


def test_default_broker_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DescriptorBroker()


def test_started_broker_serves_threaded_clients():
    import threading

    broker = _cpu_broker(flush_interval_s=0.05).start()
    desc = broker.make_descriptor("ALLREDUCE", axes=(2, 4), payload_bytes=24,
                                  data_type=TWire.INT32)
    xs = [torch.from_numpy(x) for x in _payloads(6, np.int32, seed=9)]
    direct = TEngine(device="cpu")
    got = {}
    gate = threading.Barrier(len(xs))

    def work(i):
        gate.wait()
        got[i] = broker.client(f"t{i}").offload(desc, xs[i], timeout=30)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    broker.stop()
    for i, x in enumerate(xs):
        assert torch.equal(got[i], direct.offload(desc, x))
    assert broker.telemetry.coalesce_factor > 1.0


def test_service_check_prints_all_ok(subprocess_runner):
    out = subprocess_runner("repro_torch.testing.service_check",
                            "--device", "cpu")
    assert "service_check_summary,bitwise_equal,1,coalesce_gt1,1" in out


def test_stress_many_threads_short_switch_interval():
    """More client threads than cores, a short switch interval: no ticket
    lost or crossed, and the counters add up."""
    import os
    import sys
    import threading

    n_threads = max(16, 2 * (os.cpu_count() or 1))
    rounds = 5
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        broker = _cpu_broker(flush_interval_s=0.001, max_tenants=n_threads)
        broker.start()
        desc = broker.make_descriptor("ALLREDUCE", p=8, payload_bytes=16,
                                      data_type=TWire.INT32)
        bad = []

        def work(i):
            client = broker.client(f"s{i}")
            for r in range(rounds):
                x = torch.full((8, 4), i * 100 + r, dtype=torch.int32)
                got = client.offload(desc, x, timeout=60)
                if not torch.equal(got, x * 8):
                    bad.append((i, r))

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        broker.stop()
    finally:
        sys.setswitchinterval(prev)
    assert bad == []
    snap = broker.telemetry.snapshot()
    assert snap["fused_requests"] == n_threads * rounds
    assert all(t["completed"] == rounds and t["errors"] == 0
               for t in snap["tenants"].values())
