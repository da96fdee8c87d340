"""``repro_torch.offload.reliability`` against ``repro.offload.reliability``.

* ``_fold_bytes`` gives the reference's value for the same bytes — int32,
  float32, bf16 and int8 leaves, at and under 16 KiB (full coverage) and
  above it (sampled runs), and with ``$REPRO_CHECKSUM_FULL``; a multi-leaf
  ``payload_checksum`` is the reference's fold over the port's structure
  digest (the whole digest differs between the packages on purpose: the
  structure digest hashes each package's own tree spec).
* Single-bit detection on small leaves and slice detection on sampled
  ones, as the reference's tests state them; ``verify_payload`` raises an
  attributed ``IntegrityError``.
* ``RetryPolicy``, ``CircuitBreaker`` and the degradation ladder behave
  like the reference's on the same script; one seeded chaos run over both
  packages' engines gives the same retry, degrade, breaker-skip and
  reference counts, the same breaker states and the same (int32, bitwise)
  results.
* ``DEGRADABLE_ERRORS`` is the reference's tuple and never catches a plain
  ``RuntimeError``, the error a K1 build or launch failure raises: such a
  failure propagates through ``ReliableDispatcher`` with no degrade.
* ``reference_collective`` equals the reference's for the five CollTypes
  (int32 SUM, bitwise) and runs on the card unless asked for the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.packet import WireDType as JWire
from repro.offload import OffloadEngine as JEngine
from repro.offload import reliability as jrel
from repro.runtime import chaos as jchaos
from repro_torch.core.packet import WireDType as TWire
from repro_torch.core.trees import tree_map
from repro_torch.kernels import fused_collective as fc
from repro_torch.offload import OffloadEngine as TEngine
from repro_torch.offload import reliability as trel
from repro_torch.runtime import chaos as tchaos
from test_torch_interop import BF16, assert_same, to_both

COLLS = ("SCAN", "EXSCAN", "REDUCE", "ALLREDUCE", "BARRIER")


@pytest.fixture(autouse=True)
def _coverage_cache():
    jrel._reset_full_coverage()
    trel._reset_full_coverage()
    yield
    jrel._reset_full_coverage()
    trel._reset_full_coverage()


@pytest.mark.parametrize("dtype", [np.int32, np.float32, BF16, np.int8])
@pytest.mark.parametrize("n", [1, 63, 4096, 16 << 10, (16 << 10) + 1,
                               100_003, 1 << 20])
def test_fold_bytes_equals_the_references(dtype, n):
    nbytes = np.dtype(dtype).itemsize
    count = max(1, n // nbytes)
    a = (np.random.default_rng(n).standard_normal(count) * 50).astype(dtype)
    raw = a.reshape(-1).view(np.uint8)
    t = torch.from_numpy(raw.copy())
    assert trel._fold_bytes(t, 99) == jrel._fold_bytes(raw, 99)


def test_fold_bytes_full_coverage_env(monkeypatch):
    monkeypatch.setenv("REPRO_CHECKSUM_FULL", "1")
    raw = np.random.default_rng(3).integers(0, 255, 300_001).astype(np.uint8)
    t = torch.from_numpy(raw.copy())
    assert trel._fold_bytes(t, 5) == jrel._fold_bytes(raw, 5)
    assert trel._gather(t).numel() == t.numel()


@pytest.mark.parametrize("tree", ["leaf", "tuple", "dict"])
def test_payload_checksum_is_the_references_fold(tree):
    rng = np.random.default_rng(1)
    a = rng.integers(-9, 9, (8, 5000)).astype(np.int32)
    b = rng.standard_normal((8, 33)).astype(BF16)
    c = rng.integers(-9, 9, (4, 3)).astype(np.int8)
    x = {"leaf": a, "tuple": (a, b), "dict": {"a": a, "c": c, "b": b}}[tree]
    jx, tx = to_both(x)
    leaves, spec = trel.tree_flatten(tx)
    key = (spec,) + tuple((str(l.dtype), tuple(l.shape)) for l in leaves)
    h = trel.zlib.crc32(repr(key).encode()) & trel._MASK64
    for leaf in leaves:
        raw = np.asarray(leaf.contiguous().view(torch.uint8).numpy())
        h = jrel._fold_bytes(raw.reshape(-1), h)
    assert trel.payload_checksum(tx) == h
    assert trel.payload_checksum(tx) == trel.payload_checksum(
        tree_map(torch.clone, tx))


def test_checksum_is_structure_sensitive():
    x = torch.arange(16, dtype=torch.int32)
    assert trel.payload_checksum(x) != trel.payload_checksum(x.reshape(4, 4))
    assert trel.payload_checksum(x) != trel.payload_checksum(x.float())
    assert trel.payload_checksum((x,)) != trel.payload_checksum([x])


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16,
                                   torch.int8])
def test_any_single_bit_flip_is_detected_on_small_leaves(dtype):
    x = torch.arange(64).reshape(8, 8).to(dtype)
    h = trel.payload_checksum(x)
    flat = x.view(torch.uint8).reshape(-1)
    for byte in range(flat.numel()):
        for bit in (0, 5, 7):
            y = flat.clone()
            y[byte] ^= 1 << bit
            assert trel.payload_checksum(y.view(dtype).reshape(8, 8)) != h


def test_slice_corruption_is_detected_when_sampled():
    x = torch.from_numpy(np.random.default_rng(2).integers(
        -1000, 1000, (8, 1 << 17)).astype(np.int32))
    h = trel.payload_checksum(x)
    span = x.numel() // trel._SAMPLE_RUNS
    for start in (0, 12345, x.numel() - span):
        y = x.reshape(-1).clone()
        y[start:start + span] ^= 0x10
        assert trel.payload_checksum(y.reshape(x.shape)) != h


def test_verify_payload_raises_an_attributed_error():
    x = torch.ones((4, 4))
    trel.verify_payload(x, trel.payload_checksum(x), request="t#0")
    with pytest.raises(trel.IntegrityError) as err:
        trel.verify_payload(x * 2, trel.payload_checksum(x), request="t#3")
    assert err.value.request == "t#3"


def _retry_script(mod):
    pol = mod.RetryPolicy(max_attempts=4, backoff_s=0.01, max_backoff_s=0.03)
    out = [pol.backoff(i) for i in range(6)]
    calls, slept, retried = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise mod.TransportError("lost")
        return "ok"

    out.append(pol.run(flaky, sleep=slept.append,
                       on_retry=lambda n, e: retried.append(n)))
    out += [slept, retried]
    try:
        pol.run(lambda: (_ for _ in ()).throw(mod.IntegrityError("crc")),
                sleep=lambda s: None)
    except mod.RetryExhaustedError as e:
        out.append((e.attempts, type(e.last_error).__name__))
    t = {"now": 0.0}
    try:
        pol.run(lambda: (_ for _ in ()).throw(mod.TransportError("x")),
                deadline=0.015, clock=lambda: t["now"],
                sleep=lambda s: t.__setitem__("now", t["now"] + s))
    except mod.RetryExhaustedError as e:
        out.append(("deadline", e.attempts))
    return out


def test_retry_policy_matches():
    assert _retry_script(trel) == _retry_script(jrel)


def _breaker_script(mod):
    t = {"now": 0.0}
    br = mod.CircuitBreaker(failure_threshold=2, cooldown_s=5.0,
                            clock=lambda: t["now"])
    key = ("pallas", "scan")
    trace = []
    for step in ["f", "f", "a", "t6", "a", "a", "f", "t12", "a", "s", "a"]:
        if step == "f":
            br.record_failure(key)
        elif step == "s":
            br.record_success(key)
        elif step == "a":
            trace.append(br.allow(key))
        else:
            t["now"] = float(step[1:])
        trace.append(br.state(key))
    return trace, br.snapshot(), br.open_keys()


def test_circuit_breaker_matches():
    assert _breaker_script(trel) == _breaker_script(jrel)


@pytest.mark.parametrize("kw", [dict(), dict(backend="pallas"),
                                dict(backend="pallas", optimize=False),
                                dict(chunks=2)])
def test_strategies_ladder_matches(kw):
    tdesc = TEngine(device="cpu").make_descriptor(
        "scan", axes=(2, 4), payload_bytes=256, op="sum", **kw)
    jdesc = JEngine().make_descriptor(
        "scan", axes=(2, 4), payload_bytes=256, op="sum", **kw)
    for degrade in (True, False):
        t = trel.ReliableDispatcher.strategies(tdesc, degrade=degrade)
        j = jrel.ReliableDispatcher.strategies(jdesc, degrade=degrade)
        assert [lab for lab, _ in t] == [lab for lab, _ in j]
        assert [None if d is None else d.encode().tolist() for _, d in t] \
            == [None if d is None else d.encode().tolist() for _, d in j]


def _chaos_run(rel, chaos, eng, to_x, wire, seed):
    t = {"now": 0.0}
    br = rel.CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                            clock=lambda: t["now"])
    disp = rel.ReliableDispatcher(
        eng, retry=rel.RetryPolicy(max_attempts=2, backoff_s=0.0),
        breaker=br, clock=lambda: t["now"], sleep=lambda s: None)
    rng = np.random.default_rng(seed)
    outs = []
    with chaos.ChaosInjector(seed, drop=0.08, corrupt=0.08).scope():
        for i in range(14):
            coll = COLLS[i % len(COLLS)]
            desc = eng.make_descriptor(coll, axes=(2, 4), payload_bytes=64,
                                       op="sum", data_type=wire.INT32)
            x = rng.integers(-50, 50, (8, 16)).astype(np.int32)
            outs.append(np.asarray(disp.offload(
                desc, None if coll == "BARRIER" else to_x(x))))
            t["now"] += 0.6
    return disp.counts, br.snapshot(), outs


@pytest.mark.parametrize("seed", [3, 20140409])
def test_seeded_chaos_run_counts_match(seed):
    import jax.numpy as jnp

    tcounts, tsnap, touts = _chaos_run(
        trel, tchaos, TEngine(device="cpu"), torch.from_numpy, TWire, seed)
    jcounts, jsnap, jouts = _chaos_run(
        jrel, jchaos, JEngine(), jnp.asarray, JWire, seed)
    assert tcounts == jcounts
    assert tsnap == jsnap
    assert tcounts["retries"] > 0 and tcounts["degrades"] > 0
    for a, b in zip(touts, jouts):
        np.testing.assert_array_equal(a, b)


def test_total_loss_degrades_to_the_reference_collective():
    eng = TEngine(device="cpu")
    disp = trel.ReliableDispatcher(
        eng, retry=trel.RetryPolicy(max_attempts=2, backoff_s=0.0),
        sleep=lambda s: None)
    desc = eng.make_descriptor("scan", axes=(2, 4), payload_bytes=64,
                               op="sum", data_type=TWire.INT32)
    x = torch.arange(128, dtype=torch.int32).reshape(8, 16)
    want = eng.offload(desc, x)
    with tchaos.ChaosInjector(1, drop=1.0).scope():
        out = disp.offload(desc, x)
    assert torch.equal(out, want)
    assert disp.counts["reference_dispatches"] == 1
    assert disp.counts["degrades"] == len(disp.strategies(desc)) - 1


def test_degradable_errors_never_catch_a_kernel_failure(monkeypatch):
    assert trel.DEGRADABLE_ERRORS == (
        trel.RetryExhaustedError, trel.TransportError, trel.IntegrityError,
        trel.CircuitOpenError, NotImplementedError)
    assert [e.__name__ for e in trel.DEGRADABLE_ERRORS] == \
        [e.__name__ for e in jrel.DEGRADABLE_ERRORS]
    build_error = RuntimeError("nvcc failed building fused_collective.cu")
    assert not isinstance(build_error, trel.DEGRADABLE_ERRORS)

    def broken(*a, **k):
        raise RuntimeError("K1 launch failed: an illegal memory access")

    eng = TEngine(device="cpu")
    disp = trel.ReliableDispatcher(eng)
    desc = eng.make_descriptor("scan", axes=(1, 8), payload_bytes=64,
                               op="sum", backend="pallas", chunks=1)
    x = torch.ones((8, 16))
    assert torch.equal(disp.offload(desc, x), eng.offload(desc, x))
    monkeypatch.setattr(fc, "comm_phase", broken)
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        disp.offload(desc, x)
    assert disp.counts["degrades"] == 0
    assert disp.counts["reference_dispatches"] == 0


@pytest.mark.parametrize("coll", COLLS)
def test_reference_collective_matches(coll):
    x = np.random.default_rng(4).integers(-9, 9, (8, 12)).astype(np.int32)
    jx, tx = to_both(x)
    tdesc = TEngine(device="cpu").make_descriptor(
        coll, axes=(2, 4), payload_bytes=48, op="sum",
        data_type=TWire.INT32, root=3)
    jdesc = JEngine().make_descriptor(
        coll, axes=(2, 4), payload_bytes=48, op="sum",
        data_type=JWire.INT32, root=3)
    none = coll == "BARRIER"
    assert_same(jrel.reference_collective(jdesc, None if none else jx),
                trel.reference_collective(tdesc, None if none else tx,
                                          device="cpu"))


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    desc = TEngine(device="cpu").make_descriptor(
        "scan", axes=(2, 4), payload_bytes=16, op="sum")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        trel.reference_collective(desc, torch.ones(8, 4))
    with pytest.raises(ValueError, match="move it"):
        trel.reference_collective(desc, torch.ones(8, 4).to("meta"),
                                  device="cpu")


def test_happy_path_takes_no_degrade_and_verifies_nothing_it_need_not():
    eng = TEngine(device="cpu")
    disp = trel.ReliableDispatcher.from_policy(eng, trel.ReliabilityPolicy())
    desc = eng.make_descriptor("scan", axes=(1, 8), payload_bytes=64,
                               op="sum", backend="pallas", chunks=1)
    x = torch.ones((8, 16))
    for _ in range(3):
        assert torch.equal(disp.offload(desc, x), eng.offload(desc, x))
    assert disp.counts == dict(disp.counts, dispatches=3, retries=0,
                               degrades=0, breaker_skips=0,
                               reference_dispatches=0)
    assert eng.telemetry.backend_fallbacks == 0
    assert dataclasses.asdict(trel.RetryPolicy()) == dataclasses.asdict(
        jrel.RetryPolicy()) | {"retryable": trel.RETRYABLE_ERRORS}
