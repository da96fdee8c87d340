"""The whole slice: ``repro_torch.offload.engine.OffloadEngine`` against
``repro.offload.engine.OffloadEngine`` on the same descriptors and payloads.

Descriptor words, cache keys, cache-size behaviour (as in
``tests/test_pallas_backend.py``), telemetry keys and results agree; the
fused backend ("pallas") and the default sim lowering both run, the latter
also for the non-planned single-axis descriptors. Float32 sums are bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.selector import set_active_tuning as j_set_tuning
from repro.offload import OffloadEngine as JEngine
from repro_torch.core.packet import CollectiveDescriptor, WireDType
from repro_torch.core.selector import set_active_tuning as t_set_tuning
from repro_torch.kernels import fused_collective as tfc
from repro_torch.offload import OffloadEngine as TEngine
from test_torch_interop import assert_same, to_both

P = 8
N = 16


@pytest.fixture(autouse=True)
def _no_active_tuning():
    j_set_tuning(None)
    t_set_tuning(None)
    yield
    j_set_tuning(None)
    t_set_tuning(None)


def _engines():
    return JEngine(), TEngine(device="cpu")


def _payload(seed=0, p=P, n=N):
    rng = np.random.default_rng(seed)
    return rng.integers(-5, 6, size=(p, n)).astype(np.float32)


@pytest.mark.parametrize("coll", ["SCAN", "EXSCAN", "REDUCE", "ALLREDUCE",
                                  "BARRIER"])
@pytest.mark.parametrize("backend", ["", "pallas"])
@pytest.mark.parametrize("axes", [(1, P), (2, 4), (1, 2, 4)], ids=str)
def test_planned_dispatch_matches_reference(coll, backend, axes):
    je, te = _engines()
    x = np.random.default_rng(1).standard_normal((P, N)).astype(np.float32)
    jx, tx = to_both(x)
    for nb in (4 * N, 1 << 20):
        dj = je.make_descriptor(coll, axes=axes, payload_bytes=nb,
                                backend=backend, root=3)
        dt = te.make_descriptor(coll, axes=axes, payload_bytes=nb,
                                backend=backend, root=3)
        assert dt.encode().tobytes() == dj.encode().tobytes()
        if nb != 4 * N:
            continue  # the descriptor words at 1 MiB; dispatch at 64 B
        arg_j, arg_t = (None, None) if coll == "BARRIER" else (jx, tx)
        want = je.offload(dj, arg_j)
        got = te.offload(dt.encode(), arg_t)   # words straight off the wire
        assert_same(want, got, what=f"{coll} {backend} {axes}")
    # the same cache rows, keyed byte-identically
    assert set(te._cache) == set(je._cache)
    sj, st = je.telemetry.snapshot(), te.telemetry.snapshot()
    assert st.keys() == sj.keys()
    for key in ("hits", "misses", "compiles", "cache_size",
                "backend_fallbacks", "backend_fallback_reasons",
                "calls_by_coll"):
        assert st[key] == sj[key], key
    assert {s.algo for s in te._cache.values()} == {
        s.algo for s in je._cache.values()}


@pytest.mark.parametrize("coll", ["SCAN", "EXSCAN", "REDUCE", "ALLREDUCE",
                                  "BARRIER"])
@pytest.mark.parametrize("op,dtype", [("sum", np.int32), ("max", np.float32),
                                      ("min", np.int8), ("prod", np.float32)])
def test_single_axis_dispatch_matches_reference(coll, op, dtype):
    je, te = _engines()
    wd = {np.int32: WireDType.INT32, np.float32: WireDType.FLOAT32,
          np.int8: WireDType.INT8}[dtype]
    x = (np.random.default_rng(2).integers(-3, 4, (6, 5)).astype(dtype))
    jx, tx = to_both(x)
    nb = 5 * np.dtype(dtype).itemsize
    dj = je.make_descriptor(coll, p=6, payload_bytes=nb, op=op, data_type=wd,
                            root=2)
    dt = te.make_descriptor(coll, p=6, payload_bytes=nb, op=op, data_type=wd,
                            root=2)
    assert dt.encode().tobytes() == dj.encode().tobytes()
    arg_j, arg_t = (None, None) if coll == "BARRIER" else (jx, tx)
    assert_same(je.offload(dj, arg_j), te.offload(dt, arg_t))
    assert set(te._cache) == set(je._cache)


@pytest.mark.parametrize("coll", ["SCAN", "EXSCAN", "ALLREDUCE"])
def test_ssd_and_flash_payloads_dispatch(coll):
    je, te = _engines()
    rng = np.random.default_rng(6)
    ssd = (rng.choice([0.5, 1.0, 2.0], (P, 4)).astype(np.float32),
           rng.integers(-4, 5, (P, 4)).astype(np.float32))
    flash = (np.full((P, 4), 2.0, np.float32),
             rng.integers(1, 6, (P, 4)).astype(np.float32),
             rng.integers(-5, 6, (P, 4)).astype(np.float32))
    for op, x in (("ssd", ssd), ("flash", flash)):
        jx, tx = to_both(x)
        for backend in ("", "pallas"):
            dj = je.make_descriptor(coll, axes=(1, P), payload_bytes=16,
                                    op=op, backend=backend)
            dt = te.make_descriptor(coll, axes=(1, P), payload_bytes=16,
                                    op=op, backend=backend)
            assert dt.encode().tobytes() == dj.encode().tobytes()
            assert_same(je.offload(dj, jx), te.offload(dt, tx))
    assert (te.telemetry.snapshot()["backend_fallback_reasons"]
            == je.telemetry.snapshot()["backend_fallback_reasons"])


def test_pinned_fused_backend_gets_its_own_cache_row():
    te = TEngine(device="cpu")
    _, x = to_both(_payload())
    default = te.make_descriptor("SCAN", axes=(1, P), payload_bytes=4 * N,
                                 backend="")
    pinned = te.make_descriptor("SCAN", axes=(1, P), payload_bytes=4 * N,
                                backend="pallas")
    ref = te.offload(default, x)
    got = te.offload(pinned, x)
    assert torch.equal(ref, got)
    assert te.cache_size() == 2
    snap = te.telemetry.snapshot()
    assert snap["backend_fallbacks"] == 0
    assert snap["backend_fallback_reasons"] == {}
    assert any(s.algo.startswith("pallas:") for s in te._cache.values())


def test_fallback_shares_cache_entry_and_counts_once():
    te = TEngine(device="cpu")
    _, x = to_both(_payload())
    default = te.make_descriptor("SCAN", axes=(2, 4), payload_bytes=4 * N,
                                 backend="")
    pinned = te.make_descriptor("SCAN", axes=(2, 4), payload_bytes=4 * N,
                                backend="pallas")
    assert torch.equal(te.offload(default, x), te.offload(pinned, x))
    assert te.cache_size() == 1
    snap = te.telemetry.snapshot()
    assert snap["backend_fallbacks"] == 1
    assert snap["backend_fallback_reasons"] == {"not_single_axis": 1}
    te.offload(pinned, x)
    assert te.telemetry.snapshot()["backend_fallbacks"] == 1


def test_chunked_auto_falls_back_at_1mib_like_reference():
    """At 1 MiB per rank ``chunks="auto"`` resolves to 8 chunks, outside the
    fused kernel's envelope: both engines soft-fall back with ``chunked``;
    pinning ``chunks=1`` keeps the kernel and counts no fallback."""
    je, te = _engines()
    for coll in ("SCAN", "EXSCAN"):
        dj = je.make_descriptor(coll, axes=(1, P), payload_bytes=1 << 20,
                                backend="pallas")
        dt = te.make_descriptor(coll, axes=(1, P), payload_bytes=1 << 20,
                                backend="pallas")
        assert dt.chunks == dj.chunks == 8
        assert len(dt.encode()) == 17
        assert dt.encode().tobytes() == dj.encode().tobytes()
        x = np.random.default_rng(0).standard_normal((P, 64)).astype(np.float32)
        jx, tx = to_both(x)
        assert_same(je.offload(dj, jx), te.offload(dt, tx))
    for eng in (je, te):
        snap = eng.telemetry.snapshot()
        assert snap["backend_fallback_reasons"] == {"chunked": 2}
    pinned = te.make_descriptor("SCAN", axes=(1, P), payload_bytes=1 << 20,
                                backend="pallas", chunks=1)
    assert pinned.chunks == 1 and len(pinned.encode()) == 16
    te.offload(pinned, to_both(np.ones((P, 64), np.float32))[1])
    assert te.telemetry.snapshot()["backend_fallbacks"] == 2


def test_default_backend_cache_key_is_stable():
    te = TEngine(device="cpu")
    _, x = to_both(_payload())
    auto = te.make_descriptor("SCAN", axes=(1, P), payload_bytes=4 * N)
    assert auto.backend == ""
    te.offload(auto, x)
    keys = set(te._cache)
    te.offload(te.make_descriptor("SCAN", axes=(1, P), payload_bytes=4 * N,
                                  backend=""), x)
    assert set(te._cache) == keys and te.cache_size() == 1


def test_cache_hits_clear_and_telemetry_keys():
    je, te = _engines()
    _, x = to_both(_payload())
    desc = te.make_descriptor("ALLREDUCE", axes=(1, P), payload_bytes=4 * N,
                              backend="pallas")
    for _ in range(3):
        te.offload(desc, x)
    snap = te.telemetry.snapshot()
    assert (snap["hits"], snap["misses"], snap["dispatches"]) == (2, 1, 3)
    assert snap["calls_by_coll"] == {"allreduce": 3}
    assert snap["latency_source_by_coll"] == {"allreduce": "wall"}
    assert snap.keys() == je.telemetry.snapshot().keys()
    te.clear()
    assert te.cache_size() == 0
    assert te.telemetry.snapshot()["cache_clears"] == 1
    te.offload(desc, x)
    assert te.telemetry.snapshot()["misses"] == 2


def test_descriptor_round_trip_from_reference_words():
    je = JEngine()
    dj = je.make_descriptor("EXSCAN", axes=(2, 4), payload_bytes=1024,
                            backend="pallas", comm_id=9)
    dt = CollectiveDescriptor.decode(dj.encode())
    assert dt.encode().tobytes() == dj.encode().tobytes()
    assert (dt.axes, dt.split, dt.backend, dt.chunks) == (
        dj.axes, dj.split, dj.backend, dj.chunks)


def test_payload_validation():
    te = TEngine(device="cpu")
    desc = te.make_descriptor("SCAN", axes=(1, P), payload_bytes=4 * N)
    with pytest.raises(ValueError, match="requires a payload"):
        te.offload(desc, None)
    with pytest.raises(ValueError, match="leading rank axis"):
        te.offload(desc, torch.zeros(P + 1, N))
    with pytest.raises(ValueError, match="engine runs on"):
        te.offload(desc, torch.zeros(P, N, device="meta"))
    assert te.telemetry.snapshot()["dispatches"] == 0


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(device="cuda")
    assert TEngine(device="cpu").device == torch.device("cpu")


def test_fused_path_on_cpu_launches_nothing():
    before = tfc.launches
    te = TEngine(device="cpu")
    _, x = to_both(_payload())
    desc = te.make_descriptor("SCAN", axes=(1, P), payload_bytes=4 * N,
                              backend="pallas", chunks=1)
    out = te.offload(desc, x)
    assert torch.equal(out, torch.cumsum(x, 0))
    assert tfc.launches == before
    assert jnp.asarray(1).dtype == jnp.int32  # JAX stays on its defaults
