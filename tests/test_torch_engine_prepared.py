"""The engine's prepared dispatch, on the CPU: a repeat sim-mode request
(the same wire bytes and payload signature) takes its schedule from one
lookup, counted by the span ``engine.reuse``, and gives the bits, telemetry,
registry series, flight-recorder events and spans of the full path, which
every bypass still takes. The packed K1 launch under it runs on the card
alone (``tests/test_torch_k1_packed.py``).
"""

import contextlib

import pytest
import torch

from repro_torch import compat
from repro_torch.core.selector import set_active_tuning
from repro_torch.obs import events as tevents
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import tracing as ttracing
from repro_torch.offload import OffloadEngine
from repro_torch.offload import engine as engine_module
from repro_torch.roofline.op_cost import CostMode
from repro_torch.runtime.chaos import ChaosInjector

P, N = 8, 16
COLLS = ("SCAN", "EXSCAN", "REDUCE", "ALLREDUCE", "BARRIER")
AXES = ((P,), (1, P), (2, 4))


@pytest.fixture(autouse=True)
def _untuned():
    set_active_tuning(None)
    yield
    set_active_tuning(None)


def reuses():
    return ttracing.span_totals().get("engine.reuse", (0, 0))[0]


def counts():
    return {name: c for name, (c, _) in ttracing.span_totals().items()}


def payload(coll, seed=0, shape=(P, N), dtype=torch.float32):
    if coll == "BARRIER":
        return None
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype)


def request(coll="SCAN", axes=(1, P), backend="pallas"):
    """An engine on the CPU and the wire words of one request."""
    eng = OffloadEngine(device="cpu")
    planned = len(axes) > 1
    desc = eng.make_descriptor(
        coll, axes=axes if planned else None, p=P, payload_bytes=N * 4,
        root=3, backend=backend if planned else "auto",
        chunks=1 if planned else "auto")
    return eng, desc.encode()


def assert_same(got, want):
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)


@pytest.mark.parametrize("axes", AXES, ids=str)
@pytest.mark.parametrize("coll", COLLS)
def test_repeat_dispatch_is_prepared_and_bitwise_the_full_path(coll, axes):
    eng, words = request(coll, axes)
    xs = [payload(coll, seed) for seed in range(3)]
    first = reuses()
    got = [eng.offload(words, x) for x in xs]
    # the first dispatch compiles; the two repeats are prepared
    assert reuses() - first == 2
    for x, out in zip(xs, got):
        fresh, fresh_words = request(coll, axes)
        assert_same(out, fresh.offload(fresh_words, x))


@contextlib.contextmanager
def isolated():
    """A fresh metrics registry and flight recorder for the block."""
    reg = tmetrics.MetricsRegistry()
    prev_reg = tmetrics.set_registry(reg)
    prev_rec = tevents.set_recorder(None)
    try:
        yield reg, tevents.get_recorder()
    finally:
        tmetrics.set_registry(prev_reg)
        tevents.set_recorder(prev_rec)


def accounts(words, n, as_list):
    """Telemetry, registry series, event counts and span counts after ``n``
    dispatches of one request (as a list of words: the full path every
    time)."""
    eng, _ = request()
    x = payload("SCAN")
    before = counts()
    with isolated() as (reg, rec):
        for _ in range(n):
            eng.offload(words.tolist() if as_list else words, x)
        series = {k: v for k, v in reg.collect().items()
                  if k.startswith("repro_engine_")}
        events = rec.counts()
    spans = {k: v - before.get(k, 0) for k, v in counts().items()
             if v != before.get(k, 0)}
    snap = eng.telemetry.snapshot()
    for timed in ("mean_latency_us", "last_latency_us", "latency_by_coll_us"):
        snap[timed] = sorted(snap[timed]) if isinstance(snap[timed], dict) \
            else None
    hist = series["repro_engine_dispatch_latency_us"]["series"]
    series["repro_engine_dispatch_latency_us"]["series"] = {
        k: v["count"] for k, v in hist.items()}
    return snap, series, events, spans


@pytest.mark.parametrize("n", [1, 2, 5])
def test_accounting_reads_as_the_full_path(n):
    _, words = request()
    snap, series, events, spans = accounts(words, n, as_list=False)
    want_snap, want_series, want_events, want_spans = accounts(
        words, n, as_list=True)
    assert snap == want_snap
    assert series == want_series
    assert events == want_events
    assert spans.pop("engine.reuse", 0) == n - 1
    assert spans == want_spans
    assert snap["hits"] == n - 1 and snap["dispatches"] == n


def test_a_swapped_registry_is_published_into():
    eng, words = request()
    x = payload("SCAN")
    eng.offload(words, x)
    with isolated() as (reg, _):
        eng.offload(words, x)
        eng.offload(words, x)
        hits = reg.counter("repro_engine_cache_events_total",
                           labelnames=("event",))
        assert hits.value(event="hit") == 2
        assert reg.counter("repro_engine_dispatches_total",
                           labelnames=("coll",)).value(coll="scan") == 2


def _tracer(eng, words, x):
    with ttracing.tracing():
        return eng.offload(words, x)


def _chaos(eng, words, x):
    with ChaosInjector(5).scope():
        return eng.offload(words, x)


def _cost(eng, words, x):
    # the schedule charges K1 under a CostMode (its one comm phase), from a
    # prepared dispatch as from a full one: the CostMode is the lowering's
    # to see, not the engine's
    with CostMode() as mode:
        out = eng.offload(words, x)
    assert [c.kind for c in mode.charges] == ["k1"]
    return out


def _shape(eng, words, x):
    return eng.offload(words, torch.cat([x, x], dim=1))


def _dtype(eng, words, x):
    return eng.offload(words, x.to(torch.int32))


def _strided(eng, words, x):
    y = torch.empty(x.shape[::-1]).t()
    y.copy_(x)
    assert not y.is_contiguous()
    return eng.offload(words, y)


def _pytree(eng, words, x):
    return eng.offload(words, (x, 2 * x))


def _descriptor_list(eng, words, x):
    return eng.offload(words.tolist(), x)


BYPASSES = {
    "collecting_tracer": _tracer,
    "chaos_scope": _chaos,
    "cost_mode": _cost,
    "changed_shape": _shape,
    "changed_dtype": _dtype,
    "non_contiguous": _strided,
    "multi_leaf": _pytree,
    "words_as_a_list": _descriptor_list,
}
#: bypasses of the lowering alone, under a prepared dispatch
LOWERING_BYPASSES = {"cost_mode"}


@pytest.mark.parametrize("how", sorted(BYPASSES))
def test_each_bypass_takes_the_full_path(how):
    eng, words = request()
    x = payload("SCAN")
    eng.offload(words, x)
    eng.offload(words, x)  # prepared
    before = reuses()
    got = BYPASSES[how](eng, words, x)
    assert reuses() == before + (how in LOWERING_BYPASSES)
    before = reuses()
    fresh, fresh_words = request()
    assert_same(got, BYPASSES[how](fresh, fresh_words, x))
    # the bypass left the request's prepared dispatch as it was
    eng.offload(words, x)
    assert reuses() == before + 1


def test_driver_mode_takes_the_full_path():
    eng, words = request(axes=(P,))
    mesh = compat.Mesh((P,), ("i",), device="cpu")
    x = payload("SCAN")
    want = eng.offload(words, x, axis_name="i", mesh=mesh)
    before = reuses()
    for _ in range(2):
        got = eng.offload(words, x, axis_name="i", mesh=mesh)
    assert reuses() == before
    assert_same(got, want)
    assert eng.telemetry.hits == 2 and not eng._prepared


def test_a_changed_device_takes_the_full_path_and_raises_as_before():
    eng, words = request()
    x = payload("SCAN")
    eng.offload(words, x)
    eng.offload(words, x)
    meta = torch.empty((P, N), device="meta")
    with pytest.raises(ValueError, match="payload lives on meta") as got:
        eng.offload(words, meta)
    fresh, fresh_words = request()
    with pytest.raises(ValueError) as want:
        fresh.offload(fresh_words, meta)
    assert str(got.value) == str(want.value)


def test_clear_drops_the_memo():
    eng, words = request()
    x = payload("SCAN")
    eng.offload(words, x)
    eng.offload(words, x)
    assert eng._prepared
    eng.clear()
    assert not eng._prepared
    before, misses = reuses(), eng.telemetry.misses
    eng.offload(words, x)
    assert reuses() == before and eng.telemetry.misses == misses + 1
    eng.offload(words, x)
    assert reuses() == before + 1


def test_the_memo_is_bounded(monkeypatch):
    monkeypatch.setattr(engine_module, "PREPARED_MAX", 2)
    eng, _ = request()
    x = payload("SCAN")
    for nb in (4, 8, 16):
        words = eng.make_descriptor("SCAN", axes=(1, P), payload_bytes=nb * 4,
                                    backend="pallas", chunks=1).encode()
        eng.offload(words, x)
    assert len(eng._prepared) == 2


@pytest.mark.parametrize("bad", ["leading_axis", "no_payload"])
def test_a_malformed_payload_after_a_prepared_call_raises_as_before(bad):
    x = payload("SCAN")
    wrong = x[: P // 2] if bad == "leading_axis" else None

    def error(prepared):
        eng, words = request()
        eng.offload(words, x)
        if prepared:
            eng.offload(words, x)
        with pytest.raises(ValueError) as got:
            eng.offload(words, wrong)
        return str(got.value), eng.telemetry.snapshot()["errors"]

    assert error(prepared=True) == error(prepared=False)


def test_descriptor_objects_are_prepared_too():
    eng, words = request()
    from repro_torch.core.packet import CollectiveDescriptor

    desc = CollectiveDescriptor.decode(words)
    x = payload("SCAN")
    want = eng.offload(words, x)
    before = reuses()
    eng.offload(desc, x)
    got = eng.offload(desc, x)
    assert reuses() == before + 1
    assert_same(got, want)
