"""``repro_torch.runtime.chaos`` (with ``runtime.fault`` and
``runtime.straggler``) against ``repro.runtime``, and the engine's chaos
route.

* One seed gives the same ``FaultDecision`` stream in both packages, rate
  schedules and link filters included; the counts agree.
* ``_flip_row_bit`` flips the reference's bit in every wire dtype (bit 31
  and bit 63 through the signed views), and ``ChaosBackend`` over the sim
  backend delivers the reference's rows under silent drop, duplicate,
  reorder and corrupt faults. Integer payloads: bitwise, no tolerance.
* ``SimBackend`` takes duplicate and reversed pairs eagerly and keeps one
  index-cache entry for a permutation however its pairs come.
* A planned dispatch under a chaos scope runs the traced lowering under
  the ``|traced`` key: the interpreter, with chaos innermost, for the
  default backend; K1's wrapper, free of faults, for ``backend="pallas"``
  (as the reference's Pallas lowering runs its kernel). Single-axis
  dispatches keep their schedule; the untraced lowering never reads the
  injector.
* ``FailureInjector``, ``is_recoverable`` (the port's error family: torch
  distributed errors, never an OOM) and ``StragglerDetector`` against the
  reference.
* ``python -m repro_torch.testing.chaos_check --device cpu`` prints ALL-OK.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.runtime import chaos as jchaos
from repro.runtime import fault as jfault
from repro.runtime import straggler as jstraggler
from repro_torch.core import algorithms as talg
from repro_torch.core.packet import CollType, CollectiveDescriptor, WireDType
from repro_torch.kernels import fused_collective as fc
from repro_torch.offload import OffloadEngine as TEngine
from repro_torch.offload import planner as tplanner
from repro_torch.runtime import chaos as tchaos
from repro_torch.runtime import fault as tfault
from repro_torch.runtime import straggler as tstraggler
from test_torch_interop import BF16, assert_same, to_both

LINKS = [(lv, s, d) for lv in (0, 1) for s in range(4) for d in range(4)]


def _stream(mod, seed, **rates):
    inj = mod.ChaosInjector(seed, **rates)
    out = [dataclasses.asdict(inj.decide(*k)) for k in LINKS * 3]
    return out, inj.faults_injected(), dict(inj.counts), inj.messages


@pytest.mark.parametrize("seed", [0, 7, 20140409])
@pytest.mark.parametrize("rates", [
    dict(drop=0.3, corrupt=0.2),
    dict(duplicate=0.5, reorder=0.5, delay=0.25, delay_s=0.0),
    dict(drop=0.1, duplicate=0.1, reorder=0.1, corrupt=0.1, delay=0.0),
])
def test_fault_decision_streams_match(seed, rates):
    assert _stream(tchaos, seed, **rates) == _stream(jchaos, seed, **rates)


def test_schedules_and_link_filters_match():
    def run(mod):
        inj = mod.ChaosInjector(
            3,
            drop=mod.RateSchedule.burst(1.0, 10),
            corrupt=mod.RateSchedule.steps([(5, 0.0), (40, 0.5)]),
            links=[(0, 0, 1), (1, 2, 3)],
        )
        return [dataclasses.asdict(inj.decide(*k)) for k in LINKS * 2], \
            inj.counts
    assert run(tchaos) == run(jchaos)


@pytest.mark.parametrize("dtype", [np.int32, np.float32, BF16, np.float16,
                                   np.int8])
@pytest.mark.parametrize("bit", [0, 7, 15, 31, 63])
def test_flip_row_bit_matches(dtype, bit):
    x = np.arange(12, dtype=np.float32).reshape(3, 4).astype(dtype)
    jx, tx = to_both(x)
    for dst in (0, 2):
        assert_same(jchaos._flip_row_bit(jx, dst, bit),
                    tchaos._flip_row_bit(tx, dst, bit))
    # the input is left alone
    assert_same(jx, tx)


@pytest.mark.parametrize("faults", [
    dict(drop=0.3, silent=True),
    dict(duplicate=0.6, reorder=0.6),
    dict(corrupt=0.4, silent=True),
    dict(drop=0.2, duplicate=0.3, reorder=0.3, corrupt=0.3, silent=True),
])
def test_chaos_backend_delivers_the_references_rows(faults):
    from repro.core import algorithms as jalg

    p = 8
    x = np.random.default_rng(5).integers(-99, 99, (p, 6)).astype(np.int32)
    jx, tx = to_both(x)
    perms = [[(i, i + 1) for i in range(p - 1)],
             [(i, i ^ 2) for i in range(p)],
             [(i, i - 4) for i in range(4, p)],
             [(p - 1, 0)]]
    jb = jchaos.ChaosBackend(jalg.SimBackend(p),
                             jchaos.ChaosInjector(11, **faults), level=1)
    tb = tchaos.ChaosBackend(talg.SimBackend(p, "cpu"),
                             tchaos.ChaosInjector(11, **faults), level=1)
    for _ in range(4):
        for perm in perms:
            assert_same(jb.permute((jx, jx * 2), perm),
                        tb.permute((tx, tx * 2), perm), what=str(perm))
    assert tb.injector.counts == jb.injector.counts
    assert tb.injector.faults_injected() > 0


def test_non_silent_faults_raise_the_references_errors():
    from repro.core import algorithms as jalg
    from repro.core.packet import IntegrityError as JIntegrity
    from repro_torch.core.packet import IntegrityError as TIntegrity

    def first_error(mod, backend, x, integrity):
        b = mod.ChaosBackend(backend, mod.ChaosInjector(2, drop=0.2,
                                                        corrupt=0.3))
        kinds = []
        for _ in range(12):
            try:
                b.permute(x, [(i, i + 1) for i in range(3)])
                kinds.append("ok")
            except mod.TransportError:
                kinds.append("drop")
            except integrity:
                kinds.append("corrupt")
        return kinds

    jx, tx = to_both(np.ones((4, 2), np.int32))
    want = first_error(jchaos, jalg.SimBackend(4), jx, JIntegrity)
    assert first_error(tchaos, talg.SimBackend(4, "cpu"), tx,
                       TIntegrity) == want
    assert {"drop", "corrupt", "ok"} <= set(want)


def test_sim_backend_takes_duplicate_and_reversed_pairs():
    b = talg.SimBackend(6, "cpu")
    x = torch.arange(12).reshape(6, 2)
    perm = [(0, 3), (3, 5), (5, 0)]
    want = b.permute(x, perm)
    assert len(b._indices) == 1
    for variant in (perm[::-1], perm + perm[:1], (perm + perm)[::-1]):
        assert torch.equal(b.permute(x, variant), want)
    assert len(b._indices) == 1
    shift = [(i, i + 2) for i in range(4)]
    assert torch.equal(b.permute(x, shift[::-1] + shift[:2]),
                       b.permute(x, shift))
    assert len(b._indices) == 1  # a shift is a slice copy, never indexed
    for k in range(b.MAX_CACHED_PERMS + 20):
        b.permute(x, [(k % 6, (k + 1 + k // 6) % 6)])
    assert len(b._indices) <= b.MAX_CACHED_PERMS


def test_scope_installs_and_restores():
    assert tchaos.get_injector() is None and not tchaos.active()
    outer, inner = tchaos.ChaosInjector(1), tchaos.ChaosInjector(2)
    with outer.scope():
        with inner.scope():
            assert tchaos.get_injector() is inner
        assert tchaos.get_injector() is outer and tchaos.active()
    assert tchaos.get_injector() is None


def _int_desc(axes, coll=CollType.SCAN, backend=""):
    p = int(np.prod(axes))
    return CollectiveDescriptor(comm_size=p, axes=axes if len(axes) > 1
                                else (), coll_type=coll, count=16,
                                data_type=WireDType.INT32, backend=backend)


@pytest.mark.parametrize("axes,backend", [((2, 4), ""), ((1, 8), "pallas")])
def test_chaos_scope_routes_planned_dispatches_to_the_interpreter(
        axes, backend, monkeypatch):
    eng = TEngine(device="cpu")
    desc = _int_desc(axes, backend=backend)
    x = torch.arange(8 * 16, dtype=torch.int32).reshape(8, 16)
    clean = eng.offload(desc, x)
    calls = []
    real = fc.comm_phase
    monkeypatch.setattr(fc, "comm_phase",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    clean_again = eng.offload(desc, x)
    assert torch.equal(clean_again, clean)
    calls_clean = len(calls)
    inj = tchaos.ChaosInjector(4, drop=0.5)
    with inj.scope():
        errors = 0
        for _ in range(6):
            try:
                assert torch.equal(eng.offload(desc, x), clean)
            except tchaos.TransportError:
                errors += 1
    assert any(k.endswith(b"|traced") for k in eng._cache)
    if backend == "pallas":
        # the fused lowering runs K1 under the scope, which fails nothing
        assert len(calls) > calls_clean > 0
        assert inj.messages == 0 and errors == 0
    else:
        assert inj.faults_injected() > 0 and errors > 0
        assert len(calls) == calls_clean == 0
    assert eng.telemetry.backend_fallbacks == 0
    # outside the scope the cached schedule runs again
    assert torch.equal(eng.offload(desc, x), clean)


def test_single_axis_dispatches_ignore_the_scope():
    eng = TEngine(device="cpu")
    desc = _int_desc((8,))
    x = torch.ones((8, 16), dtype=torch.int32)
    want = eng.offload(desc, x)
    inj = tchaos.ChaosInjector(4, drop=1.0)
    with inj.scope():
        assert torch.equal(eng.offload(desc, x), want)
    assert inj.messages == 0


def test_untraced_lowering_never_reads_the_injector():
    plan = tplanner.build_plan(CollType.SCAN, (2, 4), "sum", 12)
    x = torch.arange(8 * 3, dtype=torch.int32).reshape(8, 3)
    untraced = tplanner.lower_sim(plan, device="cpu")
    traced = tplanner.lower_sim(plan, device="cpu", traced=True)
    inj = tchaos.ChaosInjector(0, drop=1.0)
    with inj.scope():
        want = untraced(x)
        assert inj.messages == 0
        with pytest.raises(tchaos.TransportError):
            traced(x)
    assert torch.equal(traced(x), want)


def test_failure_injector_dispatch_mode_matches():
    def run(mod):
        inj = mod.FailureInjector(rate=0.3, seed=9)
        out = []
        for _ in range(40):
            try:
                inj.check_dispatch()
                out.append(0)
            except mod.SimulatedFailure:
                out.append(1)
        return out

    assert run(tfault) == run(jfault)
    assert sum(run(tfault)) > 0


def test_is_recoverable_uses_the_torch_error_family():
    from repro_torch.core.packet import IntegrityError
    from repro_torch.offload.reliability import (CircuitOpenError,
                                                 RetryExhaustedError)

    dist = torch.distributed
    assert tfault.is_recoverable(tfault.SimulatedFailure("host lost"))
    assert tfault.is_recoverable(dist.DistBackendError("NCCL timeout"))
    assert tfault.is_recoverable(dist.DistNetworkError("peer reset"))
    assert not tfault.is_recoverable(
        dist.DistBackendError("wrapped TransportError: dropped"))
    assert not tfault.is_recoverable(
        dist.DistError("RESOURCE_EXHAUSTED: out of memory"))
    assert not tfault.is_recoverable(torch.OutOfMemoryError("CUDA OOM"))
    assert not tfault.is_recoverable(RuntimeError("nvcc failed"))
    assert not tfault.is_recoverable(IntegrityError("bad crc"))
    assert not tfault.is_recoverable(tchaos.TransportError("lost"))
    assert not tfault.is_recoverable(RetryExhaustedError("gave up"))
    assert not tfault.is_recoverable(CircuitOpenError("open"))
    assert tfault.RECOVERABLE_ERRORS == (tfault.SimulatedFailure,
                                         dist.DistError)


def test_plan_remesh_and_rescale_match():
    for args in [(8, 2, 1), (8, 2, 3), (4, 1, 4), (16, 4, 2, 2)]:
        assert tfault.plan_remesh(*args) == jfault.plan_remesh(*args)
    assert tfault.rescale_batch(256, 8, 4) == jfault.rescale_batch(256, 8, 4)


def test_straggler_detector_matches():
    dts = [1.0, 1.1, 0.9, 1.0, 1.05, 5.0, 5.0, 1.0, 6, 6, 6, 6, 6, 6, 1.0]

    def run(mod):
        det = mod.StragglerDetector(evict_after=3)
        return [det.observe(i, dt) for i, dt in enumerate(dts)], \
            list(det.events)

    assert run(tstraggler) == run(jstraggler)


def test_chaos_check_prints_all_ok(subprocess_runner):
    out = subprocess_runner("repro_torch.testing.chaos_check", "2", "4",
                            "--device", "cpu")
    assert "quarantine_ok,1,breaker_ok,1,healthz_ok,1" in out
