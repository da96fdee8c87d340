"""``repro_torch.offload.tuner`` against ``repro.offload.tuner``, on the CPU.

* ``autotune``, ``tune_splits`` and ``tune_schedule`` over tiny grids
  measure exactly the grid points the reference's measure (every coll,
  algorithm, axis order and (fused?, chunks, backend) variant); times are
  not compared (they are host times of two frameworks).
* ``backend="pallas"`` on a plan outside the fused kernel's envelope (every
  multi-axis plan, every chunked one) is skipped by ``tune_schedule`` and
  raises in ``time_planned_collective``: it is never timed as the default.
* ``inner > 1`` chains that many runs eagerly on the CPU, each run's
  output the next run's input.
* ``amortize_inner`` equals the reference's.
* With the same synthetic table activated in both packages,
  ``select_algorithm``, ``build_plan(...).describe()`` and
  ``make_descriptor(..., "auto")``'s words are identical over a grid of
  (coll, axes, payload). Exact equality throughout: no tolerance.
"""

import itertools

import pytest

from repro.core import selector as jsel
from repro.kernels import pallas_collective as jpc
from repro.offload import OffloadEngine as JEngine
from repro.offload import planner as jplanner
from repro.offload import tuner as jtuner
from repro.offload import tuning_cache as jtc
from repro_torch.core import selector as tsel
from repro_torch.core.operators import get_operator as t_op
from repro.core.operators import get_operator as j_op
from repro_torch.offload import OffloadEngine as TEngine
from repro_torch.offload import planner as tplanner
from repro_torch.offload import tuner as ttuner
from repro_torch.offload import tuning_cache as ttc
from test_torch_tuning_cache import fill, synthetic_rows

COLLS = ("scan", "exscan", "reduce", "allreduce", "barrier")


@pytest.fixture(autouse=True)
def _no_active_tuning():
    jsel.set_active_tuning(None)
    tsel.set_active_tuning(None)
    yield
    jsel.set_active_tuning(None)
    tsel.set_active_tuning(None)


def _keys(cache):
    return (
        sorted((m.coll, m.algo, m.p, m.payload_bytes)
               for m in cache.measurements),
        sorted((m.coll, m.sizes, m.order, m.payload_bytes)
               for m in cache.split_measurements),
        sorted((m.coll, m.sizes, m.optimized, m.chunks, m.backend,
                m.payload_bytes) for m in cache.fusion_measurements),
    )


def test_autotune_measures_the_reference_grid():
    kw = dict(ps=(3, 4), payloads=(64,), iters=1)
    got = ttuner.autotune(device="cpu", **kw)
    want = jtuner.autotune(**kw)
    assert _keys(got)[0] == _keys(want)[0]
    assert {m.coll for m in got.measurements} == set(COLLS)
    assert all(m.seconds > 0 for m in got.measurements)
    assert got.backend == ttc.device_fingerprint("cpu")
    assert got.fitted_model() is not None
    assert set(got.winners) == set(want.winners)


def test_tune_splits_measures_every_axis_order():
    kw = dict(topologies=((2, 2), (2, 1, 2)), payloads=(64, 256), iters=1)
    got = ttuner.tune_splits(device="cpu", **kw)
    want = jtuner.tune_splits(**kw)
    assert _keys(got)[1] == _keys(want)[1]
    assert len(got.split_measurements) == 2 * 2 * (2 + 6)
    assert set(got.split_winners) == set(want.split_winners)


def _reference_variants(topologies, payloads, colls, chunks, backends):
    """The (coll, sizes, optimized, chunks, backend, payload) rows the
    reference's tune_schedule records: a named backend only where its
    capability check passes."""
    from repro.offload import backends as jbackends

    rows = []
    for sizes, m, coll in itertools.product(topologies, payloads, colls):
        for opt, c, b in itertools.product((False, True), chunks, backends):
            if b:
                plan = jtuner._plan_for_variant(
                    coll, sizes, tuple(range(len(sizes))), m,
                    j_op("sum"), opt, c)
                if not jbackends.get_backend(b).capabilities(plan)[0]:
                    continue
            rows.append((coll, tuple(sizes), opt, c, b, m))
    return sorted(rows)


def test_tune_schedule_races_k1_only_where_it_can_run():
    grid = dict(topologies=((1, 4), (2, 2)), payloads=(64,),
                colls=("scan", "exscan"), chunks=(1, 2),
                backends=("", "pallas"))
    got = ttuner.tune_schedule(device="cpu", iters=1, **grid)
    assert _keys(got)[2] == _reference_variants(**grid)
    pallas = {(m.sizes, m.chunks) for m in got.fusion_measurements
              if m.backend == "pallas"}
    assert pallas == {((1, 4), 1)}  # one axis, unchunked: K1's envelope
    assert set(got.backend_winners) == {("scan", (1, 4), 64),
                                        ("exscan", (1, 4), 64)}
    assert ("scan", (2, 2), 64) in got.schedule_winners


def test_pallas_outside_its_envelope_is_never_timed_as_default():
    for sizes, chunks in (((2, 2), 1), ((1, 4), 2)):
        with pytest.raises(ValueError, match="not supported by the fused"):
            ttuner.time_planned_collective(
                "scan", sizes, tuple(range(len(sizes))), 64,
                chunking=chunks, backend="pallas", iters=1, device="cpu")
    # and the reference declines the same plans
    plan = jplanner.build_plan("SCAN", (2, 2), "sum", 64)
    assert not jpc.supports_plan(plan)[0]


@pytest.mark.parametrize("backend", ["", "pallas"])
def test_inner_runs_chain_eagerly_on_the_cpu(monkeypatch, backend):
    from repro_torch.offload import backends as tbackends

    calls = []

    def wrap(lower):
        def lowered(*a, **k):
            run = lower(*a, **k)

            def counted(x):
                out = run(x)
                calls.append((x, out))
                return out
            return counted
        return lowered

    if backend:
        fused = tbackends.get_backend("pallas")
        monkeypatch.setattr(type(fused), "lower", wrap(type(fused).lower))
    else:
        monkeypatch.setattr(tplanner, "lower_sim", wrap(tplanner.lower_sim))
    t = ttuner.time_planned_collective(
        "scan", (1, 4), (0, 1), 64, inner=4, iters=3, backend=backend,
        device="cpu")
    assert t > 0
    assert len(calls) == 4 * (1 + 3)  # the first chained run, then 3 samples
    for g in range(0, len(calls), 4):
        assert calls[g][0] is calls[0][0]  # every sample starts from x
        for k in range(g + 1, g + 4):
            assert calls[k][0] is calls[k - 1][1]


def test_amortize_inner_matches_reference():
    for m in (1, 64, 4096, 4097, 65536, 65537, 1 << 20, 1 << 30):
        for cap in (1, 2, 4, 16, 32):
            assert ttuner.amortize_inner(m, cap) == jtuner.amortize_inner(
                m, cap)
    assert ttuner.DEFAULT_PS == jtuner.DEFAULT_PS
    assert ttuner.DEFAULT_PAYLOADS == jtuner.DEFAULT_PAYLOADS
    assert ttuner.DEFAULT_COLLS == jtuner.DEFAULT_COLLS
    assert ttuner.DEFAULT_TOPOLOGIES == jtuner.DEFAULT_TOPOLOGIES
    assert ttuner.DEFAULT_CHUNKS == jtuner.DEFAULT_CHUNKS


def test_the_tuner_needs_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        assert ttuner.time_sim_collective("scan", "hillis_steele", 4, 64) > 0
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttuner.time_sim_collective("scan", "hillis_steele", 4, 64)


@pytest.mark.parametrize("seed", [0, 1])
def test_same_table_same_choices(seed):
    rows = synthetic_rows(seed)
    jtab = fill(jtc.TuningCache(), rows).activate()
    ttab = fill(ttc.TuningCache(device="cpu"), rows).activate()
    assert jsel.get_active_tuning() is jtab
    assert tsel.get_active_tuning() is ttab
    for p, m, coll, op in itertools.product(
            (2, 3, 4, 8, 16, 64), (4, 64, 1024, 1 << 20), COLLS,
            ("sum", "max", "prod")):
        assert tsel.select_algorithm(p, m, t_op(op), coll=coll) == (
            jsel.select_algorithm(p, m, j_op(op), coll=coll)), (p, m, coll)
    je, te = JEngine(), TEngine(device="cpu")
    for coll, axes, m in itertools.product(
            ("SCAN", "EXSCAN", "ALLREDUCE", "REDUCE", "BARRIER"),
            ((1, 8), (2, 4), (4, 2), (2, 2, 2), (2, 8)),
            (64, 1024, 65536, 1 << 20)):
        jp = jplanner.build_plan(coll, axes, "sum", m)
        tp = tplanner.build_plan(coll, axes, "sum", m)
        assert tp.describe() == jp.describe()
        dj = je.make_descriptor(coll, axes=axes, payload_bytes=m)
        dt = te.make_descriptor(coll, axes=axes, payload_bytes=m)
        assert dt.encode().tobytes() == dj.encode().tobytes(), (coll, axes, m)
    for coll, p, m in itertools.product(COLLS, (2, 8, 16), (4, 1 << 20)):
        dj = je.make_descriptor(coll.upper(), p=p, payload_bytes=m)
        dt = te.make_descriptor(coll.upper(), p=p, payload_bytes=m)
        assert dt.encode().tobytes() == dj.encode().tobytes()
