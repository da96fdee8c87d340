"""``repro_torch.offload.tuning_cache`` against ``repro.offload.tuning_cache``.

The same seeded synthetic measurements (all four record kinds: algorithm,
split, fusion and schedule-with-backend rows) go into both packages'
``TuningCache``. Every winner reduction and every nearest-point lookup, on
and off the grid, is equal; the fitted LinkModel agrees to rel 1e-12 (both
solve the same float64 least squares); ``to_json()`` is equal except for
the ``backend`` fingerprint. Tables never cross packages: ``merge`` raises
and ``load_compatible`` of the other package's file warns and returns
``None``, in both directions, the reference's functions called unchanged.
"""

import itertools
import math

import numpy as np
import pytest

from repro.core.selector import set_active_tuning as j_set_tuning
from repro.offload import tuning_cache as jtc
from repro_torch.core.selector import get_active_tuning as t_get_tuning
from repro_torch.core.selector import set_active_tuning as t_set_tuning
from repro_torch.offload import tuning_cache as ttc

FIT_RTOL = 1e-12

COLLS = ("scan", "exscan", "reduce", "allreduce", "barrier")
ALGOS = ("binomial_tree", "hillis_steele", "recursive_doubling",
         "sequential", "sklansky")
PS = (2, 4, 8, 16)
PAYLOADS = (64, 1024, 65536)
TOPOLOGIES = ((2, 4), (4, 2), (2, 2, 2))


@pytest.fixture(autouse=True)
def _no_active_tuning():
    j_set_tuning(None)
    t_set_tuning(None)
    yield
    j_set_tuning(None)
    t_set_tuning(None)


def synthetic_rows(seed=0):
    """Seeded rows of all four kinds; repeated keys on purpose (ties and
    re-measurements exercise the winner rules)."""
    rng = np.random.default_rng(seed)
    rows = []
    for coll, algo, p, m in itertools.product(COLLS, ALGOS, PS, PAYLOADS):
        t = 1e-6 * (p * (1 + rng.random()) + m / 1e4)
        rows.append(("record", coll, algo, p, m, float(t)))
    # an exact tie: the lexicographically first algorithm must win
    rows.append(("record", "scan", "sklansky", 4, 64, 1e-9))
    rows.append(("record", "scan", "hillis_steele", 4, 64, 1e-9))
    for sizes in TOPOLOGIES:
        for order in itertools.permutations(range(len(sizes))):
            for coll, m in itertools.product(("scan", "allreduce"), PAYLOADS):
                rows.append(("split", coll, sizes, order, m,
                             float(1e-6 * (1 + rng.random()))))
        for coll, m, opt in itertools.product(("scan", "exscan"), PAYLOADS,
                                              (False, True)):
            rows.append(("fusion", coll, sizes, opt, m,
                         float(1e-6 * (1 + rng.random()))))
    for sizes in ((1, 8), (2, 4)):
        for coll, m, opt, c, b in itertools.product(
                ("scan", "exscan"), PAYLOADS, (False, True), (1, 2, 4),
                ("", "pallas")):
            rows.append(("schedule", coll, sizes, opt, c, m,
                         float(1e-6 * (1 + rng.random())), b))
    return rows


def fill(cache, rows):
    for row in rows:
        kind, args = row[0], row[1:]
        if kind == "record":
            cache.record(*args)
        elif kind == "split":
            cache.record_split(*args)
        elif kind == "fusion":
            cache.record_fusion(*args)
        else:
            coll, sizes, opt, c, m, t, b = args
            cache.record_schedule(coll, sizes, opt, c, m, t, backend=b)
    return cache


def both(seed=0):
    rows = synthetic_rows(seed)
    return (fill(jtc.TuningCache(), rows),
            fill(ttc.TuningCache(device="cpu"), rows))


def queries():
    """On-grid points and off-grid ones (between, beyond, far away)."""
    qs = [(p, m) for p in PS for m in PAYLOADS]
    qs += [(3, 100), (6, 3000), (12, 40000), (32, 1 << 20), (1, 1),
           (1024, 64), (2, 1 << 30)]
    return qs


def test_fingerprints_never_match_across_packages():
    j, t = both()
    assert t.backend == ttc.device_fingerprint("cpu")
    assert t.backend.startswith("torch-cpu:")
    assert j.backend != t.backend
    assert not j.backend.startswith("torch-")


def test_every_winner_reduction_is_equal():
    j, t = both()
    assert t.winners == j.winners
    assert t.split_winners == j.split_winners
    assert t.schedule_winners == j.schedule_winners
    assert t.backend_winners == j.backend_winners
    assert t.fusion_winners == j.fusion_winners
    # the tie went to the lexicographically first algorithm in both
    assert t.winners[("scan", 4, 64)] == "hillis_steele"


def test_lookups_on_and_off_the_grid_are_equal():
    j, t = both(1)
    hits = misses = 0
    for (p, m), coll in itertools.product(queries(), COLLS):
        got, want = t.lookup(p, m, coll), j.lookup(p, m, coll)
        assert got == want, (p, m, coll)
        hits += want is not None
        misses += want is None
    assert hits and misses
    for sizes, m, coll in itertools.product(
            TOPOLOGIES + ((1, 8), (4, 4)), (1, 64, 5000, 1 << 20, 1 << 40),
            ("scan", "exscan", "allreduce", "reduce")):
        assert t.split_winner(coll, sizes, m) == j.split_winner(coll, sizes, m)
        assert t.schedule_winner(coll, sizes, m) == j.schedule_winner(
            coll, sizes, m)
        assert t.fusion_winner(coll, sizes, m) == j.fusion_winner(
            coll, sizes, m)
        assert t.backend_winner(coll, sizes, m) == j.backend_winner(
            coll, sizes, m)


def test_fitted_model_agrees():
    j, t = both(2)
    jf, tf = j.fitted_model(), t.fitted_model()
    assert jf is not None and tf is not None
    for a in ("alpha", "beta", "gamma"):
        assert math.isclose(getattr(tf, a), getattr(jf, a), rel_tol=FIT_RTOL)
    assert tf.ring == jf.ring
    # too few scan rows: no fit in either
    jc, tc = jtc.TuningCache(), ttc.TuningCache(device="cpu")
    for c in (jc, tc):
        c.record("scan", "hillis_steele", 4, 64, 1e-6)
        c.record("reduce", "hillis_steele", 8, 64, 1e-6)
    assert jc.fitted_model() is None and tc.fitted_model() is None


def test_to_json_equal_except_backend():
    j, t = both(3)
    jd, td = j.to_json(), t.to_json()
    assert td["schema_version"] == jd["schema_version"] == 1
    assert td.pop("backend") != jd.pop("backend")
    assert set(td) == set(jd)
    for key in td:
        if key == "fitted":
            for a in ("alpha", "beta", "gamma"):
                assert math.isclose(td[key][a], jd[key][a], rel_tol=FIT_RTOL)
            assert td[key]["ring"] == jd[key]["ring"]
        else:
            assert td[key] == jd[key], key


def test_merge_keeps_the_faster_sample_like_the_reference():
    rows_a, rows_b = synthetic_rows(4), synthetic_rows(5)
    j = fill(jtc.TuningCache(), rows_a).merge(fill(jtc.TuningCache(), rows_b))
    t = fill(ttc.TuningCache(device="cpu"), rows_a).merge(
        fill(ttc.TuningCache(device="cpu"), rows_b))
    assert t.to_json()["measurements"] == j.to_json()["measurements"]
    assert t.split_winners == j.split_winners
    assert t.schedule_winners == j.schedule_winners
    assert t.backend_winners == j.backend_winners


def test_merge_across_packages_raises_both_ways():
    j, t = both()
    with pytest.raises(ValueError, match="across backends"):
        t.merge(j)
    with pytest.raises(ValueError, match="across backends"):
        j.merge(t)
    # a port table from another device does not merge either
    other = ttc.TuningCache(backend="torch-cuda:NVIDIA H100 80GB HBM3:sm_90:x")
    with pytest.raises(ValueError, match="across backends"):
        t.merge(other)


def test_load_compatible_refuses_the_other_packages_file(tmp_path):
    j, t = both()
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    j.save(jpath)
    t.save(tpath)
    with pytest.warns(RuntimeWarning, match="measured on backend"):
        assert ttc.TuningCache.load_compatible(jpath, device="cpu") is None
    with pytest.warns(RuntimeWarning, match="measured on backend"):
        assert jtc.TuningCache.load_compatible(tpath) is None
    # each package takes its own table back, with the same winners
    t2 = ttc.TuningCache.load_compatible(tpath, device="cpu")
    assert t2 is not None and t2.backend == t.backend
    assert t2.winners == t.winners
    assert t2.schedule_winners == t.schedule_winners
    assert t2.backend_winners == t.backend_winners
    assert t2.split_winners == t.split_winners
    # load() stays strict only on the schema, as the reference's
    assert ttc.TuningCache.load(jpath).winners == j.winners


def test_env_var_is_the_ports_own(tmp_path, monkeypatch):
    assert ttc.TUNING_TABLE_ENV == "REPRO_TORCH_TUNING_TABLE"
    assert ttc.TUNING_TABLE_ENV != jtc.TUNING_TABLE_ENV
    j, t = both()
    tpath, jpath = tmp_path / "t.json", tmp_path / "j.json"
    t.save(tpath)
    j.save(jpath)
    monkeypatch.setenv(ttc.TUNING_TABLE_ENV, str(tpath))
    loaded = ttc.load_default_table(device="cpu")
    assert loaded is not None and t_get_tuning() is loaded
    ttc.deactivate()
    assert t_get_tuning() is None
    monkeypatch.setenv(ttc.TUNING_TABLE_ENV, str(jpath))
    with pytest.warns(RuntimeWarning):
        assert ttc.load_default_table(device="cpu") is None
    assert t_get_tuning() is None


def test_cuda_fingerprint_needs_a_card():
    import torch

    if torch.cuda.is_available():
        fp = ttc.device_fingerprint("cuda")
        assert fp.startswith("torch-cuda:") and ":sm_" in fp
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ttc.TuningCache()
