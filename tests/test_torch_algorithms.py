"""Parity of ``repro_torch.core`` schedules with ``repro.core``: ``sim_scan``
(paired with ``repro.core.scan_collective.sim_scan`` over
``repro.core.algorithms.ALGORITHMS``) for every algorithm x p in {1..9, 16}
x inclusive/exclusive x {sum, max, ssd, segmented sum}, plus the
``reduce_ops`` sim entry points and the fused scan+total schedule.

Tolerances: sum and max on int32 and float32 and the segmented sum are
bitwise (the schedules combine elementwise in the same order). ssd multiplies
and adds in float32; it is held at rtol = atol = 1e-5, since XLA may
contract ``a*b + c`` where PyTorch's eager CPU ops do not.
"""

import numpy as np
import pytest
import torch

from repro.core import algorithms as j_alg
from repro.core import operators as j_ops
from repro.core import reduce_ops as j_red
from repro.core.scan_collective import sim_scan as j_sim_scan
from repro_torch.core import algorithms as t_alg
from repro_torch.core import operators as t_ops
from repro_torch.core import reduce_ops as t_red
from repro_torch.core.scan_collective import sim_scan as t_sim_scan
from test_torch_interop import assert_same, to_both

PS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 16)
SSD_TOL = dict(rtol=1e-5, atol=1e-5)


def _ops(name):
    if name == "segmented_sum":
        return (j_ops.segmented_operator(j_ops.SUM),
                t_ops.segmented_operator(t_ops.SUM))
    return j_ops.get_operator(name), t_ops.get_operator(name)


def _inputs(name, p, seed):
    """numpy payloads of one operator; one per dtype the test covers. One
    payload width throughout keeps JAX's eager per-shape compiles few."""
    rng = np.random.default_rng(seed)
    if name in ("sum", "max"):
        return [
            rng.integers(-1000, 1000, size=(p, 3)).astype(np.int32),
            rng.standard_normal((p, 3)).astype(np.float32),
        ]
    if name == "ssd":
        return [(
            rng.uniform(0.5, 1.5, size=(p, 3)).astype(np.float32),
            rng.standard_normal((p, 3)).astype(np.float32),
        )]
    flags = (rng.random(p) < 0.3).astype(np.float32)
    return [(rng.standard_normal((p, 3)).astype(np.float32), flags)]


@pytest.mark.parametrize("algo", sorted(j_alg.ALGORITHMS))
@pytest.mark.parametrize("opname", ["sum", "max", "ssd", "segmented_sum"])
def test_sim_scan_matches_reference(algo, opname):
    j_op, t_op = _ops(opname)
    tol = SSD_TOL if opname == "ssd" else {}
    for p in PS:
        for inclusive in (True, False):
            for x in _inputs(opname, p, seed=p * 7 + inclusive):
                jx, tx = to_both(x)
                what = f"{algo} {opname} p={p} inclusive={inclusive}"
                needs_inverse = algo == "invertible_doubling" and (
                    j_op.inverse is None
                )
                if needs_inverse and (inclusive or p > 1):
                    with pytest.raises(ValueError):
                        j_sim_scan(jx, j_op, p, algorithm=algo,
                                   inclusive=inclusive)
                    with pytest.raises(ValueError):
                        t_sim_scan(tx, t_op, p, algorithm=algo,
                                   inclusive=inclusive)
                    continue
                want = j_sim_scan(jx, j_op, p, algorithm=algo,
                                  inclusive=inclusive)
                got = t_sim_scan(tx, t_op, p, algorithm=algo,
                                 inclusive=inclusive)
                assert_same(want, got, what=what, **tol)


@pytest.mark.parametrize("p", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("opname", ["sum", "max", "ssd"])
def test_reduce_allreduce_barrier_match_reference(p, opname):
    j_op, t_op = _ops(opname)
    tol = SSD_TOL if opname == "ssd" else {}
    for x in _inputs(opname, p, seed=p):
        jx, tx = to_both(x)
        for root in sorted({0, p - 1, p // 2}):
            assert_same(
                j_red.sim_reduce(jx, j_op, p, root=root),
                t_red.sim_reduce(tx, t_op, p, root=root),
                what=f"reduce root={root}", **tol,
            )
        for algo in ("recursive_doubling", "hillis_steele", "binomial_tree"):
            assert_same(
                j_red.sim_allreduce(jx, j_op, p, algorithm=algo),
                t_red.sim_allreduce(tx, t_op, p, algorithm=algo),
                what=f"allreduce {algo}", **tol,
            )
    assert_same(j_red.sim_barrier(p), t_red.sim_barrier(p, device="cpu"))


@pytest.mark.parametrize("opname", ["sum", "max", "ssd", "segmented_sum"])
def test_scan_total_schedule_matches_reference(opname):
    j_op, t_op = _ops(opname)
    tol = SSD_TOL if opname == "ssd" else {}
    for p in PS:
        for inclusive in (True, False):
            for x in _inputs(opname, p, seed=100 + p):
                jx, tx = to_both(x)
                want = j_alg.scan_total_schedule(
                    j_alg.SimBackend(p), jx, j_op, inclusive=inclusive
                )
                got = t_alg.scan_total_schedule(
                    t_alg.SimBackend(p, "cpu"), tx, t_op, inclusive=inclusive
                )
                assert_same(want, got, what=f"p={p} incl={inclusive}", **tol)


@pytest.mark.parametrize("chunks", [2, 3, 4])
def test_chunked_schedules_match_reference(chunks):
    for p in (2, 5, 8):
        for opname in ("sum", "max"):
            j_op, t_op = _ops(opname)
            x = np.random.default_rng(p).integers(-9, 9, (p, 10)).astype(np.float32)
            jx, tx = to_both(x)
            jb, tb = j_alg.SimBackend(p), t_alg.SimBackend(p, "cpu")
            assert_same(
                j_alg.chunked_scan_schedule(jb, jx, j_op, chunks=chunks),
                t_alg.chunked_scan_schedule(tb, tx, t_op, chunks=chunks),
            )
            for inclusive in (True, False):
                assert_same(
                    j_alg.chunked_scan_total_schedule(
                        jb, jx, j_op, chunks=chunks, inclusive=inclusive),
                    t_alg.chunked_scan_total_schedule(
                        tb, tx, t_op, chunks=chunks, inclusive=inclusive),
                )


def test_step_counts_and_shift_recognition_match():
    for p in range(1, 20):
        for name in j_alg.ALGORITHMS:
            assert (t_alg.algorithm_step_count(name, p)
                    == j_alg.algorithm_step_count(name, p))
        for kind in ("SCAN", "FUSED_SCAN_TOTAL", "TOTAL", "BARRIER", "REDUCE"):
            for inclusive in (True, False):
                assert (t_alg.phase_round_count(kind, p, inclusive=inclusive)
                        == j_alg.phase_round_count(kind, p, inclusive=inclusive))
        for d in range(-p, p + 1):
            perm = ([(i, i + d) for i in range(p - d)] if d >= 0
                    else [(i, i + d) for i in range(-d, p)])
            assert (t_alg.as_contiguous_shift(perm, p)
                    == j_alg.as_contiguous_shift(perm, p))
    assert t_alg.chunk_bounds(13, 4) == j_alg.chunk_bounds(13, 4)


def test_sim_backend_permute_multicast_matches():
    p = 8
    x = np.arange(p * 3, dtype=np.float32).reshape(p, 3)
    jx, tx = to_both(x)
    perm = [(3, 4), (3, 5), (3, 6), (3, 7), (1, 2)]
    assert_same(j_alg.SimBackend(p).permute(jx, perm),
                t_alg.SimBackend(p, "cpu").permute(tx, perm))
    assert_same(j_alg.SimBackend(p).permute(jx, []),
                t_alg.SimBackend(p, "cpu").permute(tx, []))


def test_operator_flags_match_reference():
    for name in ("sum", "prod", "max", "min", "ssd", "flash"):
        j, t = j_ops.get_operator(name), t_ops.get_operator(name)
        assert (t.name, t.commutative, t.zero_identity, t.inverse is None) == (
            j.name, j.commutative, j.zero_identity, j.inverse is None)
    seg_j = j_ops.segmented_operator(j_ops.SUM)
    seg_t = t_ops.segmented_operator(t_ops.SUM)
    assert (seg_t.name, seg_t.zero_identity, seg_t.commutative) == (
        seg_j.name, seg_j.zero_identity, seg_j.commutative)
    # only SUM is zero_identity: the fused kernel's scan envelope rests on it
    assert [n for n in t_ops._REGISTRY if t_ops._REGISTRY[n].zero_identity] == ["sum"]


@pytest.mark.parametrize("name", ["sum", "prod", "max", "min", "flash"])
def test_identities_and_combines_match(name):
    j, t = j_ops.get_operator(name), t_ops.get_operator(name)
    rng = np.random.default_rng(5)
    if name == "flash":
        x = tuple(rng.standard_normal((4, 3)).astype(np.float32) for _ in range(3))
        y = tuple(rng.standard_normal((4, 3)).astype(np.float32) for _ in range(3))
        tol = dict(rtol=1e-6, atol=1e-6)  # exp in two libraries
    else:
        x = rng.standard_normal((4, 3)).astype(np.float32)
        y = rng.standard_normal((4, 3)).astype(np.float32)
        tol = {}
    (jx, tx), (jy, ty) = to_both(x), to_both(y)
    assert_same(j.identity_like(jx), t.identity_like(tx))
    assert_same(j.combine(jx, jy), t.combine(tx, ty), **tol)
    for dt in (np.int32, np.int8):
        xi = np.arange(-6, 6, dtype=dt).reshape(4, 3)
        if name != "flash":
            ji, ti = to_both(xi)
            assert_same(j.identity_like(ji), t.identity_like(ti))
            assert_same(j.combine(ji, ji), t.combine(ti, ti))
    assert torch.is_tensor(t.identity_like(tx) if name != "flash" else tx[0])
