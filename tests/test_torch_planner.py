"""Parity of ``repro_torch.offload.planner`` / ``passes`` with
``repro.offload.planner`` / ``passes``: ``describe()`` text is identical for
every CollType x 1-3-axis mesh x axis order, raw and optimized; costs, the
tuned split and the schedule decisions agree; and ``lower_sim`` outputs are
bitwise equal over a sample of the ``tests/test_passes.py`` and
``tests/test_chunked.py`` cases (integer-valued float32 payloads, as there).
"""

import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import operators as j_ops
from repro.core.packet import CollType
from repro.offload import passes as j_passes
from repro.offload import planner as j_plan
from repro_torch.core import operators as t_ops
from repro_torch.offload import passes as t_passes
from repro_torch.offload import planner as t_plan
from test_torch_interop import assert_same, to_both

MESHES = [(8,), (2, 4), (4, 2), (2, 2), (3, 2), (2, 2, 2), (2, 3, 2), (1, 4),
          (2, 1, 2), (1, 8), (1, 1), (2, 8)]


def _build(mod, coll, sizes, order, *, root=0, optimize=False, payload=20,
           op="sum"):
    return mod.build_plan(coll, sizes, op, payload, order=order, root=root,
                          optimize=optimize)


@pytest.mark.parametrize("coll", [c.name for c in CollType])
@pytest.mark.parametrize("sizes", MESHES, ids=str)
def test_describe_identical_every_order(coll, sizes):
    p = int(np.prod(sizes))
    for order in itertools.permutations(range(len(sizes))):
        for optimize in (False, True):
            for root in sorted({0, p - 1}):
                jp = _build(j_plan, coll, sizes, order, root=root,
                            optimize=optimize)
                tp = _build(t_plan, coll, sizes, order, root=root,
                            optimize=optimize)
                assert tp.describe() == jp.describe()
                assert t_plan.plan_layout_moves(tp) == j_plan.plan_layout_moves(jp)
                assert t_plan.plan_cost(tp, 20) == j_plan.plan_cost(jp, 20)
                assert (t_passes.plan_comm_rounds(tp)
                        == j_passes.plan_comm_rounds(jp))


@pytest.mark.parametrize("coll", [c.name for c in CollType])
@pytest.mark.parametrize("payload", [4, 1024, 1 << 20, 16 << 20])
def test_auto_decisions_identical(coll, payload):
    for sizes in MESHES:
        for opname in ("sum", "max", "ssd"):
            assert (t_plan.plan_axis_order(coll, sizes, payload, opname)
                    == j_plan.plan_axis_order(coll, sizes, payload, opname))
            jp = j_plan.build_plan(coll, sizes, opname, payload)
            tp = t_plan.build_plan(coll, sizes, opname, payload)
            assert tp.describe() == jp.describe()
            if len(sizes) > 1:
                assert (t_passes.choose_schedule(coll, sizes, payload, opname)
                        == j_passes.choose_schedule(coll, sizes, payload, opname))
                assert (t_passes.choose_optimization(coll, sizes, payload, opname)
                        == j_passes.choose_optimization(coll, sizes, payload, opname))
                assert (t_passes.choose_backend(coll, sizes, payload, opname)
                        == j_passes.choose_backend(coll, sizes, payload, opname)
                        == "")
            for c in (1, 2, 4):
                jc = dataclasses.replace(jp, chunking=c)
                tc = dataclasses.replace(tp, chunking=c)
                assert t_plan.plan_cost(tc, payload) == j_plan.plan_cost(jc, payload)
                assert (t_passes.select_chunking(tc, payload).chunking
                        == j_passes.select_chunking(jc, payload).chunking)


def test_plan_layout_permutations_match():
    for sizes in [(2, 3), (2, 3, 4), (4, 2)]:
        for order in itertools.permutations(range(len(sizes))):
            jl = j_plan.PlanLayout(sizes=sizes, order=order)
            tl = t_plan.PlanLayout(sizes=sizes, order=order)
            np.testing.assert_array_equal(tl.permutation(), jl.permutation())
            x = np.arange(int(np.prod(sizes)) * 2, dtype=np.float32).reshape(-1, 2)
            jx, tx = to_both(x)
            assert_same(jl.to_physical(jx), tl.to_physical(tx))
            assert_same(jl.to_logical(jx), tl.to_logical(tx))


# a sample of the test_passes / test_chunked grid: (coll, sizes, order, root)
LOWER_CASES = [
    ("SCAN", (2, 4), (0, 1), 0),
    ("EXSCAN", (4, 2), (1, 0), 0),
    ("SCAN", (2, 2, 2), (2, 0, 1), 0),
    ("EXSCAN", (2, 3, 2), (0, 1, 2), 0),
    ("REDUCE", (2, 4), (1, 0), 5),
    ("REDUCE", (3, 2), (0, 1), 0),
    ("ALLREDUCE", (3, 2), (1, 0), 0),
    ("ALLREDUCE", (2, 2, 2), (0, 2, 1), 0),
    ("BARRIER", (2, 4), (0, 1), 0),
    ("SCAN", (1, 4), (0, 1), 0),
    ("EXSCAN", (2, 1, 2), (1, 2, 0), 0),
    ("SCAN", (8,), (0,), 0),
    ("EXSCAN", (2, 8), (1, 0), 0),
]


@pytest.mark.parametrize("case", LOWER_CASES, ids=str)
def test_lower_sim_bitwise(case):
    coll, sizes, order, root = case
    p = int(np.prod(sizes))
    x = np.random.default_rng(p + root).integers(-6, 7, (p, 5)).astype(np.float32)
    jx, tx = to_both(x)
    arg_j = None if coll == "BARRIER" else jx
    arg_t = None if coll == "BARRIER" else tx
    for optimize in (False, True):
        jp = _build(j_plan, coll, sizes, order, root=root, optimize=optimize)
        tp = _build(t_plan, coll, sizes, order, root=root, optimize=optimize)
        want = j_plan.lower_sim(jp)(arg_j)
        assert_same(want, t_plan.lower_sim(tp, device="cpu")(arg_t))
        if coll in ("SCAN", "EXSCAN"):
            # 3 chunks of a 5-wide payload: a ragged split
            jc = dataclasses.replace(jp, chunking=3)
            tc = dataclasses.replace(tp, chunking=3)
            assert_same(j_plan.lower_sim(jc)(arg_j),
                        t_plan.lower_sim(tc, device="cpu")(arg_t))


@pytest.mark.parametrize("coll", ["SCAN", "EXSCAN"])
@pytest.mark.parametrize("opname", ["ssd", "flash"])
def test_lower_sim_pytree_ops(coll, opname):
    """SSD (non-commutative) and flash (the exp rescale) through 2-axis
    plans, raw and optimized. Values are chosen as in test_passes: ssd with
    power-of-two decays and integer states, flash with one shared running
    max, so both are exact and compared bitwise."""
    sizes = (2, 4)
    p = 8
    rng = np.random.default_rng(11)
    if opname == "ssd":
        x = (rng.choice([0.5, 1.0, 2.0], size=(p, 4)).astype(np.float32),
             rng.integers(-4, 5, size=(p, 4)).astype(np.float32))
    else:
        x = (np.full((p, 4), 1.0, np.float32),
             rng.integers(1, 6, size=(p, 4)).astype(np.float32),
             rng.integers(-5, 6, size=(p, 4)).astype(np.float32))
    jx, tx = to_both(x)
    for optimize in (False, True):
        jp = j_plan.build_plan(coll, sizes, opname, 32, optimize=optimize)
        tp = t_plan.build_plan(coll, sizes, opname, 32, optimize=optimize)
        assert tp.describe() == jp.describe()
        assert_same(j_plan.lower_sim(jp, j_ops.get_operator(opname))(jx),
                    t_plan.lower_sim(tp, t_ops.get_operator(opname),
                                     device="cpu")(tx))


def test_lower_sim_rejects_payload_on_other_device():
    tp = t_plan.build_plan("SCAN", (2, 4), "sum", 16)
    _, tx = to_both(np.ones((8, 4), np.float32))
    with pytest.raises(ValueError, match="lives on cpu"):
        t_plan.lower_sim(tp, device="meta")(tx)
