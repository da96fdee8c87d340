"""Parity of ``repro_torch.kernels.fused_collective`` (K1) with
``repro.kernels.pallas_collective``.

The CUDA kernel runs only on a GPU (``chip_smoke.py`` holds it against the
plain version there); here the plain version — what the wrapper runs for a
CPU tensor — is held against the reference kernel, ``_sim_comm_kernel``, run
in Pallas interpret mode as ``tests/test_pallas_backend.py`` runs it.

Interpret mode costs about a second per leaf, so the grid is covering rather
than full: every phase form x operator runs on float32 plus one other wire
dtype, rotated so every form meets every dtype; SUM adds more rank counts.
Inputs carry NaN where the op propagates it. Tolerances: sum, max, min and
prod are bitwise; ssd and flash (multiply-add and exp in two compilers) are
held at rtol = atol = 1e-5 in float32 and 2e-2 / 2e-3 in bf16 / fp16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import operators as j_ops
from repro.core.reduce_ops import allreduce_schedule as j_allreduce
from repro.core.algorithms import SimBackend as JSim
from repro.kernels import pallas_collective as jpc
from repro.offload import backends as j_backends
from repro.offload import planner as j_plan
from repro_torch.core import operators as t_ops
from repro_torch.kernels import fused_collective as tfc
from repro_torch.offload import backends as t_backends
from repro_torch.offload import planner as t_plan
from test_torch_interop import BF16, WIRE_DTYPES, assert_same, rng_values, to_both

JK = j_plan.PhaseKind
TK = t_plan.PhaseKind
FORMS = [("SCAN", True), ("SCAN", False), ("FUSED_SCAN_TOTAL", True),
         ("FUSED_SCAN_TOTAL", False), ("TOTAL", True)]
OPS = ["sum", "prod", "max", "min"]
TOL = {np.float32: 1e-5, BF16: 2e-2, np.float16: 2e-3}


def _run_both(kind, p, opname, x_np, inclusive):
    jx, tx = to_both(x_np)
    want = jpc._sim_comm_kernel(
        JK[kind], p, j_ops.get_operator(opname), inclusive=inclusive,
        interpret=True,
    )(jx)
    got = tfc.comm_phase(
        TK[kind], p, t_ops.get_operator(opname), tx, inclusive=inclusive
    )
    return want, got


def _payload(rng, p, dtypes, opname, width=7):
    leaves = []
    for dt in dtypes:
        v = rng_values(rng, (p, width), dt, kind=opname)
        if dt in (np.float32, BF16, np.float16) and opname != "prod":
            v[p // 2, 1] = np.nan
        leaves.append(v)
    return tuple(leaves)


@pytest.mark.parametrize("form", range(len(FORMS)))
@pytest.mark.parametrize("opname", OPS)
def test_plain_matches_reference_kernel(form, opname):
    kind, inclusive = FORMS[form]
    p = 4 if kind == "TOTAL" else 5
    other = [d for d in WIRE_DTYPES if d is not np.float32]
    dtypes = (np.float32, other[(form + OPS.index(opname)) % len(other)])
    rng = np.random.default_rng(form * 10 + OPS.index(opname))
    x = _payload(rng, p, dtypes, opname)
    want, got = _run_both(kind, p, opname, x, inclusive)
    assert_same(want, got, what=f"{kind} incl={inclusive} {opname} {dtypes}")


@pytest.mark.parametrize("form", range(len(FORMS)))
def test_plain_matches_reference_kernel_sum_rank_counts(form):
    kind, inclusive = FORMS[form]
    ps = (2, 8) if kind == "TOTAL" else (2, 3, 8)
    for p in ps:
        x = _payload(np.random.default_rng(p), p, (np.float32,), "sum")[0]
        want, got = _run_both(kind, p, "sum", x, inclusive)
        assert_same(want, got, what=f"{kind} incl={inclusive} p={p}")


@pytest.mark.parametrize("opname", ["ssd", "flash"])
@pytest.mark.parametrize("dtype", [np.float32, BF16, np.float16], ids=str)
def test_plain_matches_reference_kernel_pytree_ops(opname, dtype):
    p = 4
    rng = np.random.default_rng(3)
    if opname == "ssd":
        x = (rng.uniform(0.5, 1.5, (p, 6)).astype(np.float32).astype(dtype),
             rng.standard_normal((p, 6)).astype(np.float32).astype(dtype))
    else:
        x = (rng.standard_normal((p, 6)).astype(np.float32).astype(dtype),
             rng.uniform(0.5, 2.0, (p, 6)).astype(np.float32).astype(dtype),
             rng.standard_normal((p, 6)).astype(np.float32).astype(dtype))
    want, got = _run_both("TOTAL", p, opname, x, True)
    assert_same(want, got, rtol=TOL[dtype], atol=TOL[dtype],
                what=f"{opname} {dtype}")


def test_plain_barrier_matches_reference_kernel():
    p = 8
    x = np.ones((p, 1), np.float32)
    jx, tx = to_both(x)
    want = jpc._sim_comm_kernel(JK.BARRIER, p, j_ops.MAX, interpret=True)(jx)
    got = tfc.comm_phase(TK.BARRIER, p, t_ops.MAX, tx)
    assert_same(want, got)


def test_plain_ssd_broadcast_leaves_match_reference_schedule():
    """SSD's decay may broadcast against its state (``operators.py``); the
    plain butterfly keeps each leaf's shape, like the reference schedule."""
    p = 4
    rng = np.random.default_rng(4)
    x = (rng.choice([0.5, 2.0], (p, 1)).astype(np.float32),
         rng.integers(-4, 5, (p, 3)).astype(np.float32))
    jx, tx = to_both(x)
    want = j_allreduce(JSim(p), jx, j_ops.SSD)
    got = tfc.comm_phase(TK.TOTAL, p, t_ops.SSD, tx)
    assert_same(want, got)


def test_unbroadcast_restores_leaf_shapes():
    a = torch.arange(4.0).reshape(4, 1)
    b = torch.zeros(4, 3)
    full_a, full_b = torch.broadcast_tensors(a, b)
    assert torch.equal(tfc._unbroadcast(full_a.contiguous(), a.shape), a)
    assert torch.equal(tfc._unbroadcast(full_b.contiguous(), b.shape), b)


@pytest.mark.parametrize("coll", ["SCAN", "EXSCAN", "ALLREDUCE", "BARRIER"])
@pytest.mark.parametrize("sizes", [(8,), (1, 8)], ids=str)
def test_lowering_matches_lower_pallas(coll, sizes):
    """The registry's fused backend (wire name "pallas") in both packages,
    through the whole plan lowering."""
    x = np.random.default_rng(8).standard_normal((8, 16)).astype(np.float32)
    jx, tx = to_both(x)
    jp = j_plan.build_plan(coll, sizes, "sum", 64)
    tp = t_plan.build_plan(coll, sizes, "sum", 64)
    assert jpc.supports_plan(jp) == tfc.supports_plan(tp) == (True, "")
    assert tfc.kernel_round_structure(tp) == jpc.kernel_round_structure(jp)
    arg_j, arg_t = (None, None) if coll == "BARRIER" else (jx, tx)
    want = jpc.lower_pallas(jp, interpret=True)(arg_j)
    got = t_backends.get_backend("pallas").lower(tp, device="cpu")(arg_t)
    assert_same(want, got)


def _plan_pairs():
    """(reference plan, port plan, axis names) covering every reason token."""
    import dataclasses

    cases = []
    for coll, sizes, op, algos in [
        ("SCAN", (8,), "sum", None),
        ("EXSCAN", (1, 8), "sum", None),
        ("ALLREDUCE", (8,), "ssd", None),
        ("ALLREDUCE", (6,), "sum", None),
        ("BARRIER", (1, 16), "sum", None),
        ("SCAN", (2, 4), "sum", None),
        ("REDUCE", (1, 8), "sum", None),
        ("SCAN", (8,), "max", None),
        ("SCAN", (8,), "ssd", None),
        ("SCAN", (8,), "sum", ("sequential",)),
        ("SCAN", (8,), "sum", ("sklansky",)),
        ("ALLREDUCE", (1, 1), "sum", None),
    ]:
        kw = {} if algos is None else {"level_algorithms": algos}
        jp = j_plan.build_plan(coll, sizes, op, 64, **kw)
        tp = t_plan.build_plan(coll, sizes, op, 64, **kw)
        cases.append((jp, tp))
        cases.append((dataclasses.replace(jp, chunking=2),
                      dataclasses.replace(tp, chunking=2)))
        jo = j_plan.build_plan(coll, sizes, op, 64, optimize=True, **kw)
        to = t_plan.build_plan(coll, sizes, op, 64, optimize=True, **kw)
        cases.append((jo, to))
    return cases


def test_supports_plan_reason_tokens_identical():
    seen = set()
    for jp, tp in _plan_pairs():
        assert tp.describe() == jp.describe()
        for names in (None, ("i",), ("a", "b")):
            want = jpc.supports_plan(jp, names)
            assert tfc.supports_plan(tp, names) == want, tp.describe()
            seen.add(want[1].split(":")[0])
        assert tfc.active_level(tp) == jpc.active_level(jp)
        assert tfc.kernel_round_structure(tp) == jpc.kernel_round_structure(jp)
    assert {"", "chunked", "multi_axis_mesh", "not_single_axis", "op_flags",
            "non_pow2_butterfly", "algorithm", "phase"} <= seen


def test_registry_resolution_matches_reference():
    assert t_backends.backend_names() == j_backends.backend_names() == (
        "pallas", "sim", "spmd")
    assert t_backends.get_backend("sim").fingerprint() == ()
    assert t_backends.get_backend("spmd").fingerprint() == ()
    assert t_backends.get_backend("pallas").fingerprint() == (
        j_backends.get_backend("pallas").fingerprint()
    )
    assert t_backends.default_backend_name(None) == "sim"
    for jp, tp in _plan_pairs():
        jb, jr = j_backends.resolve("pallas", jp)
        tb, tr = t_backends.resolve("pallas", tp)
        assert (tb.name, tr) == (jb.name, jr)
    with pytest.raises(ValueError, match="unknown lowering backend"):
        t_backends.resolve("netfpga", tp)
    with pytest.raises(ValueError, match="mode-dependent"):
        t_backends.get_backend("")


def test_wrapper_on_cpu_runs_plain_and_never_builds(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the CUDA kernel")

    monkeypatch.setattr(tfc, "_library", no_build)
    before = tfc.launches
    x = torch.arange(24.0).reshape(8, 3)
    out = tfc.comm_phase(TK.SCAN, 8, t_ops.SUM, x)
    assert torch.equal(out, torch.cumsum(x, 0))
    assert tfc.launches == before
    with pytest.raises(ValueError, match="no fused kernel for device"):
        tfc.comm_phase(TK.SCAN, 8, t_ops.SUM, x.to("meta"))


def test_lower_fused_rejects_unsupported_plans():
    tp = t_plan.build_plan("SCAN", (2, 4), "sum", 64)
    with pytest.raises(ValueError, match="not_single_axis"):
        tfc.lower_fused(tp, device="cpu")
    with pytest.raises(ValueError, match="not a power of two"):
        tfc.comm_phase_plain(TK.TOTAL, 6, t_ops.SUM, torch.zeros(6, 2))


def test_wire_dtype_table_matches_kernel_codes():
    """The kernel's dtype codes are the wire ids of ``packet.WireDType``."""
    from repro_torch.core.packet import WireDType
    from repro_torch.offload.engine import wire_dtype

    for wd in WireDType:
        assert tfc._DTYPE_CODES[wire_dtype(wd)] == int(wd)
    assert jnp.dtype(jnp.bfloat16) == np.dtype(BF16)
