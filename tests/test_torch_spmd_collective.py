"""Parity of ``repro_torch.kernels.spmd_collective`` (K2's plain version and
the per-rank fused lowering, ``fused_collective.lower_fused(...,
axis_names=("i",))``) with the spmd form of
``repro.kernels.pallas_collective``.

The CUDA kernel runs only on a GPU (``chip_smoke.py`` holds it against the
plain version, K1 and ``lower_spmd`` there); here the plain version — what
the wrapper runs for CPU tensors — runs under both kinds of rank group
(co-resident ranks in this process, one rank per process in a gloo group of
4 spawned with a ``file://`` store and killed after 120 s) and is held
bitwise against the reference's ``_spmd_comm_kernel`` and
``lower_pallas(plan, op, axis_names=("i",), interpret=True)``, run under
``shard_map`` on 4 forced host devices in a subprocess, on the cases of
``repro/testing/pallas_check.py``: every phase form over sum, max and min
with an int32 and a float32 leaf, SCAN and EXSCAN sum, BARRIER, and the
hand-fused FUSED_SCAN_TOTAL plan inclusive and exclusive with both outputs.
K2's plain version is also held bitwise against K1's on every wire dtype,
and within the stated tolerance on ssd and flash.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.offload import backends as j_backends
from repro.offload import planner as j_planner
from repro.kernels import pallas_collective as jpc
from repro_torch import compat
from repro_torch.core import operators as t_ops
from repro_torch.kernels import fused_collective as tfc
from repro_torch.kernels import spmd_collective as tsc
from repro_torch.offload import backends as t_backends
from repro_torch.offload import planner as t_planner
from repro_torch.testing import spmd_check as sc
from test_torch_interop import BF16, WIRE_DTYPES, rng_values, to_both

REPO = Path(__file__).resolve().parents[1]
P = 4
SPAWN_TIMEOUT_S = 120
CASES = sc.collective_cases(P)
TK = t_planner.PhaseKind
FORMS = [(TK[k], inc) for k, inc in sc.PHASE_FORMS]
TOL = {np.float32: 1e-5, BF16: 2e-2, np.float16: 2e-3}

_REF_PALLAS = r"""
import os, pickle, sys
p = int(sys.argv[1])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={p}"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core.operators import get_operator
from repro.kernels import pallas_collective as pc
from repro.offload import passes, planner
from repro_torch.testing import spmd_check as sc

mesh = Mesh(np.array(jax.devices()), ("i",))
spec = P("i")
out = {}
for case in sc.collective_cases(p):
    op = get_operator(case.get("op"))
    if case.kind == "phase":
        f = pc._spmd_comm_kernel(
            planner.PhaseKind[case.get("phase")], p, "i", op,
            inclusive=case.get("inclusive"), interpret=True)
    else:
        plan = sc.case_plan(case, planner, passes)
        f = pc.lower_pallas(plan, op, axis_names=("i",), interpret=True)
    x = sc.case_input(case)

    def body(*args, f=f):
        got = f(args[0] if args else None)
        return jax.tree.map(lambda a: a[None] if jnp.ndim(a) == 0 else a, got)

    run = jax.jit(shard_map(body, mesh=mesh,
                            in_specs=(spec,) if x is not None else (),
                            out_specs=spec, check_vma=False))
    got = run(*((jax.tree.map(jnp.asarray, x),) if x is not None else ()))
    out[case.name] = [np.asarray(a) for a in jax.tree.leaves(got)]
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
print("ALL-OK")
"""


@pytest.fixture(scope="module")
def ref_pallas(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_pallas") / "ref.pkl"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REF_PALLAS, str(P), str(out)], env=env,
        capture_output=True, text=True, timeout=600, cwd=str(REPO),
    )
    assert proc.returncode == 0 and "ALL-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:]
    )
    with open(out, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return sc.run_gloo("collective", P, tmp_path_factory.mktemp("gloo4"),
                       timeout=SPAWN_TIMEOUT_S)


def _same(case, got, want):
    assert not isinstance(got, str), f"{case.name}: {got}"
    assert len(got) == len(want), case.name
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype, case.name
        # the reference's per-rank barrier token comes back as (p, 1)
        np.testing.assert_array_equal(g.numpy(), w.reshape(g.shape),
                                      err_msg=case.name)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_coresident_matches_reference_kernel(case, ref_pallas):
    got = sc.run_case(
        case, lambda shape, names: compat.Mesh(shape, names, device="cpu")
    )
    _same(case, got, ref_pallas[case.name])


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_gloo_matches_reference_kernel(case, ref_pallas, gloo):
    _same(case, gloo[case.name], ref_pallas[case.name])


# ---------------------------------------------------------------------------
# K2's plain version against K1's on every wire dtype and operator
# ---------------------------------------------------------------------------


def _per_rank(kind, p, op, x, inclusive):
    mesh = compat.Mesh((p,), ("i",), device="cpu")
    return compat.shard_map(
        lambda t: tsc.comm_phase_spmd(kind, p, "i", op, t, inclusive=inclusive),
        mesh, ("i",), "i",
    )(x)


def _leaves(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("form", range(len(FORMS)), ids=lambda i: f"{FORMS[i][0].name}-{FORMS[i][1]}")
@pytest.mark.parametrize("dtype", WIRE_DTYPES, ids=lambda d: np.dtype(d).name)
def test_plain_equals_k1_plain(form, dtype):
    kind, inclusive = FORMS[form]
    ops = ("max",) if kind == TK.BARRIER else ("sum", "prod", "max", "min")
    rng = np.random.default_rng(form)
    for p in (2, 4, 8) if kind in (TK.TOTAL, TK.BARRIER) else (2, 3, 5, 8):
        for opname in ops:
            op = t_ops.get_operator(opname)
            x = to_both(rng_values(rng, (p, 6), dtype, kind=opname))[1]
            if kind == TK.BARRIER:
                x = torch.ones((p, 1))
            got = _per_rank(kind, p, op, x, inclusive)
            want = tfc.comm_phase_plain(kind, p, op, x, inclusive=inclusive)
            for g, w in zip(_leaves(got), _leaves(want)):
                assert g.dtype == w.dtype
                assert torch.equal(g, w) or (
                    g.is_floating_point()
                    and torch.equal(g.isnan(), w.isnan())
                    and torch.equal(g[~g.isnan()], w[~w.isnan()])
                ), (kind, inclusive, p, opname, dtype)


@pytest.mark.parametrize("opname", ["ssd", "flash"])
@pytest.mark.parametrize("dtype", [np.float32, BF16, np.float16], ids=str)
def test_plain_pytree_ops_match_k1_plain(opname, dtype):
    p = 4
    rng = np.random.default_rng(5)
    if opname == "ssd":
        x = (rng.uniform(0.5, 1.5, (p, 6)), rng.standard_normal((p, 6)))
    else:
        x = (rng.standard_normal((p, 6)), rng.uniform(0.5, 2.0, (p, 6)),
             rng.standard_normal((p, 6)))
    x = to_both(tuple(a.astype(np.float32).astype(dtype) for a in x))[1]
    op = t_ops.get_operator(opname)
    for kind, inclusive in ((TK.TOTAL, True), (TK.FUSED_SCAN_TOTAL, False)):
        got = _per_rank(kind, p, op, x, inclusive)
        want = tfc.comm_phase_plain(kind, p, op, x, inclusive=inclusive)
        got = got[1] if kind == TK.FUSED_SCAN_TOTAL else got
        want = want[1] if kind == TK.FUSED_SCAN_TOTAL else want
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), rtol=TOL[dtype],
                                       atol=TOL[dtype])


@pytest.mark.parametrize("form", range(len(FORMS)), ids=lambda i: f"{FORMS[i][0].name}-{FORMS[i][1]}")
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_exchange_count_sizes_the_kernel_buffers(form, p, monkeypatch):
    """``exchanges`` (the receive regions and flag rows K2 allocates per
    rank) is the number of full-permutation rounds the plain version makes."""
    kind, inclusive = FORMS[form]
    calls = []
    real = compat._CoResident.ppermute

    def counting(self, tree, name, perm):
        calls.append(len(perm))
        return real(self, tree, name, perm)

    monkeypatch.setattr(compat._CoResident, "ppermute", counting)
    _per_rank(kind, p, t_ops.MAX, torch.zeros((p, 3)), inclusive)
    assert len(calls) == tsc.exchanges(kind, p, inclusive)
    assert all(n == p for n in calls)  # every round is a full permutation


# ---------------------------------------------------------------------------
# the envelope: the reference's reason tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opname", ["max", "ssd"])
def test_non_zero_identity_scans_rejected_with_reference_token(opname):
    got = tfc.supports_plan(
        t_planner.build_plan("SCAN", (P,), opname, 4 * sc.N), ("i",))
    want = jpc.supports_plan(
        j_planner.build_plan("SCAN", (P,), opname, 4 * sc.N), ("i",))
    assert got == want == (False, "op_flags")
    with pytest.raises(ValueError, match="op_flags"):
        tfc.lower_fused(t_planner.build_plan("SCAN", (P,), opname, 4 * sc.N),
                        axis_names=("i",))


def test_multi_axis_mesh_resolves_to_spmd_with_reference_token():
    t_plan = t_planner.build_plan("SCAN", (2, 4), "sum", 64)
    j_plan = j_planner.build_plan("SCAN", (2, 4), "sum", 64)
    t_backend, t_reason = t_backends.resolve("pallas", t_plan, ("a", "b"))
    j_backend, j_reason = j_backends.resolve("pallas", j_plan, ("a", "b"))
    assert (t_backend.name, t_reason) == (j_backend.name, j_reason) == (
        "spmd", "multi_axis_mesh")
    assert t_backends.backend_names() == j_backends.backend_names() == (
        "pallas", "sim", "spmd")
    assert t_backends.get_backend("spmd").capabilities(t_plan) == (
        j_backends.get_backend("spmd").capabilities(j_plan))


def test_pallas_lowering_under_axes_runs_k2_phase_loop():
    """``get_backend("pallas").lower(plan, op, axis_names=("i",))`` — the
    entry point ``pallas_check`` uses — is the per-rank fused lowering."""
    plan = t_planner.build_plan("SCAN", (P,), "sum", 4 * sc.N)
    fn = t_backends.get_backend("pallas").lower(plan, "sum", axis_names=("i",))
    mesh = compat.Mesh((P,), ("i",), device="cpu")
    x = torch.arange(P * 3, dtype=torch.float32).reshape(P, 3)
    got = compat.shard_map(fn, mesh, ("i",), "i")(x)
    assert torch.equal(got, torch.cumsum(x, 0))


def test_workspace_keeps_only_flags_status_and_epoch():
    """K2's host side keeps no receive region between launches (each launch
    takes its own from the allocator); the flags grow on demand, restart the
    epoch when they do, and their peer table strides one rank's row."""
    p = 4
    ws = tsc._Workspace(torch.device("cpu"), p)
    table, epoch = ws.flag_table(10)
    base = ws.flags.data_ptr()
    assert epoch == 1 and ws.flags.numel() == p * 10
    assert (table - base).tolist() == [q * 40 for q in range(p)]
    table, epoch = ws.flag_table(5)  # fits: same flags, new stride
    assert epoch == 2 and ws.flags.data_ptr() == base
    assert (table - base).tolist() == [q * 20 for q in range(p)]
    _, epoch = ws.flag_table(100)  # grows: fresh zeroed flags
    assert epoch == 1 and ws.flags.numel() == p * 100
    assert not bool(ws.flags.any())
    recv = torch.empty(p * 24, dtype=torch.uint8)
    assert (ws.table(recv, 24) - recv.data_ptr()).tolist() == [0, 24, 48, 72]
    assert not any(isinstance(v, torch.Tensor) and v.dtype == torch.uint8
                   for v in vars(ws).values())
