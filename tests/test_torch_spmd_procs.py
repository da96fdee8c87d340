"""K2 with one rank per process (``repro_torch.kernels.spmd_collective``'s
peers path and its host side, ``_PeerWorkspace``) and the engine's spmd and
driver modes over a process group, against the reference.

The CUDA kernel runs only on a GPU (``chip_smoke.py``'s ``procs`` phase
holds it there against the co-resident K2 and the plain version, in 2, 4
and 8 processes sharing the card). Here one spawn of 4 processes in a gloo
group (a ``file://`` store, killed after 120 s) runs the ``procs`` suite of
``repro_torch.testing.spmd_check`` on the CPU, where the wrapper runs K2's
plain version: the engine in spmd and driver mode, as the planned request
over axes ``(1, 4)``, with ``backend="pallas"`` and with the default
backend, over sum, max and min on int32 and float32. Each rank's result is
held bitwise against the reference engine's spmd mode on the same
descriptor (which falls back to its op-per-round lowering for such a plan,
``multi_axis_mesh``) and, for ``backend="pallas"``, against the reference's
Pallas kernel in interpret mode (``lower_pallas(..., axis_names=("i",),
interpret=True)``) on the one-axis plan, both under ``shard_map`` on 4
forced host devices in a subprocess. The same spawn registers a
``_PeerWorkspace`` through a fake IPC and runs the gloo ``ppermute``'s host
staging. ``plan_launch``'s peers path, the epoch and parity sequence, and
``procs_check`` (the chip phase's logic) at small sizes on the CPU complete
the file.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.selector import set_active_tuning as j_set_tuning
from repro_torch import compat
from repro_torch.core.selector import set_active_tuning as t_set_tuning
from repro_torch.kernels import spmd_collective as tsc
from repro_torch.offload import planner as t_planner
from repro_torch.testing import procs_check as pc
from repro_torch.testing import spmd_check as sc

REPO = Path(__file__).resolve().parents[1]
P = 4
SPAWN_TIMEOUT_S = 120
CASES = [c for c in sc.procs_cases(P) if c.kind == "engine"]
PINNED = [c for c in CASES if c.get("backend") == "pallas"]
TK = t_planner.PhaseKind

_REF = r"""
import os, pickle, sys
p = int(sys.argv[1])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={p}"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core.packet import WireDType
from repro.kernels import pallas_collective as pc
from repro.offload import OffloadEngine, planner
from repro_torch.testing import spmd_check as sc

two = Mesh(np.array(jax.devices()).reshape(1, p), ("o", "i"))
one = Mesh(np.array(jax.devices()), ("i",))
runs, out, fallbacks = {}, {}, {}


def compiled(key, make):
    if key not in runs:
        runs[key] = make()
    return runs[key]


def jitted(f, mesh, spec, has_x):
    def body(*args):
        got = f(args[0] if args else None)
        return jax.tree.map(lambda a: a[None] if jnp.ndim(a) == 0 else a, got)

    return jax.jit(shard_map(body, mesh=mesh,
                             in_specs=(spec,) if has_x else (),
                             out_specs=spec, check_vma=False))


for case in sc.procs_cases(p):
    if case.kind != "engine":
        continue
    coll, op, dt = case.get("coll"), case.get("op"), case.get("dtype")
    backend = case.get("backend")
    x = sc.case_input(case)
    args = (jnp.asarray(x),) if x is not None else ()
    eng = OffloadEngine()
    kw = dict(backend="pallas", chunks=1) if backend else {}
    desc = eng.make_descriptor(coll, p=p, axes=(1, p), payload_bytes=4 * sc.N,
                               op=op, data_type=getattr(WireDType, dt.upper()),
                               **kw)
    run = jitted(lambda t, eng=eng, desc=desc: eng.offload(
        desc, t, axis_name=("o", "i")), two, P(("o", "i")), x is not None)
    got = {"engine": [np.asarray(a) for a in jax.tree.leaves(run(*args))]}
    fallbacks[case.name] = eng.telemetry.snapshot()["backend_fallback_reasons"]
    if backend:
        def make(coll=coll, op=op):
            algos = {"level_algorithms": ("hillis_steele",)} \
                if coll in ("SCAN", "EXSCAN") else {}
            plan = planner.build_plan(coll, (p,), "max" if coll == "BARRIER"
                                      else op, 4 * sc.N, **algos)
            f = pc.lower_pallas(plan, op, axis_names=("i",), interpret=True)
            return jitted(f, one, P("i"), x is not None)

        kernel = compiled((coll, op, dt), make)
        got["kernel"] = [np.asarray(a) for a in jax.tree.leaves(kernel(*args))]
    out[case.name] = got
with open(sys.argv[2], "wb") as fh:
    pickle.dump({"out": out, "fallbacks": fallbacks}, fh)
print("ALL-OK")
"""


@pytest.fixture(autouse=True)
def _no_active_tuning():
    j_set_tuning(None)
    t_set_tuning(None)
    yield
    j_set_tuning(None)
    t_set_tuning(None)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_procs") / "ref.pkl"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REF, str(P), str(out)], env=env,
        capture_output=True, text=True, timeout=600, cwd=str(REPO),
    )
    assert proc.returncode == 0 and "ALL-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:]
    )
    with open(out, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return sc.run_gloo("procs", P, tmp_path_factory.mktemp("gloo_procs"),
                       timeout=SPAWN_TIMEOUT_S)


def _same(what, got, want):
    assert not isinstance(got, str), f"{what}: {got}"
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype, what
        # the reference's per-rank barrier token comes back as (p, 1)
        np.testing.assert_array_equal(g.numpy(), w.reshape(g.shape),
                                      err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_gloo_engine_matches_reference_engine(case, gloo, ref):
    _same(case.name, gloo[case.name], ref["out"][case.name]["engine"])


@pytest.mark.parametrize("case", PINNED, ids=lambda c: c.name)
def test_gloo_k2_matches_reference_kernel(case, gloo, ref):
    """``backend="pallas"`` runs K2 (its plain version on the CPU) with no
    fallback in the port; the reference's engine falls back for the same
    plan, and its Pallas kernel gives the same values."""
    _same(case.name, gloo[case.name], ref["out"][case.name]["kernel"])
    assert ref["fallbacks"][case.name] == {"multi_axis_mesh": 1}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_coresident_engine_matches_reference_engine(case, ref):
    got = sc.run_case(
        case, lambda shape, names: compat.Mesh(shape, names, device="cpu"))
    _same(case.name, got, ref["out"][case.name]["engine"])


def test_peer_workspace_registers_collectively(gloo):
    """Every rank's table lists each rank's handle in rank order; a call
    that fits makes no exchange; one that outgrows the block re-registers
    on every rank at that call; a release leaves nothing mapped or
    allocated; a group that disagrees raises on every rank."""
    got = gloo["procs:workspace"]
    assert not isinstance(got, str), got
    regs, handles, offsets, tail = (t.numpy() for t in got)
    calls = sc.WORKSPACE_CALLS
    assert regs.shape == (P, len(calls))
    assert (regs == [1, 1, 1, 2, 3]).all()  # the same calls on every rank
    for rank in range(P):
        for i, gen in enumerate(regs[rank]):
            assert handles[rank, i].tolist() == [[q, gen] for q in range(P)]
        for i, (flags, recv) in enumerate(calls):
            F, R = offsets[rank, i, 5, :2]
            assert F >= flags and R >= recv
            head = tsc._PeerWorkspace.HEADER
            want = [head + 8 * F, head + 8 * F + R, head, head + 4 * F, 0]
            assert offsets[rank, i, :5].tolist() == [[w] * P for w in want]
    assert (tail == [0, 0, 1]).all()


def test_gloo_permute_staged_through_the_host(gloo):
    """The host-staged ``ppermute`` (CUDA leaves under gloo) gives back the
    unstaged permute's leaves, on the inputs' device and dtype, after one
    host copy a leaf."""
    *leaves, flags = gloo["procs:staged"]
    assert (flags.numpy() == [1, 1, 1, 3]).all()
    assert [l.dtype for l in leaves] == [torch.int32, torch.float32,
                                         torch.bfloat16]
    # rank r holds rank r - 1's values
    assert leaves[0][:, 0].tolist() == [100 * ((r - 1) % P) for r in range(P)]


@pytest.mark.parametrize("p", range(2, 33))
def test_plan_launch_takes_peers_in_processes(p):
    for kind, inclusive in ((TK.SCAN, True), (TK.SCAN, False),
                            (TK.FUSED_SCAN_TOTAL, True), (TK.TOTAL, True)):
        got = tsc.plan_launch(kind, p, 1000, torch.float32, 1,
                              inclusive=inclusive, processes=True)
        assert got.path == "peers" and got.grid == (1, 1, 1)
        assert got.slots == tsc.exchanges(kind, p, inclusive)
        assert got.launches == 1
        coresident = tsc.plan_launch(kind, p, 1000, torch.float32, 1,
                                     inclusive=inclusive)
        assert coresident.path == ("cluster" if p <= 16 else "flags")
    with pytest.raises(ValueError, match="no 'cluster' path"):
        tsc.plan_launch(TK.SCAN, p, 8, torch.float32, 1, path="cluster",
                        processes=True)


def test_peer_epoch_sequence():
    """Launch e uses parity set e % 2, publishes done = e - 1, and waits
    for its partners' done words to reach e - 2, the last launch that used
    its set."""
    got = [tsc.peer_epoch(e) for e in range(1, 11)]
    assert got == [(1, 0, 0), (0, 1, 0), (1, 2, 1), (0, 3, 2), (1, 4, 3),
                   (0, 5, 4), (1, 6, 5), (0, 7, 6), (1, 8, 7), (0, 9, 8)]
    for e, (parity, done, need) in enumerate(got, start=1):
        last = e - 2  # the last launch on this parity set
        assert parity == e % 2 and done == e - 1
        assert need == max(last, 0) and (last < 1 or last % 2 == parity)


def test_procs_check_small_on_cpu(tmp_path):
    """The chip phase's logic (every job in 4 ranks, digests against the
    co-resident and the plain results, launches held to the plan) at small
    sizes on the CPU, where K2's wrapper runs the plain version."""
    got = pc.check(P, tmp_path, device="cpu", small=True, repeat=3,
                   timeout=SPAWN_TIMEOUT_S)
    assert got["ranks"] == P and got["peers_launches_per_rank"] == [0] * P
    assert got["jobs"] == len(pc.jobs(P, pc.SMALL_SIZES, 3))
    assert all(len(t) == 2 * len(pc.SMALL_SIZES) for t in got["times"])
