"""Per-rank validation cases of the port's spmd forms, under either kind of
rank group (counterpart of ``repro.testing.spmd_check``, ``planner_check``,
``reduce_check``, ``hierarchical_check`` and ``pallas_check``).

Every :class:`Case` names one per-rank call — ``dist_scan`` and friends,
``lower_spmd`` over 1-, 2- and 3-axis meshes, ``dist_hierarchical_scan``,
the engine's spmd and driver modes, K2's plain version and the per-rank
fused lowering — with its mesh and a seeded numpy input
(:func:`case_input`). :func:`run_case` runs it on a
:class:`~repro_torch.compat.Mesh` of either kind and returns the stacked
result; ``tests/test_torch_spmd*.py`` hold those results against the
reference.

Run the cases of one suite in ``P`` processes joined in one gloo group:

    python -m repro_torch.testing.spmd_check [--device cpu] SUITE P WORKDIR

(:func:`run_gloo` does this: a ``file://`` store under ``WORKDIR``, no TCP
port; rank 0 writes every case's result to ``WORKDIR/results.pt`` and the
run prints ALL-OK.) Without ``--device cpu`` every rank runs on the card,
rank ``r`` on ``cuda:(r % device_count)``, and the ``procs`` suite's
``backend="pallas"`` cases launch K2's peers path.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import os
import signal
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

PyTree = Any

#: per-rank payload elements of every case (a scalar case says so)
N = 32


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    kind: str
    shape: Tuple[int, ...]        # mesh shape
    names: Tuple[str, ...]        # mesh axis names
    params: Tuple[Tuple[str, Any], ...] = ()

    @property
    def p(self) -> int:
        return int(np.prod(self.shape))

    def get(self, key: str, default: Any = None) -> Any:
        return dict(self.params).get(key, default)


def _case(name: str, kind: str, shape, names, **params) -> Case:
    return Case(name, kind, tuple(shape), tuple(names),
                tuple(sorted(params.items())))


SCAN_ALGORITHMS = ("sequential", "sequential_pipelined", "hillis_steele",
                   "recursive_doubling", "binomial_tree", "sklansky",
                   "invertible_doubling")
EXACT = [(op, dt) for op in ("sum", "max", "min") for dt in ("int32", "float32")]


def spmd_cases(p: int) -> List[Case]:
    """The ``spmd`` suite at ``p`` ranks (``p`` a power of two, >= 4)."""
    one = ((p,), ("i",))
    two = ((2, p // 2), ("a", "b"))
    three = ((p // 4, 2, 2), ("a", "b", "c"))
    cases: List[Case] = []
    for fn in ("scan", "exscan"):
        for algo in SCAN_ALGORITHMS:
            for op, dt in EXACT:
                if algo == "invertible_doubling" and op != "sum":
                    continue
                cases.append(_case(f"{fn}:{algo}:{op}:{dt}", fn, *one,
                                   algorithm=algo, op=op, dtype=dt))
    for op, dt in EXACT:
        cases.append(_case(f"pair:{op}:{dt}", "pair", *one,
                           algorithm="hillis_steele", op=op, dtype=dt))
    for algo in ("hillis_steele", "recursive_doubling"):
        cases.append(_case(f"scan:{algo}:ssd", "scan", *one, algorithm=algo,
                           op="ssd", dtype="float32"))
    cases.append(_case("exscan:hillis_steele:ssd", "exscan", *one,
                       algorithm="hillis_steele", op="ssd", dtype="float32"))
    cases.append(_case("scan:auto:sum:int32", "scan", *one, algorithm="auto",
                       op="sum", dtype="int32"))
    for op, dt in EXACT:
        for root in (0, p - 1):
            cases.append(_case(f"reduce:root{root}:{op}:{dt}", "reduce", *one,
                               root=root, op=op, dtype=dt))
        cases.append(_case(f"allreduce:{op}:{dt}", "allreduce", *one,
                           algorithm="recursive_doubling", op=op, dtype=dt))
    cases.append(_case("allreduce:prod:float32", "allreduce", *one,
                       algorithm="recursive_doubling", op="prod",
                       dtype="float32"))
    cases.append(_case("allreduce:ssd", "allreduce", *one,
                       algorithm="recursive_doubling", op="ssd",
                       dtype="float32"))
    cases.append(_case("allreduce:flash", "allreduce", *one,
                       algorithm="recursive_doubling", op="flash",
                       dtype="float32"))
    cases.append(_case("barrier", "barrier", *one))
    # lower_spmd: 1-, 2- and 3-axis plans, chunked and not, raw and optimized
    plans = []
    for coll in ("SCAN", "EXSCAN", "REDUCE", "ALLREDUCE", "BARRIER"):
        plans.append((coll, one, (0,), 1, False, "sum", "float32"))
        plans.append((coll, two, (0, 1), 1, False, "sum", "float32"))
        plans.append((coll, three, (0, 1, 2), 1, False, "max", "int32"))
    for coll in ("SCAN", "EXSCAN"):
        plans.append((coll, two, (1, 0), 1, False, "min", "float32"))
        plans.append((coll, two, (0, 1), 2, False, "sum", "int32"))
        plans.append((coll, three, (2, 0, 1), 2, False, "sum", "float32"))
        plans.append((coll, two, (0, 1), 1, True, "sum", "float32"))
        plans.append((coll, three, (0, 1, 2), 2, True, "max", "float32"))
    plans.append(("SCAN", two, (0, 1), 1, False, "ssd", "float32"))
    plans.append(("ALLREDUCE", two, (1, 0), 2, True, "sum", "int32"))
    for coll, (shape, names), order, chunks, opt, op, dt in plans:
        name = (f"plan:{coll}:{'x'.join(map(str, shape))}:"
                f"order{''.join(map(str, order))}:c{chunks}:"
                f"{'opt' if opt else 'raw'}:{op}:{dt}")
        cases.append(_case(name, "plan", shape, names, coll=coll,
                           order=order, chunks=chunks, optimized=opt, op=op,
                           dtype=dt))
    # a scalar per rank: no chunk splits it (the rank axis is not payload)
    cases.append(_case("plan:SCAN:scalar:c2", "plan", *two, coll="SCAN",
                       order=(0, 1), chunks=2, optimized=False, op="sum",
                       dtype="float32", scalar=True))
    for inclusive in (True, False):
        for op, dt in (("sum", "float32"), ("max", "int32")):
            cases.append(_case(
                f"hier:{'inc' if inclusive else 'exc'}:{op}:{dt}", "hier",
                (2, p // 2), ("o", "i"), inclusive=inclusive, op=op,
                dtype=dt, algorithm="hillis_steele"))
    cases.append(_case("hier:inc:auto:sum:int32", "hier", (2, p // 2),
                       ("o", "i"), inclusive=True, op="sum", dtype="int32",
                       algorithm="auto"))
    for mode in ("spmd", "driver"):
        for coll in ("SCAN", "EXSCAN", "REDUCE", "ALLREDUCE", "BARRIER"):
            cases.append(_case(f"engine:{mode}:{coll}", "engine", *one,
                               mode=mode, coll=coll, op="sum",
                               dtype="float32"))
        cases.append(_case(f"engine:{mode}:SCAN:planned", "engine", *two,
                           mode=mode, coll="SCAN", op="sum", dtype="float32",
                           planned=True))
        cases.append(_case(f"engine:{mode}:ALLREDUCE:max:int32", "engine",
                           *one, mode=mode, coll="ALLREDUCE", op="max",
                           dtype="int32"))
    return cases


PHASE_FORMS = (("SCAN", True), ("SCAN", False), ("FUSED_SCAN_TOTAL", True),
               ("FUSED_SCAN_TOTAL", False), ("TOTAL", True),
               ("BARRIER", True))


def procs_cases(p: int) -> List[Case]:
    """The ``procs`` suite: the engine in spmd and driver mode over one flat
    group, as a planned request over axes ``(1, p)`` (mesh axes ``o`` and
    ``i``), with ``backend="pallas"`` (K2, one launch a comm phase) and the
    default backend (the spmd rounds): ALLREDUCE over sum, max and min on
    int32 and float32, SCAN and EXSCAN over the same with the default
    backend and over sum with K2 (a scan over max or min is outside K2's
    envelope, ``op_flags``, as in the reference), and BARRIER. Under a process
    group also :func:`workspace_trace` and :func:`staged_permute`."""
    shape, names = (1, p), ("o", "i")
    cases = [_case("procs:workspace", "workspace", (p,), ("i",)),
             _case("procs:staged", "staged", (p,), ("i",))]
    for mode in ("spmd", "driver"):
        for backend in ("pallas", ""):
            tag = backend or "default"
            for coll in ("SCAN", "EXSCAN", "ALLREDUCE"):
                for op, dt in EXACT:
                    if backend and coll != "ALLREDUCE" and op != "sum":
                        continue
                    cases.append(_case(
                        f"procs:{mode}:{tag}:{coll}:{op}:{dt}", "engine",
                        shape, names, mode=mode, coll=coll, op=op, dtype=dt,
                        planned=True, backend=backend))
            cases.append(_case(f"procs:{mode}:{tag}:BARRIER", "engine", shape,
                               names, mode=mode, coll="BARRIER", op="sum",
                               dtype="float32", planned=True,
                               backend=backend))
    return cases


def collective_cases(p: int) -> List[Case]:
    """The ``collective`` suite: K2's plain version per phase form and
    operator (an int32 and a float32 leaf in one payload), and the per-rank
    fused lowering on ``pallas_check``'s plans."""
    one = ((p,), ("i",))
    cases = []
    for kind, inclusive in PHASE_FORMS:
        ops = ("max",) if kind == "BARRIER" else ("sum", "max", "min")
        for op in ops:
            form = "inc" if inclusive else "exc"
            cases.append(_case(f"phase:{kind}:{form}:{op}", "phase", *one,
                               phase=kind, inclusive=inclusive, op=op))
    for name, coll, fused, inclusive, result in (
        ("lower:scan:sum", "SCAN", False, True, None),
        ("lower:exscan:sum", "EXSCAN", False, False, None),
        ("lower:barrier", "BARRIER", False, True, None),
        ("lower:fused:inc:scan", "SCAN", True, True, "y"),
        ("lower:fused:inc:total", "SCAN", True, True, "t"),
        ("lower:fused:exc:scan", "EXSCAN", True, False, "y"),
        ("lower:fused:exc:total", "EXSCAN", True, False, "t"),
    ):
        cases.append(_case(name, "lower", *one, coll=coll, fused=fused,
                           inclusive=inclusive, result=result,
                           op="max" if coll == "BARRIER" else "sum"))
    return cases


def wide_cases(p: int) -> List[Case]:
    """A few ``spmd`` cases that need ``p`` ranks (the 8-rank ring, the
    (2, 2, 2) mesh)."""
    keep = ("scan:hillis_steele:sum:float32", "plan:SCAN:2x2x2:order012:c1:raw:max:int32",
            "engine:driver:SCAN")
    return [c for c in spmd_cases(p) if c.name in keep]


SUITES: Dict[str, Callable[[int], List[Case]]] = {
    "spmd": spmd_cases,
    "wide": wide_cases,
    "collective": collective_cases,
    "procs": procs_cases,
}


# ---------------------------------------------------------------------------
# inputs and plans, shared with the reference side of the tests
# ---------------------------------------------------------------------------


def case_input(case: Case):
    """The case's stacked ``(P, ...)`` numpy payload (None for a barrier),
    seeded by its name."""
    rng = np.random.default_rng(zlib.crc32(case.name.encode()))
    P = case.p
    shape = (P,) if case.get("scalar") else (P, N)
    if case.kind == "barrier" or case.get("coll") == "BARRIER":
        return None
    if case.kind == "phase":
        if case.get("phase") == "BARRIER":
            return np.ones(shape, np.float32)
        return (rng.integers(-1000, 1000, shape).astype(np.int32),
                rng.standard_normal(shape).astype(np.float32))
    op = case.get("op")
    if op == "ssd":
        return (rng.uniform(0.5, 1.0, shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32))
    if op == "flash":
        return (rng.standard_normal(shape).astype(np.float32),
                rng.uniform(0.5, 2.0, shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32))
    if op == "prod":
        return rng.uniform(0.8, 1.25, shape).astype(np.float32)
    if case.get("dtype") == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def case_plan(case: Case, planner, passes):
    """The case's plan, built with either package's ``planner`` and
    ``passes`` modules (their plans are identical)."""
    op = case.get("op")
    if case.kind == "lower":
        plan = planner.build_plan(case.get("coll"), case.shape, op, 4 * N)
        if case.get("fused"):
            # pallas_check's hand-fused FUSED_SCAN_TOTAL plan
            phase = planner.PlanPhase(
                planner.PhaseKind.FUSED_SCAN_TOTAL, 0, "fused_doubling",
                inclusive=case.get("inclusive"), src=("x",), dst="y",
                dst2="t",
            )
            plan = dataclasses.replace(plan, phases=(phase,),
                                       result=case.get("result"))
        return plan
    itemsize = 4
    nbytes = itemsize * (1 if case.get("scalar") else N)
    plan = planner.build_plan(case.get("coll"), case.shape, op, nbytes,
                              order=case.get("order"))
    if case.get("optimized"):
        plan = passes.optimize_plan(plan)
    if case.get("chunks", 1) > 1:
        plan = dataclasses.replace(plan, chunking=case.get("chunks"))
    return plan


def spec_names(case: Case, plan=None) -> Tuple[str, ...]:
    """The mesh axes in the order the case's stacked payload lists ranks."""
    if plan is not None:
        return tuple(case.names[i] for i in plan.order)
    return case.names


# ---------------------------------------------------------------------------
# running a case on a mesh (torch side)
# ---------------------------------------------------------------------------


def run_case(case: Case, make_mesh: Callable[[Tuple[int, ...], Tuple[str, ...]], Any]):
    """The leaves of the case's stacked result (a tuple of CPU tensors),
    computed per rank on ``make_mesh(case.shape, case.names)``."""
    from repro_torch import compat
    from repro_torch.core import (
        dist_allreduce,
        dist_barrier,
        dist_exscan,
        dist_reduce,
        dist_scan,
        dist_scan_pair,
    )
    from repro_torch.core.operators import get_operator
    from repro_torch.core.trees import tree_leaves
    from repro_torch.interop import payload_from_numpy
    from repro_torch.kernels import fused_collective, spmd_collective
    from repro_torch.offload import (
        OffloadEngine,
        dist_hierarchical_scan,
        lower_spmd,
        passes,
        planner,
    )

    mesh = make_mesh(case.shape, case.names)
    x_np = case_input(case)
    x = None if x_np is None else payload_from_numpy(x_np, mesh.device)
    prm = dict(case.params)
    op = prm.get("op")
    smap = compat.shard_map

    def per_rank(fn, names=("i",)):
        if x is None:
            return smap(lambda: fn(None), mesh, (), names)()
        return smap(fn, mesh, (names,), names)(x)

    k = case.kind
    if k in ("scan", "exscan", "pair"):
        f = {"scan": dist_scan, "exscan": dist_exscan, "pair": dist_scan_pair}[k]
        out = per_rank(lambda t: f(t, op, "i", algorithm=prm["algorithm"]))
    elif k == "reduce":
        out = per_rank(lambda t: dist_reduce(t, op, "i", root=prm["root"]))
    elif k == "allreduce":
        out = per_rank(lambda t: dist_allreduce(
            t, op, "i", algorithm=prm["algorithm"]))
    elif k == "barrier":
        out = per_rank(lambda _: dist_barrier("i"))
    elif k == "plan":
        plan = case_plan(case, planner, passes)
        out = per_rank(lower_spmd(plan, case.names, op), spec_names(case, plan))
    elif k == "hier":
        algo = prm["algorithm"]
        out = per_rank(
            lambda t: dist_hierarchical_scan(
                t, op, "i", "o", inclusive=prm["inclusive"],
                inner_algorithm=algo, outer_algorithm=algo,
            ),
            ("o", "i"),
        )
    elif k == "engine":
        eng = OffloadEngine(device=mesh.device)
        planned = bool(prm.get("planned"))
        pinned = prm.get("backend") == "pallas"
        kw = dict(backend="pallas", chunks=1) if pinned else {}
        desc = eng.make_descriptor(
            prm["coll"], p=case.p, axes=case.shape if planned else None,
            payload_bytes=4 * N, op=op,
            data_type=_wire_dtype(prm["dtype"]), **kw,
        )
        names = case.names
        spec = tuple(names[i] for i in desc.split) if planned else names
        axis = names if planned else names[0]
        if prm["mode"] == "driver":
            out = eng.offload(desc, x, axis_name=axis, mesh=mesh)
        else:
            out = per_rank(lambda t: eng.offload(desc, t, axis_name=axis), spec)
        if eng.telemetry.dispatches != 1:
            raise AssertionError("one offload, one dispatch")
        if pinned and (eng.telemetry.backend_fallbacks
                       or not all(s.algo.startswith("pallas:")
                                  for s in eng._cache.values())):
            raise AssertionError("backend='pallas' fell back to the default")
    elif k == "workspace":
        out = per_rank(lambda _: workspace_trace(mesh))
    elif k == "staged":
        out = per_rank(lambda _: staged_permute(mesh))
    elif k == "phase":
        kind = planner.PhaseKind[prm["phase"]]
        out = per_rank(lambda t: spmd_collective.comm_phase_spmd_plain(
            kind, case.p, "i", get_operator(op), t,
            inclusive=prm["inclusive"]))
    elif k == "lower":
        plan = case_plan(case, planner, passes)
        out = per_rank(fused_collective.lower_fused(
            plan, op, axis_names=("i",)))
    else:
        raise ValueError(f"unknown case kind {k!r}")
    return tuple(a.cpu() for a in tree_leaves(out))


class FakeIpc:
    """K2's IPC calls without a GPU: a block is a number that names its rank
    and allocation, its handle says the same, and every call is logged."""

    def __init__(self, rank: int) -> None:
        self.rank, self.made, self.mapped, self.freed = rank, 0, set(), []

    def alloc(self, nbytes: int):
        self.made += 1
        return self.address(self.rank, self.made), \
            f"{self.rank}:{self.made}:{nbytes}".encode()

    @staticmethod
    def address(rank: int, made: int) -> int:
        return ((rank + 1) << 40) | (made << 32)

    def open(self, handle: bytes) -> int:
        rank, made, _ = (int(v) for v in handle.decode().split(":"))
        ptr = self.address(rank, made) | 0x800  # another process's mapping
        self.mapped.add(ptr)
        return ptr

    def close(self, ptr: int) -> None:
        self.mapped.remove(ptr)

    def free(self, ptr: int) -> None:
        self.freed.append(ptr)


#: (flag words, receive bytes) of the calls :func:`workspace_trace` makes
WORKSPACE_CALLS = ((10, 1000), (10, 1000), (5, 100), (10, 5000), (300, 5000))


def workspace_trace(mesh):
    """K2's peer workspace over ``mesh``'s process group with a
    :class:`FakeIpc`: registrations after each of :data:`WORKSPACE_CALLS`,
    the handles (rank, allocation) in the table after each, the tables'
    offsets from every rank's block, the blocks left mapped or unfreed
    after a release, and whether a group that disagrees raised (int64
    tensors)."""
    import torch

    from repro_torch.kernels.spmd_collective import _PeerWorkspace

    rank, p = mesh.ranks.group_rank, mesh.size
    ipc = FakeIpc(rank)
    ws = _PeerWorkspace(mesh.group, mesh.device, p, rank, ipc=ipc)
    regs, handles, offsets = [], [], []
    for flags, recv in WORKSPACE_CALLS:
        ws.reserve(flags, recv)
        regs.append(ws.registrations)
        handles.append([[int(v) for v in h.decode().split(":")[:2]]
                        for h in ws.handles])
        base = torch.tensor(ws.bases, dtype=torch.int64)
        offsets.append((ws.tables.cpu() - base).tolist()
                       + [[ws.flag_words, ws.recv_bytes] + [0] * (p - 2)])
    ws.release()
    left = [len(ipc.mapped), ipc.made - len(ipc.freed)]
    bad = _PeerWorkspace(mesh.group, mesh.device, p, rank, ipc=FakeIpc(rank))
    try:
        bad.reserve(10, 1000 * (rank + 1))  # the ranks disagree
        raised = 0
    except RuntimeError:
        raised = 1
    return (torch.tensor(regs), torch.tensor(handles), torch.tensor(offsets),
            torch.tensor(left + [raised]))


def staged_permute(mesh):
    """A cyclic ``ppermute`` of int32, float32 and bfloat16 leaves over the
    process group with the host staging forced on (as for CUDA leaves under
    gloo), beside the same permute unstaged; and how many host copies the
    staged one made (int64 tensors and the leaves)."""
    import torch

    ranks = mesh.ranks
    p, me = mesh.size, ranks.group_rank
    leaves = (torch.arange(6, dtype=torch.int32) + 100 * me,
              torch.linspace(-1, 1, 6) * (me + 1),
              (torch.arange(6, dtype=torch.float32) / 3 + me).bfloat16()[::2])
    perm = [(i, (i + 1) % p) for i in range(p)]
    plain = ranks.ppermute(leaves, "i", perm)
    copies = []
    cpu = torch.Tensor.cpu

    def counted(t, *a, **kw):
        copies.append(t.dtype)
        return cpu(t, *a, **kw)

    ranks.host_staged = lambda leaves: True  # this object only
    torch.Tensor.cpu = counted
    try:
        staged = ranks.ppermute(leaves, "i", perm)
    finally:
        torch.Tensor.cpu = cpu
        del ranks.host_staged
    same = [int(torch.equal(a, b) and a.dtype == b.dtype == c.dtype
                and a.device == c.device)
            for a, b, c in zip(staged, plain, leaves)]
    return (*staged, torch.tensor(same + [len(copies)]))


def _wire_dtype(name: str):
    from repro_torch.core.packet import WireDType

    return {"float32": WireDType.FLOAT32, "int32": WireDType.INT32}[name]


# ---------------------------------------------------------------------------
# the gloo run
# ---------------------------------------------------------------------------


def rank_device(rank: int, device: str):
    """Rank ``rank``'s device: the CPU, or on the card ``cuda:(rank %
    device_count)`` (every rank on ``cuda:0`` with one GPU, one rank a GPU
    where there are enough)."""
    import torch

    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda'; got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' needs a GPU; pass --device cpu")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def gloo_worker(p: int, rank: int, workdir: Path,
                body: Callable[[Callable], Dict[str, Any]], *,
                device: str = "cpu") -> None:
    """One process of a :func:`spawn_gloo` run: join the gloo group through
    the ``file://`` store under ``workdir``, call ``body(make_mesh)``
    (``make_mesh(shape, names)`` builds a mesh over the whole group on
    :func:`rank_device`), and save its results from rank 0."""
    import torch
    import torch.distributed as dist

    from repro_torch import compat
    from repro_torch.kernels import spmd_collective

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    torch.set_num_threads(1)
    dev = rank_device(rank, device)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir / 'store'}", world_size=p,
        rank=rank,
    )
    try:
        results = body(lambda shape, names: compat.Mesh(
            shape, names, device=dev, group=dist.group.WORLD))
        if rank == 0:
            torch.save(results, workdir / "results.pt")
        dist.barrier()
    finally:
        spmd_collective.release_peer_workspaces()
        dist.destroy_process_group()


def _worker(suite: str, p: int, rank: int, workdir: Path,
            device: str = "cpu") -> None:
    def body(make_mesh):
        results: Dict[str, Any] = {}
        for case in SUITES[suite](p):
            try:
                results[case.name] = run_case(case, make_mesh)
            except Exception as exc:  # every rank raises alike: go on
                results[case.name] = f"{type(exc).__name__}: {exc}"
        return results

    gloo_worker(p, rank, workdir, body, device=device)


def run_gloo(suite: str, p: int, workdir: "str | Path", *,
             timeout: float = 120.0, device: str = "cpu") -> Dict[str, Any]:
    """Run every case of ``suite`` in ``p`` processes joined in one gloo
    group (a ``file://`` store under ``workdir``), each rank on
    :func:`rank_device`; returns rank 0's results (case name -> tuple of CPU
    tensors, or the error text). Every process is killed if the run
    outlasts ``timeout`` seconds, which raises."""
    return spawn_gloo("repro_torch.testing.spmd_check",
                      ["--device", device, suite], p, workdir,
                      timeout=timeout)


def spawn_gloo(module: str, args: List[str], p: int, workdir: "str | Path",
               *, timeout: float = 120.0) -> Dict[str, Any]:
    """``python -m module *args P WORKDIR RANK`` in ``p`` processes, each
    killed if the spawn outlasts ``timeout`` seconds (which raises); returns
    what rank 0 saved to ``WORKDIR/results.pt``."""
    import torch

    suite = " ".join(args)
    workdir = Path(workdir).resolve()  # a file:// URL needs an absolute path
    workdir.mkdir(parents=True, exist_ok=True)
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", module, *args, str(p), str(workdir),
             str(rank)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(p)
    ]
    deadline = time.monotonic() + timeout
    logs: List[str] = []
    try:
        for proc in procs:
            left = max(0.1, deadline - time.monotonic())
            out, _ = proc.communicate(timeout=left)
            logs.append(out)
    except subprocess.TimeoutExpired:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGUSR1)  # gloo_worker: dump stacks
        time.sleep(1.0)
        for proc in procs:
            proc.kill()
        tails = [proc.communicate()[0][-2000:] for proc in procs[len(logs):]]
        raise TimeoutError(
            f"gloo run of {module} {suite} at p={p} outlasted {timeout} s; "
            "the unfinished ranks' output:\n" + "\n".join(tails)
        ) from None
    bad = [(r, proc.returncode) for r, proc in enumerate(procs)
           if proc.returncode != 0]
    if bad:
        raise RuntimeError(
            f"gloo ranks failed {bad}:\n" + "\n".join(l[-3000:] for l in logs)
        )
    return torch.load(workdir / "results.pt", weights_only=True)


def main(argv: List[str]) -> int:
    device = "cuda"
    if argv[:1] == ["--device"]:
        device, argv = argv[1], argv[2:]
    suite, p, workdir = argv[0], int(argv[1]), Path(argv[2])
    if len(argv) > 3:
        _worker(suite, p, int(argv[3]), workdir, device)
        return 0
    results = run_gloo(suite, p, workdir, device=device)
    errors = {k: v for k, v in results.items() if isinstance(v, str)}
    for name, err in errors.items():
        print(f"spmd_check,{suite},{name},p,{p},ERROR,{err}")
    print(f"spmd_check,{suite},p,{p},cases,{len(results)}")
    if errors:
        return 1
    print("ALL-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
