"""K2 with one rank per process, checked and timed: the engine's spmd and
driver modes over a gloo group whose ranks each hold one rank's data, with
``backend="pallas"`` (K2's peers path, one launch a comm phase) and with the
default backend (the spmd rounds) on the same descriptors, against the
co-resident K2 and the plain version on the same seeded stacked input.

What every rank runs (:func:`jobs`), over one flat group of ``p`` ranks, as
the engine's planned request over axes ``(1, p)``:

* spmd mode: SCAN and EXSCAN over sum on int32, float32 and bfloat16
  (a scan over max or min is outside K2's envelope, as in the reference);
  ALLREDUCE over sum, max and min on int32 and float32 and sum on bfloat16;
  the hand-fused FUSED_SCAN_TOTAL plan (inclusive and exclusive, both
  outputs) through the fused backend's per-rank lowering; BARRIER;
  at 4 B, 1 KiB, 64 KiB and 1 MiB a rank;
* driver mode: SCAN and ALLREDUCE sum on float32 at 1 KiB and 1 MiB;
* with ``repeat``: that many SCANs back to back, each on its own seeded
  input, at 1 KiB and 1 MiB a rank (a rank that finishes a launch may start
  the next while a partner still reads the last: the slot reuse);
* the timing: SCAN and ALLREDUCE sum on float32 at every size, each
  dispatch on the host clock (synchronized) and between CUDA events on the
  rank's stream, K2 and the spmd rounds in turns (K2, rounds, rounds, K2);
  K2's plain version at the SCAN sizes.

A rank reports a SHA-256 digest of its own output of every job, the K2
launches each job made (held to the plan's comm phases), and its times;
rank 0 gathers them. :func:`check` spawns the ranks, computes the expected
stacked results with the co-resident K2 (on the card) and the plain version
(on the CPU), and holds every rank's digest to both, bitwise.

    python -m repro_torch.testing.procs_check [--device cpu] [--small] P WORKDIR

spawns ``P`` ranks (rank ``r`` on ``cuda:(r % device_count)``, or the CPU)
joined through a ``file://`` store under ``WORKDIR`` and prints ALL-OK. On
one GPU the ranks are ``P`` processes whose contexts the GPU time-slices:
their times are those of time-sliced contexts on one card, not a network's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import sys
import time
import zlib
from pathlib import Path
from statistics import median
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: bytes a rank of the checked jobs
SIZES = (4, 1 << 10, 64 << 10, 1 << 20)
SMALL_SIZES = (4, 1 << 10)
#: back-to-back SCANs: at this p, this many a size
REPEAT_P, REPEAT = 4, 200
REPEAT_SIZES = (1 << 10, 1 << 20)
#: timed dispatches each way: warm-up, then turns of this many (K2, rounds,
#: rounds, K2): a median of 2 * TURN
WARM, TURN = 3, 10
NAMES = ("o", "i")
EXACT = [(op, dt) for op in ("sum", "max", "min") for dt in ("int32", "float32")]


@dataclasses.dataclass(frozen=True)
class Job:
    name: str
    form: str        # "engine" or "fused"
    mode: str        # "spmd" or "driver"
    coll: str        # SCAN, EXSCAN, ALLREDUCE, BARRIER, or FUSED
    op: str
    dtype: str
    nbytes: int      # a rank's payload
    inclusive: bool = True
    result: str = "y"  # the fused plan's output
    seed: int = 0    # a back-to-back SCAN's input

    @property
    def n(self) -> int:
        return max(1, self.nbytes // (2 if self.dtype == "bfloat16" else 4))


def _job(form, mode, coll, op, dtype, nbytes, **kw) -> Job:
    extra = "".join(f":{k}={v}" for k, v in sorted(kw.items()))
    return Job(f"{form}:{mode}:{coll}:{op}:{dtype}:{nbytes}{extra}", form,
               mode, coll, op, dtype, nbytes, **kw)


def jobs(p: int, sizes: Sequence[int] = SIZES, repeat: int = 0) -> List[Job]:
    """Every job of one run at ``p`` ranks (see the module's docstring)."""
    out: List[Job] = []
    for nb in sizes:
        for coll in ("SCAN", "EXSCAN"):
            for dt in ("int32", "float32", "bfloat16"):
                out.append(_job("engine", "spmd", coll, "sum", dt, nb))
        for op, dt in EXACT + [("sum", "bfloat16")]:
            out.append(_job("engine", "spmd", "ALLREDUCE", op, dt, nb))
        for inclusive in (True, False):
            for result in ("y", "t"):
                out.append(_job("fused", "spmd", "FUSED", "sum", "float32", nb,
                                inclusive=inclusive, result=result))
    out.append(_job("engine", "spmd", "BARRIER", "max", "float32", 4))
    for nb in sorted({sizes[1], sizes[-1]}):
        for coll in ("SCAN", "ALLREDUCE"):
            out.append(_job("engine", "driver", coll, "sum", "float32", nb))
    for nb in [nb for nb in REPEAT_SIZES if nb <= sizes[-1]] if repeat else ():
        for k in range(repeat):
            out.append(_job("engine", "spmd", "SCAN", "sum", "float32", nb,
                            seed=k + 1))
    return out


def row_input(job: Job, rank: int) -> Optional[np.ndarray]:
    """Rank ``rank``'s seeded input of ``job`` (None for BARRIER)."""
    if job.coll == "BARRIER":
        return None
    key = f"{job.coll}:{job.op}:{job.dtype}:{job.nbytes}:{job.seed}:{rank}"
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    if job.dtype == "int32":
        return rng.integers(-1000, 1000, job.n).astype(np.int32)
    return rng.standard_normal(job.n).astype(np.float32)


def stacked_input(job: Job, p: int, torch, device):
    """The stacked ``(p, n)`` input of ``job`` on ``device`` (None for
    BARRIER)."""
    rows = [row_input(job, r) for r in range(p)]
    if rows[0] is None:
        return None
    x = torch.from_numpy(np.stack(rows)).to(device)
    return x.to(getattr(torch, job.dtype))


def digest(torch, t) -> str:
    """SHA-256 of a tensor's bytes (its dtype and shape included)."""
    t = t.detach().contiguous().cpu()
    h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
    h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _plan(job: Job, p: int):
    """The hand-fused FUSED_SCAN_TOTAL plan of a fused job."""
    from repro_torch.offload.planner import PhaseKind, PlanPhase, build_plan

    base = build_plan("SCAN" if job.inclusive else "EXSCAN", (p,), job.op,
                      job.nbytes, level_algorithms=("hillis_steele",))
    phase = PlanPhase(PhaseKind.FUSED_SCAN_TOTAL, 0, "fused_doubling",
                      inclusive=job.inclusive, src=("x",), dst="y", dst2="t")
    return dataclasses.replace(base, phases=(phase,), result=job.result)


class Runner:
    """One group's dispatches of jobs, by backend: ``"pallas"`` (K2) or
    ``""`` (the default, the spmd rounds)."""

    def __init__(self, eng, mesh, p: int) -> None:
        self.eng, self.mesh, self.p = eng, mesh, p
        self._descs: Dict[Tuple[str, str], Any] = {}
        self._fused: Dict[Tuple[str, str], Any] = {}

    def descriptor(self, job: Job, backend: str):
        from repro_torch.core.packet import WireDType

        key = (job.name, backend)
        desc = self._descs.get(key)
        if desc is None:
            desc = self.eng.make_descriptor(
                job.coll, axes=(1, self.p), payload_bytes=job.nbytes,
                op=job.op, data_type=WireDType[job.dtype.upper()],
                backend="pallas", chunks=1)
            # the same descriptor with the default backend
            desc = dataclasses.replace(desc, backend=backend)
            self._descs[key] = desc
        return desc

    def comm_phases(self, job: Job) -> int:
        """K2 launches one dispatch of ``job`` makes: its comm phases."""
        from repro_torch.kernels.fused_collective import _COMM_KINDS

        if job.form == "fused":
            return 1
        plan, _ = self.eng._plan_for(self.descriptor(job, "pallas"))
        return sum(ph.kind in _COMM_KINDS and plan.logical_sizes[ph.level] > 1
                   for ph in plan.phases)

    def call(self, job: Job, backend: str, x):
        """One dispatch: in spmd mode with this rank's ``x`` (call it under
        the meshes' binding), in driver mode with the stacked ``x``."""
        if job.form == "fused":
            fn = self._fused.get((job.name, backend))
            if fn is None:
                from repro_torch.offload import backends

                fn = backends.get_backend(backend or "spmd").lower(
                    _plan(job, self.p), job.op, axis_names=("i",))
                self._fused[(job.name, backend)] = fn
            return fn(x)
        desc = self.descriptor(job, backend)
        if job.mode == "driver":
            return self.eng.offload(desc, x, axis_name=NAMES, mesh=self.mesh)
        return self.eng.offload(desc, x, axis_name=NAMES)


def _bound(runner: Runner):
    from repro_torch import compat

    return compat.bind_meshes([runner.mesh])


def rank_body(p: int, rank: int, device, make_mesh, *, sizes, repeat):
    """What one rank runs and reports (rank 0's report holds every rank's)."""
    import torch
    import torch.distributed as dist

    from repro_torch import OffloadEngine
    from repro_torch.core.operators import SUM
    from repro_torch.kernels import spmd_collective as k2
    from repro_torch.kernels.spmd_collective import comm_phase_spmd_plain
    from repro_torch.offload.planner import PhaseKind

    cuda = device.type == "cuda"
    eng = OffloadEngine(device=device)
    runner = Runner(eng, make_mesh((1, p), NAMES), p)
    todo = jobs(p, sizes, repeat)

    def own(job):
        row = row_input(job, rank)
        if row is None:
            return None
        return torch.from_numpy(row).to(device).to(getattr(torch, job.dtype))

    digests: Dict[str, Dict[str, str]] = {"pallas": {}, "": {}}
    launch_errors: List[str] = []
    k2.launches = 0
    for key in k2.path_launches:
        k2.path_launches[key] = 0
    t0 = time.perf_counter()
    for backend in ("pallas", ""):
        for job in todo:
            before = k2.path_launches["peers"]
            if job.mode == "driver":
                got = runner.call(job, backend, stacked_input(job, p, torch,
                                                              device))[rank]
            else:
                with _bound(runner):
                    got = runner.call(job, backend, own(job))
            made = k2.path_launches["peers"] - before
            want = runner.comm_phases(job) if backend and cuda else 0
            if made != want:
                launch_errors.append(f"{job.name} [{backend or 'spmd'}]: "
                                     f"{made} K2 launches, {want} planned")
            digests[backend][job.name] = digest(torch, got)
    run_s = time.perf_counter() - t0
    counts = {"launches": k2.launches, "path_launches": dict(k2.path_launches)}

    # the timing: K2 and the spmd rounds in turns
    timed = [j for j in jobs(p, sizes) if j.form == "engine" and j.mode == "spmd"
             and j.op == "sum" and j.dtype == "float32"
             and j.coll in ("SCAN", "ALLREDUCE")]
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    times = []
    for job in timed:
        x = own(job)
        samples = {"pallas": ([], []), "": ([], [])}
        with _bound(runner):
            for backend in ("pallas", "", "", "pallas"):
                host, events = samples[backend]
                for i in range(WARM + TURN):
                    if cuda:
                        ev = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    sync()
                    start = time.perf_counter()
                    if cuda:
                        ev[0].record()
                    runner.call(job, backend, x)
                    if cuda:
                        ev[1].record()
                    sync()
                    if i >= WARM:
                        host.append((time.perf_counter() - start) * 1e3)
                        if cuda:
                            events.append(ev[0].elapsed_time(ev[1]))
            row = {"coll": job.coll, "bytes_per_rank": job.nbytes}
            for backend, label in (("pallas", "k2"), ("", "spmd")):
                host, events = samples[backend]
                row[f"{label}_host_ms"] = median(host)
                row[f"{label}_event_ms"] = median(events) if events else None
            if job.coll == "SCAN":
                # K2's plain version: its rounds as per-rank permutes
                host, events = [], []
                for i in range(WARM + 2 * TURN):
                    sync()
                    start = time.perf_counter()
                    if cuda:
                        ev = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                        ev[0].record()
                    comm_phase_spmd_plain(PhaseKind.SCAN, p, "i", SUM, x)
                    if cuda:
                        ev[1].record()
                    sync()
                    if i >= WARM:
                        host.append((time.perf_counter() - start) * 1e3)
                        if cuda:
                            events.append(ev[0].elapsed_time(ev[1]))
                row["plain_host_ms"] = median(host)
                row["plain_event_ms"] = median(events) if events else None
        times.append(row)

    mine = {"rank": rank, "device": str(device), "digests": digests,
            "launch_errors": launch_errors, "counts": counts,
            "times": times, "run_s": run_s}
    every: List[Any] = [None] * p
    dist.all_gather_object(every, mine)
    return {"p": p, "ranks": every, "jobs": [dataclasses.asdict(j) for j in todo]}


def expected(p: int, todo: Sequence[Job], device) -> Dict[str, List[List[str]]]:
    """Per job, the digests of every rank's row of the co-resident K2 (on
    ``device``) and of the plain version (on the CPU), in that order."""
    import torch

    from repro_torch import OffloadEngine, compat

    out: Dict[str, List[List[str]]] = {}
    for where in (device, torch.device("cpu")):
        eng = OffloadEngine(device=where)
        runner = Runner(eng, compat.Mesh((1, p), NAMES, device=where), p)
        for job in todo:
            x = stacked_input(job, p, torch, where)
            if job.form == "fused":
                # the per-rank lowering over co-resident ranks
                got = compat.shard_map(
                    lambda t: runner.call(job, "pallas", t), runner.mesh,
                    (NAMES,), NAMES)(x)
            else:
                desc = runner.descriptor(job, "pallas")
                got = eng.offload(desc, x, axis_name=NAMES, mesh=runner.mesh)
            out.setdefault(job.name, []).append(
                [digest(torch, got[r]) for r in range(p)])
        if where.type == "cuda":
            torch.cuda.synchronize()
    return out


def check(p: int, workdir: "str | Path", *, device: str = "cuda",
          small: bool = False, repeat: Optional[int] = None,
          timeout: float = 600.0) -> Dict[str, Any]:
    """Spawn ``p`` ranks, then hold every rank's digest of every job to the
    co-resident K2's and the plain version's, bitwise, and every rank's K2
    launches to the plan's comm phases; returns a summary (raises on a
    mismatch)."""
    import torch

    from repro_torch.testing.spmd_check import spawn_gloo

    sizes = SMALL_SIZES if small else SIZES
    if device == "cuda":
        # built once here: the ranks only load the library
        from repro_torch.kernels._build import load_library

        load_library("spmd_collective")
    if repeat is None:
        repeat = REPEAT if p == REPEAT_P else 0
    args = ["--device", device] + (["--small"] if small else []) \
        + ["--repeat", str(repeat)]
    t0 = time.perf_counter()
    got = spawn_gloo("repro_torch.testing.procs_check", args, p, workdir,
                     timeout=timeout)
    spawn_s = time.perf_counter() - t0
    todo = jobs(p, sizes, repeat)
    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    t0 = time.perf_counter()
    want = expected(p, todo, dev)
    expect_s = time.perf_counter() - t0
    bad: List[str] = []
    for r, rank in enumerate(got["ranks"]):
        bad += [f"rank {r}: {e}" for e in rank["launch_errors"]]
        for job in todo:
            coresident, plain = (w[r] for w in want[job.name])
            if coresident != plain:
                bad.append(f"{job.name} rank {r}: co-resident K2 != plain")
            for backend, label in (("pallas", "K2 peers"), ("", "spmd rounds")):
                if rank["digests"][backend][job.name] != plain:
                    bad.append(f"{job.name} rank {r}: {label} != plain")
    if bad:
        raise AssertionError(f"procs p={p}: {len(bad)} mismatches: {bad[:8]}")
    launches = [rank["counts"]["path_launches"]["peers"]
                for rank in got["ranks"]]
    return {
        "p": p, "jobs": len(todo), "ranks": len(got["ranks"]),
        "dispatches_per_rank": 2 * len(todo),
        "peers_launches_per_rank": launches,
        "devices": sorted({rank["device"] for rank in got["ranks"]}),
        "times": [rank["times"] for rank in got["ranks"]],
        "run_s": max(rank["run_s"] for rank in got["ranks"]),
        "spawn_s": spawn_s, "expected_s": expect_s,
    }


def main(argv: List[str]) -> int:
    device, small, repeat = "cuda", False, None
    while argv and argv[0].startswith("--"):
        flag = argv.pop(0)
        if flag == "--device":
            device = argv.pop(0)
        elif flag == "--small":
            small = True
        elif flag == "--repeat":
            repeat = int(argv.pop(0))
        else:
            raise SystemExit(f"unknown flag {flag}")
    p, workdir = int(argv[0]), Path(argv[1])
    if len(argv) > 2:
        from repro_torch.testing.spmd_check import gloo_worker, rank_device

        rank = int(argv[2])
        dev = rank_device(rank, device)
        gloo_worker(p, rank, workdir, lambda make_mesh: rank_body(
            p, rank, dev, make_mesh, sizes=SMALL_SIZES if small else SIZES,
            repeat=repeat or 0), device=device)
        return 0
    summary = check(p, workdir, device=device, small=small, repeat=repeat)
    print(f"procs_check,p,{p},jobs,{summary['jobs']},peers_launches,"
          f"{summary['peers_launches_per_rank']}")
    print("ALL-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
