"""Measured-cost autotuner for the offload engine (PyTorch port of
``repro.offload.tuner``).

``select_algorithm`` defaults to :data:`~repro_torch.core.selector.
DEFAULT_LINK_MODEL`, the reference's unmeasured constants. This module
re-derives the cost model the way the paper's host runtime would: time
every schedule on the device the engine runs on over a (p, payload) grid,
record per-point winners, and least-squares fit the LinkModel's
alpha/beta/gamma against the :func:`~repro_torch.core.selector.cost_features`
design matrix. The result is a
:class:`~repro_torch.offload.tuning_cache.TuningCache` that, once activated,
replaces the static constants underneath every ``algorithm="auto"`` call.

All five descriptor coll kinds are measured — scan, exscan, reduce,
allreduce, barrier — so ``algorithm="auto"`` for every CollType resolves
against its *own* measured table. :func:`tune_splits` times whole planned
collectives for every logical axis order of each mesh shape;
:func:`tune_schedule` races (fused?, chunks) variants and lowering backends
("" against ``"pallas"``, K1).

Timing on a card uses CUDA events on the current stream, with a sync after
the end event; on the CPU, ``time.perf_counter``. A sample of ``inner = 1``
times the eager schedule the engine runs. ``inner > 1`` (the counterpart of
the reference's ``jit(fori_loop)``) times, on a card, one CUDA graph holding
``inner`` chained runs (each run's output is the next run's input), replayed
between the events and divided by ``inner``, so the per-dispatch host floor
is amortized out of the sample; the graph is freed after its grid point. A
schedule that cannot be captured raises, naming the plan: it is never timed
eagerly in its place. On the CPU the ``inner`` runs are chained eagerly.
Note that K1's host-side ``launches`` counter only moves at capture.

Every entry point runs on the card unless the caller passes
``device="cpu"``, and raises when CUDA is missing and the CPU was not asked
for.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.algorithms import ALGORITHMS
from repro_torch.core.operators import MAX, AssocOp, get_operator
from repro_torch.core.reduce_ops import sim_allreduce, sim_barrier, sim_reduce
from repro_torch.core.scan_collective import sim_scan
from repro_torch.core.trees import checked_device
from repro_torch.offload.tuning_cache import TuningCache

DEFAULT_PS: Tuple[int, ...] = (2, 4, 8, 16)
DEFAULT_PAYLOADS: Tuple[int, ...] = (1024, 65536, 1 << 20)
DEFAULT_COLLS: Tuple[str, ...] = (
    "scan", "exscan", "reduce", "allreduce", "barrier",
)
DEFAULT_TOPOLOGIES: Tuple[Tuple[int, ...], ...] = (
    (2, 4), (4, 2), (2, 8), (4, 4), (2, 2, 2), (2, 2, 4),
)
DEFAULT_CHUNKS: Tuple[int, ...] = (1, 2, 4, 8)


def _payload(p: int, payload_bytes: int, seed: int, device) -> torch.Tensor:
    n = max(1, payload_bytes // 4)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.normal(size=(p, n)).astype(np.float32)
    ).to(device)


def _sample_seconds(
    call: Callable[[], object], device: torch.device, iters: int,
    inner: int = 1,
) -> float:
    """Median seconds of ``call()`` over ``iters`` samples, each divided by
    ``inner``: CUDA events on the current stream (the device idle at the
    start event, a sync after the end event) on a card, ``perf_counter``
    on the CPU."""
    times = []
    for _ in range(max(1, iters)):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            stream = torch.cuda.current_stream(device)
            start.record(stream)
            call()
            end.record(stream)
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) * 1e-3 / inner)
        else:
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) / inner)
    times.sort()
    return times[len(times) // 2]


def _graph_seconds(
    chained: Callable, arg, device: torch.device, iters: int, inner: int,
    what: str,
) -> float:
    """Median seconds per run of ``chained(arg)`` (``inner`` chained runs)
    captured into one CUDA graph and replayed between CUDA events; the
    graph is freed before returning. Capture failures raise, naming
    ``what``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            chained(arg)  # warm-up off the default stream, as capture wants
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = chained(arg)
        except RuntimeError as e:
            raise RuntimeError(
                f"cannot capture {inner} chained runs of {what} into a CUDA "
                f"graph: {e}"
            ) from e
        try:
            graph.replay()
            return _sample_seconds(graph.replay, device, iters, inner)
        finally:
            del out
            graph.reset()


def _applicable(algo: str, op: AssocOp) -> bool:
    return algo != "invertible_doubling" or (
        op.inverse is not None and op.commutative
    )


def _sim_collective_fn(coll: str, algo: str, p: int, op: AssocOp, device):
    """The single-dispatch schedule for one measured coll kind."""
    if coll in ("scan", "exscan"):
        inclusive = coll == "scan"
        return lambda s: sim_scan(
            s, op, p, algorithm=algo, inclusive=inclusive
        )
    if coll == "reduce":
        return lambda s: sim_reduce(s, op, p, root=0, algorithm=algo)
    if coll == "allreduce":
        return lambda s: sim_allreduce(s, op, p, algorithm=algo)
    if coll == "barrier":
        return lambda _s: sim_barrier(p, algorithm=algo, device=device)
    raise ValueError(f"unknown coll kind {coll!r}")


def time_sim_collective(
    coll: str,
    algo: str,
    p: int,
    payload_bytes: int,
    op: "AssocOp | str" = "sum",
    *,
    iters: int = 5,
    seed: int = 0,
    device: "torch.device | str" = "cuda",
) -> float:
    """Median seconds of one schedule on the simulator backend, run eagerly
    as the engine's sim mode runs it (float32 payload from ``seed``)."""
    op = get_operator(op)
    device = checked_device(device, "the tuner")
    x = _payload(p, payload_bytes, seed, device)
    fn = _sim_collective_fn(coll, algo, p, op, device)
    fn(x)  # warm the allocator
    return _sample_seconds(lambda: fn(x), device, iters)


def autotune(
    *,
    ps: Sequence[int] = DEFAULT_PS,
    payloads: Sequence[int] = DEFAULT_PAYLOADS,
    colls: Sequence[str] = DEFAULT_COLLS,
    algorithms: Optional[Iterable[str]] = None,
    op: "AssocOp | str" = "sum",
    iters: int = 5,
    time_budget_s: Optional[float] = None,
    verbose: bool = False,
    device: "torch.device | str" = "cuda",
) -> TuningCache:
    """Micro-benchmark the full (coll, algo, p, payload) grid into a cache.

    ``time_budget_s`` bounds total wall clock: once exceeded, the remaining
    grid points are skipped (winners/fit use whatever was measured).
    """
    op = get_operator(op)
    device = checked_device(device, "the tuner")
    cache = TuningCache(device=device)
    algos = list(algorithms) if algorithms is not None else sorted(ALGORITHMS)
    t_start = time.perf_counter()
    skipped = 0
    for p in ps:
        for payload in payloads:
            for coll in colls:
                coll_op = MAX if coll == "barrier" else op
                coll_algos = [a for a in algos if _applicable(a, coll_op)]
                # allreduce (and barrier on top of it) runs the fixed
                # recursive-doubling butterfly at power-of-two p — the
                # algorithm argument only matters off-pow2, so measure one
                # representative schedule instead of one per algorithm
                if coll in ("allreduce", "barrier") and p & (p - 1) == 0:
                    coll_algos = coll_algos[:1] if (
                        "recursive_doubling" not in coll_algos
                    ) else ["recursive_doubling"]
                for algo in coll_algos:
                    if (
                        time_budget_s is not None
                        and time.perf_counter() - t_start > time_budget_s
                    ):
                        skipped += 1
                        continue
                    t = time_sim_collective(
                        coll, algo, p, payload, op, iters=iters,
                        device=device,
                    )
                    cache.record(coll, algo, p, payload, t)
                    if verbose:
                        print(
                            f"tune {coll:6s} p={p:3d} bytes={payload:8d} "
                            f"{algo:22s} {t*1e6:10.1f}us"
                        )
    if verbose and skipped:
        print(f"tune: time budget hit, skipped {skipped} grid points")
    # Materialize winners + fit eagerly so save() is cheap and callers can
    # inspect the result right away.
    cache.fitted_model()
    _ = cache.winners
    return cache


def amortize_inner(payload_bytes: int, cap: int = 16) -> int:
    """How many schedule runs to fold into one timed sample.

    Per-dispatch time at small payloads measures the host's dispatch floor,
    not the schedule: two schedules whose true costs differ 3x time
    identically. Chaining ``inner`` runs in one CUDA graph amortizes the
    floor away; large payloads keep ``inner`` small so one sample stays
    cheap."""
    if payload_bytes <= 4096:
        return cap
    if payload_bytes <= 65536:
        return min(cap, 4)
    return min(cap, 2)


def _plan_for_variant(coll, sizes, order, payload, op, optimized, chunking):
    """The exact plan :func:`time_planned_collective` times for one
    schedule-grid variant — used to capability-check non-default backends
    before spending a sample on them."""
    from repro_torch.offload.passes import optimize_plan
    from repro_torch.offload.planner import build_plan

    plan = build_plan(coll, sizes, op, payload, order=tuple(order))
    if optimized:
        plan = optimize_plan(plan)
    if chunking != 1:
        plan = dataclasses.replace(plan, chunking=int(chunking))
    return plan


def time_planned_collective(
    coll: str,
    sizes: Sequence[int],
    order: Sequence[int],
    payload_bytes: int,
    op: "AssocOp | str" = "sum",
    *,
    iters: int = 5,
    seed: int = 0,
    optimized: bool = False,
    chunking: int = 1,
    inner: int = 1,
    backend: str = "",
    device: "torch.device | str" = "cuda",
) -> float:
    """Median seconds of one whole planned collective on the sim backend,
    for a fixed logical axis order (``optimized=True`` times the
    pass-pipeline form of the same plan; ``chunking`` > 1 the
    chunked-streaming lowering of it; ``backend`` names a non-default
    lowering backend to time — raises when the plan is outside that
    backend's capabilities, so a sample is never silently the default).

    ``inner`` > 1 chains that many schedule runs (each run's output is the
    next run's input) in one CUDA graph on a card, or eagerly on the CPU,
    and divides by ``inner`` (see the module docstring)."""
    op = get_operator(op)
    device = checked_device(device, "the tuner")
    p_total = math.prod(int(s) for s in sizes)
    plan = _plan_for_variant(
        coll, sizes, order, payload_bytes, op, optimized, chunking
    )
    if backend:
        from repro_torch.offload import backends as registry

        run = registry.get_backend(backend).lower(plan, op, device=device)
    else:
        from repro_torch.offload.planner import lower_sim

        run = lower_sim(plan, op, device=device)
    inner = max(1, int(inner))
    if coll.lower() == "barrier":
        inner = 1  # the fence takes no payload to thread through iterations
        arg = None
    else:
        arg = _payload(p_total, payload_bytes, seed, device)

    def chained(a):
        for _ in range(inner):
            a = run(a)
        return a

    chained(arg)  # first run: index tensors, kernel library, allocator
    if device.type == "cuda" and inner > 1:
        what = (
            f"the {coll} plan over {tuple(sizes)} (order {tuple(order)}, "
            f"optimized={optimized}, chunks={chunking}, "
            f"backend={backend or 'default'})"
        )
        return _graph_seconds(chained, arg, device, iters, inner, what)
    return _sample_seconds(lambda: chained(arg), device, iters, inner)


def tune_splits(
    *,
    topologies: Sequence[Sequence[int]] = DEFAULT_TOPOLOGIES,
    payloads: Sequence[int] = (1024, 65536),
    colls: Sequence[str] = ("scan", "allreduce"),
    op: "AssocOp | str" = "sum",
    iters: int = 3,
    time_budget_s: Optional[float] = None,
    cache: Optional[TuningCache] = None,
    verbose: bool = False,
    device: "torch.device | str" = "cuda",
) -> TuningCache:
    """Measure every logical axis order of every mesh shape — the topology
    half of the autotuner. Winners feed ``plan_axis_order``; by construction
    the recorded winner is never slower than any fixed order measured."""
    op = get_operator(op)
    device = checked_device(device, "the tuner")
    cache = cache if cache is not None else TuningCache(device=device)
    t_start = time.perf_counter()
    skipped = 0
    for sizes in topologies:
        sizes = tuple(int(s) for s in sizes)
        for payload in payloads:
            for coll in colls:
                for order in itertools.permutations(range(len(sizes))):
                    if (
                        time_budget_s is not None
                        and time.perf_counter() - t_start > time_budget_s
                    ):
                        skipped += 1
                        continue
                    t = time_planned_collective(
                        coll, sizes, order, payload, op, iters=iters,
                        device=device,
                    )
                    cache.record_split(coll, sizes, order, payload, t)
                    if verbose:
                        print(
                            f"tune-split {coll:9s} {str(sizes):12s} "
                            f"order={order} bytes={payload:8d} "
                            f"{t*1e6:10.1f}us"
                        )
    if verbose and skipped:
        print(f"tune-split: time budget hit, skipped {skipped} points")
    _ = cache.split_winners
    return cache


def tune_schedule(
    *,
    topologies: Sequence[Sequence[int]] = DEFAULT_TOPOLOGIES,
    payloads: Sequence[int] = (1024, 65536),
    colls: Sequence[str] = ("scan", "exscan"),
    chunks: Sequence[int] = DEFAULT_CHUNKS,
    backends: Sequence[str] = ("", "pallas"),
    op: "AssocOp | str" = "sum",
    iters: int = 3,
    time_budget_s: Optional[float] = None,
    cache: Optional[TuningCache] = None,
    verbose: bool = False,
    device: "torch.device | str" = "cuda",
) -> TuningCache:
    """Measure the full (fused, unfused) x chunk-count schedule grid per
    (coll, mesh shape, payload) point. The recorded winners feed
    ``TuningCache.schedule_winner``, which ``choose_schedule`` (and through
    it ``make_descriptor``'s ``optimize="auto"`` / ``chunks="auto"``)
    consults before the plan cost model.

    ``backends`` also races each variant across lowering backends ("" is
    the op-per-round default, ``"pallas"`` the fused kernel, K1): variants
    outside a named backend's capabilities are skipped, never timed as the
    default, so every recorded row really ran what its ``backend`` column
    says. The cross-backend reduction (``TuningCache.backend_winner``)
    feeds ``choose_backend`` / ``make_descriptor(backend="auto")``. The
    fused kernel declines every multi-axis plan (and every chunked one):
    pass a one-axis topology such as ``(1, 8)`` to race it.

    Samples use amortized timing (:func:`amortize_inner`)."""
    op = get_operator(op)
    device = checked_device(device, "the tuner")
    cache = cache if cache is not None else TuningCache(device=device)
    chunk_grid = tuple(dict.fromkeys(int(c) for c in chunks)) or (1,)
    backend_grid = tuple(dict.fromkeys(str(b) for b in backends)) or ("",)
    t_start = time.perf_counter()
    skipped = 0
    unsupported = 0
    for sizes in topologies:
        sizes = tuple(int(s) for s in sizes)
        order = tuple(range(len(sizes)))
        for payload in payloads:
            inner = amortize_inner(payload)
            for coll in colls:
                # budget-check once per grid point: a half-measured grid
                # would record a categorical "winner" that was never
                # actually compared against its alternatives
                if (
                    time_budget_s is not None
                    and time.perf_counter() - t_start > time_budget_s
                ):
                    skipped += 1
                    continue
                for optimized in (False, True):
                    for c in chunk_grid:
                        for bname in backend_grid:
                            if bname:
                                from repro_torch.offload import (
                                    backends as registry,
                                )

                                plan = _plan_for_variant(
                                    coll, sizes, order, payload, op,
                                    optimized, c,
                                )
                                ok, _ = registry.get_backend(
                                    bname
                                ).capabilities(plan)
                                if not ok:
                                    unsupported += 1
                                    continue
                            t = time_planned_collective(
                                coll, sizes, order, payload, op,
                                iters=iters, optimized=optimized,
                                chunking=c, inner=inner, backend=bname,
                                device=device,
                            )
                            cache.record_schedule(
                                coll, sizes, optimized, c, payload, t,
                                backend=bname,
                            )
                            if verbose:
                                tag = "opt" if optimized else "raw"
                                if bname:
                                    tag = f"{tag}+{bname}"
                                print(
                                    f"tune-schedule {coll:9s} "
                                    f"{str(sizes):12s} "
                                    f"{tag} C={c} bytes={payload:8d} "
                                    f"{t*1e6:10.1f}us"
                                )
    if verbose and skipped:
        print(f"tune-schedule: time budget hit, skipped {skipped} points")
    if verbose and unsupported:
        print(
            f"tune-schedule: {unsupported} variant(s) outside a named "
            f"backend's capabilities were skipped"
        )
    _ = cache.schedule_winners
    return cache


def tune_fusion(
    *,
    topologies: Sequence[Sequence[int]] = DEFAULT_TOPOLOGIES,
    payloads: Sequence[int] = (1024, 65536),
    colls: Sequence[str] = ("scan", "exscan"),
    op: "AssocOp | str" = "sum",
    iters: int = 3,
    time_budget_s: Optional[float] = None,
    cache: Optional[TuningCache] = None,
    verbose: bool = False,
    device: "torch.device | str" = "cuda",
) -> TuningCache:
    """Measure each planned collective with the plan-optimizer passes on
    and off — :func:`tune_schedule` restricted to the unchunked schedule
    and the default lowering backend, kept as the cheap fusion-only entry
    point."""
    return tune_schedule(
        topologies=topologies, payloads=payloads, colls=colls,
        chunks=(1,), backends=("",), op=op, iters=iters,
        time_budget_s=time_budget_s, cache=cache, verbose=verbose,
        device=device,
    )
