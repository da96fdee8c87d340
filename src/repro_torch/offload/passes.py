"""Plan-optimizer pass pipeline (PyTorch port of ``repro.offload.passes``):
runs between ``build_plan`` and lowering. The passes are framework-free, so
with no active tuning table they resolve exactly as the reference's.

The paper's NetFPGA wins because the NIC folds the scan's combine, forward,
and total steps into ONE pass over the wire instead of issuing separate
host-driven rounds; Traeff's round-efficient Exscan analysis says the latency
term is dominated by round count, and sPIN argues offload pipelines should
fuse streaming stages rather than ping-pong to the host. This module applies
that lesson to the :class:`~repro_torch.offload.planner.CollectivePlan` IR, which
``build_plan`` emits as independent per-axis phases that each pay a full
round and re-derive the same permute chains:

  * :func:`fuse_scan_total` — **SCAN+TOTAL fusion.** For non-windowed
    associative operators the scan's last-rank value *is* the axis total, so
    an intra-axis SCAN phase followed by a TOTAL on the same axis and the
    same input register collapses into one ``FUSED_SCAN_TOTAL`` phase that
    emits both registers from a single communication schedule
    (:func:`repro_torch.core.algorithms.scan_total_schedule`,
    ``ceil(log2 p) + 1`` rounds instead of ``2*ceil(log2 p)``).
  * :func:`eliminate_dead_phases` — **dead-phase elimination.** Phases
    spanning size-1 logical axes are no-ops (a scan, total, reduce, or
    barrier over one rank returns its input; an exclusive scan returns the
    operator identity); they are removed by rewriting the register dataflow
    (aliases + identity tracking), COMBINE phases whose carry is a known
    identity or whose guard covers only size-1 levels fold away, and a
    backward liveness sweep drops phases whose outputs nothing consumes
    (redundant barriers included).
  * **Permute elimination** is a *flag*, not a phase rewrite:
    ``optimize_plan`` marks the plan ``optimized=True`` and the sim
    interpreter (:func:`~repro_torch.offload.planner.lower_sim`) threads register
    layouts through consecutive phases — the shared logical<->physical
    permute chain is computed once per plan, not once per phase, with
    COMBINE operands normalized back to the natural mesh order because the
    guard mask is built over the un-permuted logical mesh (the
    COMBINE-aware dataflow check).

Every pass is semantics-preserving: the optimized plan is bitwise-equal to
the unfused plan for every CollType and axis order given exact arithmetic.
:func:`plan_cost` prices the fused form, so
:func:`choose_optimization` (and through it ``make_descriptor``'s
``optimize="auto"``) picks fused vs. unfused per measured fusion winner
first, cost model second.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Set, Tuple

from repro_torch.core.algorithms import (
    DOUBLING_ALGORITHMS,
    algorithm_step_count,
    num_steps,
    scan_total_step_count,
)
from repro_torch.core.operators import AssocOp, get_operator
from repro_torch.core.packet import CollType
from repro_torch.core.selector import get_active_tuning
from repro_torch.offload.planner import (
    CollectivePlan,
    PhaseKind,
    PlanPhase,
    build_plan,
    plan_cost,
)

#: the pipeline, in application order (chunk_selection needs the request's
#: payload size, so it only runs when ``optimize_plan`` is given one)
PASS_NAMES: Tuple[str, ...] = (
    "dead_phase_elimination",
    "scan_total_fusion",
    "permute_threading",
    "chunk_selection",
)

#: chunk counts the selection pass prices and the tuner measures
CHUNK_CANDIDATES: Tuple[int, ...] = (1, 2, 4, 8)

#: algorithm tag rendered for fused phases (not a per-step schedule name —
#: the fused lowering dispatches on the phase kind)
FUSED_ALGORITHM = "fused_doubling"


# ---------------------------------------------------------------------------
# Dead-phase elimination (size-1 axes, identity carries, dead registers)
# ---------------------------------------------------------------------------


def eliminate_dead_phases(plan: CollectivePlan) -> CollectivePlan:
    """Drop phases that provably compute nothing, rewriting dataflow.

    Forward walk: phases over size-1 logical axes alias their output to
    their input (or mark it as the operator identity, for exclusive scans);
    COMBINE folds away when its carry is a known identity or every guarded
    level has size 1 (the guard mask is then all-True, i.e. "keep local"
    everywhere). Backward walk: liveness from the plan result removes
    phases whose outputs are never consumed — which is also what deletes
    the axis-total feeding a carry ladder that itself dissolved.
    """
    logical = plan.logical_sizes
    alias: Dict[str, str] = {}
    identity_regs: Set[str] = set()
    out: list = []

    def res(name: str) -> str:
        while name in alias:
            name = alias[name]
        return name

    def define(name: str) -> None:
        alias.pop(name, None)
        identity_regs.discard(name)

    for ph in plan.phases:
        src = tuple(res(s) for s in ph.src)
        if ph.kind == PhaseKind.COMBINE:
            carry, local = src
            guards = tuple(lv for lv in ph.guard_levels if logical[lv] > 1)
            if carry in identity_regs or (ph.guard_levels and not guards):
                # an empty carry (or an all-True guard) keeps local verbatim;
                # when dst already IS the local register the fold is a pure
                # no-op (its value — identity marker included — survives)
                if local != ph.dst:
                    define(ph.dst)
                    alias[ph.dst] = local
                continue
            if local in identity_regs:
                # the local side dissolved (exclusive scan over a size-1
                # level): materialize the identity so the guard still
                # selects between it and the carry
                out.append(
                    PlanPhase(PhaseKind.IDENTITY, -1, src=("x",), dst=local)
                )
                identity_regs.discard(local)
            define(ph.dst)
            out.append(
                dataclasses.replace(ph, src=src, guard_levels=guards)
            )
            continue
        if ph.kind == PhaseKind.IDENTITY:
            define(ph.dst)
            identity_regs.add(ph.dst)
            continue
        p_axis = logical[ph.level]
        if p_axis <= 1:
            # one rank along this level: the phase is the identity map
            # (exclusive scans yield the operator identity instead)
            if ph.kind == PhaseKind.FUSED_SCAN_TOTAL and src[0] != ph.dst2:
                define(ph.dst2)
                alias[ph.dst2] = src[0]
            if ph.kind in (
                PhaseKind.SCAN, PhaseKind.FUSED_SCAN_TOTAL
            ) and not ph.inclusive:
                define(ph.dst)
                identity_regs.add(ph.dst)
            elif src[0] != ph.dst:
                define(ph.dst)
                alias[ph.dst] = src[0]
            # else: an in-place no-op — the register (and any identity
            # marker it carries) is untouched
            continue
        if src[0] in identity_regs:
            # a kept communication phase consuming a known identity: keep
            # correctness by materializing it (build_plan never produces
            # this shape; re-optimized plans defensively might)
            out.append(
                PlanPhase(PhaseKind.IDENTITY, -1, src=("x",), dst=src[0])
            )
            identity_regs.discard(src[0])
        define(ph.dst)
        if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
            define(ph.dst2)
        out.append(dataclasses.replace(ph, src=src))

    result = res(plan.result)
    if result in identity_regs:
        out.append(PlanPhase(PhaseKind.IDENTITY, -1, src=("x",), dst=result))

    # backward liveness: drop phases no consumer (or the result) reads
    live: Set[str] = {result}
    kept: list = []
    for ph in reversed(out):
        defs = {ph.dst}
        if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
            defs.add(ph.dst2)
        if not defs & live:
            continue
        if ph.kind == PhaseKind.FUSED_SCAN_TOTAL and ph.dst not in live:
            # only the total output is consumed: demote to a plain TOTAL
            ph = PlanPhase(
                PhaseKind.TOTAL, ph.level, "recursive_doubling",
                src=ph.src, dst=ph.dst2,
            )
        elif ph.kind == PhaseKind.FUSED_SCAN_TOTAL and ph.dst2 not in live:
            ph = PlanPhase(
                PhaseKind.SCAN, ph.level, "hillis_steele",
                inclusive=ph.inclusive, src=ph.src, dst=ph.dst,
            )
        live.discard(ph.dst)
        live.update(ph.src)
        if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
            live.discard(ph.dst2)
            live.update(ph.src)
        kept.append(ph)
    kept.reverse()
    return dataclasses.replace(plan, phases=tuple(kept), result=result)


# ---------------------------------------------------------------------------
# SCAN+TOTAL fusion
# ---------------------------------------------------------------------------


def fuse_scan_total(plan: CollectivePlan) -> CollectivePlan:
    """Fuse each adjacent (SCAN, TOTAL) pair on one axis and one input.

    The pair pattern is exactly what ``build_plan`` emits for SCAN/EXSCAN
    at every ladder level: an intra-axis scan of register ``r`` directly
    followed by the order-respecting total of the same ``r`` along the same
    level. Both outputs then come from one
    :func:`~repro_torch.core.algorithms.scan_total_schedule` run. The dataflow
    check is structural: fusion requires the total to read the *same*
    register the scan read (never the scan's output), so reordering
    hazards cannot arise.
    """
    phases = plan.phases
    out: list = []
    i = 0
    while i < len(phases):
        ph = phases[i]
        if ph.kind == PhaseKind.SCAN and i + 1 < len(phases):
            nxt = phases[i + 1]
            if (
                nxt.kind == PhaseKind.TOTAL
                and nxt.level == ph.level
                and nxt.src == ph.src
                and ph.dst not in nxt.src
            ):
                out.append(
                    PlanPhase(
                        PhaseKind.FUSED_SCAN_TOTAL,
                        ph.level,
                        FUSED_ALGORITHM,
                        inclusive=ph.inclusive,
                        src=ph.src,
                        dst=ph.dst,
                        dst2=nxt.dst,
                    )
                )
                i += 2
                continue
        out.append(ph)
        i += 1
    return dataclasses.replace(plan, phases=tuple(out))


# ---------------------------------------------------------------------------
# Chunk selection
# ---------------------------------------------------------------------------


def _has_pipelined_phase(plan: CollectivePlan) -> bool:
    """Does any phase have a round-pipelined chunked form worth pricing?"""
    logical = plan.logical_sizes
    for ph in plan.phases:
        if ph.kind == PhaseKind.FUSED_SCAN_TOTAL and logical[ph.level] > 1:
            return True
        if (
            ph.kind == PhaseKind.SCAN
            and ph.algorithm in DOUBLING_ALGORITHMS
            and logical[ph.level] > 1
        ):
            return True
    return False


def select_chunking(
    plan: CollectivePlan,
    payload_bytes: int,
    *,
    candidates: Sequence[int] = CHUNK_CANDIDATES,
) -> CollectivePlan:
    """Pick the cheapest chunk count for one plan under the active cost
    model — the chunk-selection pass.

    Each candidate C prices the pipelined phases as ``(R + C - 1) *
    (alpha + B*beta/C)`` (see :func:`~repro_torch.offload.planner.plan_cost`), so
    C > 1 only wins above the payload threshold where the serialized link
    term outweighs the extra pipeline-fill alphas; ties keep the smaller C
    (C=1 is the exact legacy lowering, byte-stable on the wire). Plans with
    no pipelined phase (pure reductions, non-doubling scan algorithms) stay
    at C=1 unconditionally.
    """
    if not _has_pipelined_phase(plan):
        return plan if plan.chunking == 1 else dataclasses.replace(
            plan, chunking=1
        )
    best: Optional[Tuple[float, int]] = None
    for c in sorted({max(1, int(c)) for c in candidates}):
        cand = dataclasses.replace(plan, chunking=c)
        key = (plan_cost(cand, payload_bytes), c)
        if best is None or key < best:
            best = key
    chosen = best[1]
    if chosen == plan.chunking:
        return plan
    return dataclasses.replace(plan, chunking=chosen)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def optimize_plan(
    plan: CollectivePlan,
    *,
    passes: Sequence[str] = PASS_NAMES,
    payload_bytes: Optional[int] = None,
) -> CollectivePlan:
    """Run the pass pipeline over one plan; idempotent.

    ``passes`` subsets :data:`PASS_NAMES` (unknown names raise). The
    returned plan carries ``optimized=True``, which (a) switches
    ``lower_sim`` to the layout-threading interpreter (permute
    elimination) and (b) marks the wire flag ``make_descriptor`` encodes so
    brokered and cached dispatches agree on whether passes ran.
    ``chunk_selection`` needs the request's payload size to price the
    pipeline, so it only runs when ``payload_bytes`` is given.
    """
    unknown = set(passes) - set(PASS_NAMES)
    if unknown:
        raise ValueError(
            f"unknown passes {sorted(unknown)}; known: {list(PASS_NAMES)}"
        )
    if "dead_phase_elimination" in passes:
        plan = eliminate_dead_phases(plan)
    if "scan_total_fusion" in passes:
        plan = fuse_scan_total(plan)
    if "permute_threading" in passes and not plan.optimized:
        plan = dataclasses.replace(plan, optimized=True)
    if "chunk_selection" in passes and payload_bytes is not None:
        plan = select_chunking(plan, payload_bytes)
    return plan


# ---------------------------------------------------------------------------
# Round accounting and the fused-vs-unfused decision
# ---------------------------------------------------------------------------


def plan_comm_rounds(plan: CollectivePlan) -> int:
    """Communication rounds (permute steps on the critical path) of a plan.

    This is the quantity the paper's offload collapses and the number
    ``BENCH_fusion.json`` reports: COMBINE/IDENTITY phases are local (zero
    rounds); an exclusive scan pays its structural shift unless the
    inverse-op trick applies; allreduce-shaped phases (TOTAL/BARRIER) run
    the butterfly at power-of-two sizes and scan+broadcast otherwise; a
    REDUCE pays one root-relocation hop when the root is not rank p-1.
    """
    op = get_operator(plan.op_name)
    logical = plan.logical_sizes
    rounds = 0
    for ph in plan.phases:
        if ph.kind in (PhaseKind.COMBINE, PhaseKind.IDENTITY):
            continue
        p = logical[ph.level]
        if p <= 1:
            continue
        if ph.kind == PhaseKind.SCAN:
            r = algorithm_step_count(ph.algorithm, p)
            if not ph.inclusive and not (
                ph.algorithm == "invertible_doubling"
                and op.inverse is not None
                and op.commutative
            ):
                r += 1
        elif ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
            r = scan_total_step_count(p)
        elif ph.kind in (PhaseKind.TOTAL, PhaseKind.BARRIER):
            r = (
                num_steps(p)
                if p & (p - 1) == 0
                else algorithm_step_count(ph.algorithm, p) + 1
            )
        elif ph.kind == PhaseKind.REDUCE:
            r = algorithm_step_count(ph.algorithm, p)
            if ph.root != p - 1:
                r += 1
        else:  # pragma: no cover - exhaustive
            raise ValueError(f"unknown phase kind {ph.kind!r}")
        rounds += r
    return rounds


def choose_optimization(
    coll: "CollType | str",
    sizes: Sequence[int],
    payload_bytes: int,
    op: "AssocOp | str" = "sum",
) -> bool:
    """Should the pass pipeline run for this request? The ``optimize="auto"``
    resolution ``make_descriptor`` uses.

    Resolution mirrors the selector: a measured fusion winner from the
    active tuning table (``TuningCache.fusion_winner``) rules when one
    exists for this (coll, sizes) at a nearby payload; otherwise the
    optimized and raw plans are priced with :func:`plan_cost` and the
    optimized form wins ties (it never adds rounds). A plan the passes
    cannot change at all reports False, so the wire flag stays meaningful.
    """
    if isinstance(coll, str):
        coll = CollType[coll.upper()]
    op = get_operator(op)
    sizes = tuple(int(s) for s in sizes)

    tuning = get_active_tuning()
    if tuning is not None:
        winner = getattr(tuning, "fusion_winner", lambda *a, **k: None)(
            coll.name.lower(), sizes, payload_bytes
        )
        if winner is not None:
            return bool(winner)

    raw = build_plan(coll, sizes, op, payload_bytes, order="auto")
    opt = optimize_plan(raw)
    if opt.phases == raw.phases:
        return False
    return plan_cost(opt, payload_bytes) <= plan_cost(raw, payload_bytes)


def choose_schedule(
    coll: "CollType | str",
    sizes: Sequence[int],
    payload_bytes: int,
    op: "AssocOp | str" = "sum",
) -> Tuple[bool, int]:
    """The full (optimize?, chunk count) schedule decision for one request
    — what ``make_descriptor``'s ``optimize="auto"`` / ``chunks="auto"``
    resolves through.

    Resolution mirrors the selector: a measured schedule winner from the
    active tuning table (``TuningCache.schedule_winner``, written by
    ``tune_schedule``) rules when one exists for this (coll, sizes) at a
    nearby payload; otherwise the pass pipeline's own cost pricing decides
    both halves (fusion via the fused-vs-raw comparison, chunking via
    :func:`select_chunking` on whichever form won).
    """
    if isinstance(coll, str):
        coll = CollType[coll.upper()]
    op = get_operator(op)
    sizes = tuple(int(s) for s in sizes)

    tuning = get_active_tuning()
    if tuning is not None:
        winner = getattr(tuning, "schedule_winner", lambda *a, **k: None)(
            coll.name.lower(), sizes, payload_bytes
        )
        if winner is not None:
            return bool(winner[0]), max(1, int(winner[1]))

    raw = build_plan(coll, sizes, op, payload_bytes, order="auto")
    opt = optimize_plan(raw, payload_bytes=payload_bytes)
    if opt.phases != raw.phases and plan_cost(
        opt, payload_bytes
    ) <= plan_cost(raw, payload_bytes):
        return True, opt.chunking
    return False, select_chunking(raw, payload_bytes).chunking


def choose_backend(
    coll: "CollType | str",
    sizes: Sequence[int],
    payload_bytes: int,
    op: "AssocOp | str" = "sum",
) -> str:
    """Which lowering backend should lower this request? The
    ``backend="auto"`` resolution ``make_descriptor`` uses.

    Purely measurement-driven: a backend winner recorded by
    ``tune_schedule`` in the active tuning table
    (``TuningCache.backend_winner``) rules when one exists for this
    (coll, sizes) at a nearby payload; untuned requests return the mode
    default ("", wire backend id 0) — there is no cost model for the fused
    kernel, so nothing speculative ever changes a descriptor's bytes. A
    measured winner still goes through the registry's capability check at
    compile time (soft fallback), so a stale table cannot break dispatch.
    """
    if isinstance(coll, str):
        coll = CollType[coll.upper()]
    sizes = tuple(int(s) for s in sizes)

    tuning = get_active_tuning()
    if tuning is not None:
        winner = getattr(tuning, "backend_winner", lambda *a, **k: None)(
            coll.name.lower(), sizes, payload_bytes
        )
        if winner is not None:
            return str(winner)
    return ""


__all__ = [
    "CHUNK_CANDIDATES",
    "FUSED_ALGORITHM",
    "PASS_NAMES",
    "choose_backend",
    "choose_optimization",
    "choose_schedule",
    "eliminate_dead_phases",
    "fuse_scan_total",
    "optimize_plan",
    "plan_comm_rounds",
    "select_chunking",
]
