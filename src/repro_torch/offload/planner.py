"""Topology-aware collective planner (PyTorch port of
``repro.offload.planner``): N-level decomposition for every CollType.

The paper's NetFPGA ran one collective over one 8-host ring; the host runtime
made an "intelligent selection" of the per-ring algorithm. At pod scale the
runtime must select the *decomposition* too: which mesh axis each phase spans,
in which order, and which schedule runs on each axis.

  * :class:`CollectivePlan` — the IR: a tuple of :class:`PlanPhase` records
    over *logical levels* (level 0 outermost in global rank order, the last
    level innermost), plus the mapping of logical levels onto physical mesh
    axes (the ``split``).
  * :func:`build_plan` — builds the phase list for any CollType x mesh shape.
  * :func:`plan_axis_order` — the tuned split (active tuning table first,
    then the cost model).
  * :func:`lower_sim` — lowers one plan over stacked ``(p, ...)`` tensors on
    one device; :func:`lower_spmd` lowers it per rank inside
    :func:`repro_torch.compat.shard_map`. They are the mode defaults of the
    lowering-backend registry (:mod:`repro_torch.offload.backends`), which
    also hosts the fused-kernel lowering
    (:mod:`repro_torch.kernels.fused_collective`).

The plan IR, costing and split choice are framework-free and identical to
the reference's: ``describe()`` text matches line for line
(``tests/test_torch_planner.py``).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import algorithms as alg
from repro_torch.core.operators import MAX, AssocOp, get_operator
from repro_torch.core.packet import MAX_AXES, CollType
from repro_torch.core.reduce_ops import allreduce_schedule, reduce_schedule
from repro_torch.core.scan_collective import dist_exscan, dist_scan, sim_scan
from repro_torch.core.selector import (
    DEFAULT_LINK_MODEL,
    LinkModel,
    estimate_cost,
    get_active_tuning,
    select_algorithm,
)
from repro_torch.core.trees import resolve_device, tree_device, tree_map
from repro_torch.obs import health as obs_health
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.runtime import chaos as runtime_chaos

PyTree = Any


class PhaseKind(enum.IntEnum):
    """What one plan phase does. All but COMBINE/IDENTITY span one axis."""

    SCAN = 0      # intra-axis prefix (inclusive or exclusive)
    TOTAL = 1     # order-respecting allreduce along the axis (block totals)
    REDUCE = 2    # tree reduction to a root coordinate along the axis
    BARRIER = 3   # zero-payload fence along the axis
    COMBINE = 4   # local fold of a carry into a prefix, guarded at level 0
    FUSED_SCAN_TOTAL = 5  # scan AND axis total from one schedule (passes)
    IDENTITY = 6  # local: materialize the operator identity (passes)


# coll kind each phase kind tunes against in the measured tables
_PHASE_COLL = {
    PhaseKind.TOTAL: "allreduce",
    PhaseKind.REDUCE: "reduce",
    PhaseKind.BARRIER: "barrier",
}


@dataclasses.dataclass(frozen=True)
class PlanPhase:
    """One step of a CollectivePlan.

    ``level`` indexes the *logical* axis the phase spans (COMBINE and
    IDENTITY are local: level is -1). ``src``/``dst`` name registers of the
    plan interpreter; COMBINE reads ``src = (carry, local)`` and keeps
    ``local`` unchanged on ranks whose coordinates are zero along every
    level in ``guard_levels`` (the ranks whose carry is empty).
    FUSED_SCAN_TOTAL writes two registers: ``dst`` receives the scan and
    ``dst2`` the axis total, both from one communication schedule.
    """

    kind: PhaseKind
    level: int
    algorithm: str = "hillis_steele"
    inclusive: bool = True
    root: int = 0
    src: Tuple[str, ...] = ("x",)
    dst: str = "y"
    dst2: str = ""
    guard_levels: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """The planner IR: phases + the logical-to-physical axis mapping.

    ``sizes`` are the physical mesh-axis sizes (outermost-first, as the
    descriptor carries them); ``order[i]`` is the physical axis placed at
    logical level ``i``. ``logical_sizes`` is therefore the shape the flat
    rank range factors into, outermost level first.
    """

    coll: CollType
    op_name: str
    sizes: Tuple[int, ...]
    order: Tuple[int, ...]
    phases: Tuple[PlanPhase, ...]
    result: str = "y"
    optimized: bool = False
    #: payload chunk count. 1 = the classic whole-payload schedule (the
    #: lowerings take the exact legacy code path). C > 1 splits the payload
    #: into C contiguous chunks along its innermost dim and pipelines them
    #: across exchange rounds (sPIN-style streaming); values are bitwise
    #: identical, only the round interleave changes.
    chunking: int = 1

    @property
    def logical_sizes(self) -> Tuple[int, ...]:
        return tuple(self.sizes[i] for i in self.order)

    @property
    def p(self) -> int:
        return math.prod(self.sizes)

    def describe(self) -> str:
        """One line per phase — the plan's schedule_trace analogue.

        Optimized plans render their fused phases and ONE permute-chain line
        for the whole plan (the layout moves the threaded interpreter makes)
        instead of the implicit per-phase to-front/to-back pair, which is
        what keeps ``planner_check`` output readable after the pass
        pipeline has rewritten the phase list.
        """
        header = (
            f"{self.coll.name} over {self.sizes} split={self.order} "
            f"(logical {self.logical_sizes})"
        )
        if self.optimized:
            header += " [optimized]"
        if self.chunking > 1:
            header += f" [chunked x{self.chunking}]"
        lines = [header]
        for ph in self.phases:
            if ph.kind == PhaseKind.COMBINE:
                lines.append(
                    f"  combine {ph.src[0]} into {ph.src[1]} -> {ph.dst} "
                    f"(guard levels {ph.guard_levels})"
                )
            elif ph.kind == PhaseKind.IDENTITY:
                lines.append(f"  identity {ph.src[0]} -> {ph.dst} (local)")
            elif ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
                extra = "" if ph.inclusive else " exclusive"
                lines.append(
                    f"  fused_scan_total{extra} level {ph.level} "
                    f"(p={self.logical_sizes[ph.level]}) [{ph.algorithm}] "
                    f"{ph.src[0]} -> {ph.dst}, {ph.dst2}"
                )
            else:
                extra = "" if ph.inclusive else " exclusive"
                lines.append(
                    f"  {ph.kind.name.lower()}{extra} level {ph.level} "
                    f"(p={self.logical_sizes[ph.level]}) "
                    f"[{ph.algorithm}] {ph.src[0]} -> {ph.dst}"
                )
        if self.optimized:
            moves = plan_layout_moves(self)
            chain = (
                " -> ".join(
                    f"{reg}@{'nat' if lv is None else f'L{lv}'}"
                    for reg, lv in moves
                )
                if moves
                else "(none)"
            )
            lines.append(
                f"  permute chain (once per plan, {len(moves)} moves): "
                f"{chain}"
            )
        return "\n".join(lines)


def plan_layout_moves(plan: "CollectivePlan") -> Tuple[Tuple[str, Any], ...]:
    """The per-plan permute chain: each ``(register, level)`` is one
    ``moveaxis`` the threaded sim interpreter performs (``level`` is the
    logical level moved to the front; ``None`` is the natural mesh order —
    a fronted-to-fronted conversion goes via natural, so it renders as two
    entries, exactly mirroring ``lower_sim``'s ``get_reg``).

    The unoptimized interpreter fronts every phase operand and moves every
    output straight back — one move per input plus one per output, always.
    The optimized interpreter (``plan.optimized``) keeps each register in
    its produced layout and converts lazily, *memoizing every view*, so a
    register consumed twice in one layout pays its conversion once: the
    shared logical<->physical permute chain is computed once per plan, not
    once per phase. This function is the exact static form of that
    bookkeeping, used by :meth:`CollectivePlan.describe` and the
    pass-pipeline tests (for plans with ``optimized=False`` it reports the
    per-phase front-and-back chain instead).
    """
    moves: list = []
    views: Dict[str, set] = {}

    def define(name: str, layout) -> None:
        views[name] = {layout}

    def fetch(name: str, want) -> None:
        have = views.setdefault(name, {None})
        if want in have:
            return
        if None not in have:
            moves.append((name, None))
            have.add(None)
        if want is not None:
            moves.append((name, want))
            have.add(want)

    for ph in plan.phases:
        if ph.kind == PhaseKind.COMBINE:
            fetch(ph.src[0], None)
            fetch(ph.src[1], None)
            define(ph.dst, None)
        elif ph.kind == PhaseKind.IDENTITY:
            fetch(ph.src[0], None)
            define(ph.dst, None)
        elif plan.optimized:
            fetch(ph.src[0], ph.level)
            define(ph.dst, ph.level)
            if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
                define(ph.dst2, ph.level)
        else:
            # _along_axis fronts the operand and moves every output back
            # to natural immediately, with no view sharing
            moves.append((ph.src[0], ph.level))
            moves.append((ph.dst, None))
            define(ph.dst, None)
            if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
                moves.append((ph.dst2, None))
                define(ph.dst2, None)
    fetch(plan.result, None)
    return tuple(moves)


@dataclasses.dataclass(frozen=True)
class PlanLayout:
    """The logical<->physical data layout a plan's split implies.

    A non-identity split changes global rank order: logical level ``i`` runs
    over physical axis ``order[i]``, so the flat rank that owns block ``r`` of
    a logical-rank-ordered payload is *not* ``r``. This object owns the two
    flat permutations (as reshape/transpose, exact for any payload dims) so
    callers never hand-derive the transpose again:

      * :meth:`to_physical` — logical-rank-ordered leading axis -> physical
        (lex over the physical mesh axes, outermost first);
      * :meth:`to_logical` — the inverse;
      * :meth:`spec_axes` — the physical axis *names* in logical order.
    """

    sizes: Tuple[int, ...]
    order: Tuple[int, ...]

    def __post_init__(self):
        if sorted(self.order) != list(range(len(self.sizes))):
            raise ValueError(
                f"order {self.order!r} is not a permutation of "
                f"range({len(self.sizes)})"
            )

    @property
    def logical_sizes(self) -> Tuple[int, ...]:
        return tuple(self.sizes[i] for i in self.order)

    @property
    def inverse(self) -> Tuple[int, ...]:
        """``inverse[physical_axis] = logical_level`` (the transpose axes)."""
        inv = [0] * len(self.order)
        for level, axis in enumerate(self.order):
            inv[axis] = level
        return tuple(inv)

    @property
    def p(self) -> int:
        return math.prod(self.sizes)

    def spec_axes(self, axis_names: Sequence[str]) -> Tuple[str, ...]:
        """Physical mesh-axis names reordered to logical (split) order."""
        if len(axis_names) != len(self.sizes):
            raise ValueError(
                f"layout spans {len(self.sizes)} axes; got names {axis_names}"
            )
        return tuple(axis_names[i] for i in self.order)

    def _permute(self, x, from_sizes, axes):
        k = len(self.sizes)
        lead = tuple(x.shape[1:])
        arr = x.reshape(tuple(from_sizes) + lead)
        perm = tuple(axes) + tuple(range(k, k + len(lead)))
        if isinstance(x, np.ndarray):
            arr = np.transpose(arr, perm)
        else:
            arr = arr.permute(perm)
        return arr.reshape((self.p,) + lead)

    def to_physical(self, x):
        """Logical-rank-ordered leading axis -> physical rank order."""
        return self._permute(x, self.logical_sizes, self.inverse)

    def to_logical(self, x):
        """Physical-rank-ordered leading axis -> logical rank order."""
        return self._permute(x, self.sizes, self.order)

    def permutation(self) -> np.ndarray:
        """``perm[physical_rank] = logical_rank`` as a flat index vector."""
        return np.asarray(
            self.to_physical(np.arange(self.p, dtype=np.int64))
        )


def plan_layout(plan) -> PlanLayout:
    """Layout for anything carrying a split: a :class:`CollectivePlan`
    (``sizes``/``order``) or an encoded-topology descriptor (``axes``/
    ``split`` — an empty split means the identity order)."""
    sizes = getattr(plan, "sizes", None)
    if sizes is None:
        sizes = getattr(plan, "axes", None)
    if not sizes:
        raise ValueError(f"{plan!r} carries no multi-axis topology")
    sizes = tuple(int(s) for s in sizes)
    order = getattr(plan, "order", None)
    if order is None:
        order = getattr(plan, "split", None)
    order = tuple(int(i) for i in order) if order else tuple(range(len(sizes)))
    return PlanLayout(sizes=sizes, order=order)


# ---------------------------------------------------------------------------
# Plan construction
# ---------------------------------------------------------------------------


def _phase_algorithm(
    kind: PhaseKind,
    inclusive: bool,
    p_axis: int,
    payload_bytes: int,
    op: AssocOp,
    override: Optional[str],
) -> str:
    if override is not None and override != "auto":
        return override
    if kind == PhaseKind.SCAN:
        coll = "scan" if inclusive else "exscan"
    else:
        coll = _PHASE_COLL[kind]
    if kind == PhaseKind.BARRIER:
        # the fence runs MAX on a token regardless of the request's operator,
        # so applicability (e.g. invertible_doubling) is judged against MAX
        op, payload_bytes = MAX, 4
    return select_algorithm(p_axis, payload_bytes, op, coll=coll)


def _exscan_phases(
    levels: Sequence[int],
    src: str,
    out: str,
    tag: str,
    algo: Callable[[PhaseKind, bool, int], str],
) -> Tuple[PlanPhase, ...]:
    """Recursive exclusive scan of ``src`` over the flattened ``levels``
    (outermost..innermost) into register ``out`` — the carry ladder."""
    if len(levels) == 1:
        lv = levels[0]
        return (
            PlanPhase(
                PhaseKind.SCAN, lv, algo(PhaseKind.SCAN, False, lv),
                inclusive=False, src=(src,), dst=out,
            ),
        )
    inner = levels[-1]
    local = f"{tag}e{inner}"
    totals = f"{tag}t{inner}"
    carry = f"{tag}c{inner}"
    phases = (
        PlanPhase(
            PhaseKind.SCAN, inner, algo(PhaseKind.SCAN, False, inner),
            inclusive=False, src=(src,), dst=local,
        ),
        PlanPhase(
            PhaseKind.TOTAL, inner, algo(PhaseKind.TOTAL, True, inner),
            src=(src,), dst=totals,
        ),
    )
    phases += _exscan_phases(levels[:-1], totals, carry, tag + "o", algo)
    phases += (
        PlanPhase(
            PhaseKind.COMBINE, -1, src=(carry, local), dst=out,
            guard_levels=tuple(levels[:-1]),
        ),
    )
    return phases


def build_plan(
    coll: "CollType | str",
    sizes: Sequence[int],
    op: "AssocOp | str",
    payload_bytes: int,
    *,
    order: "str | Sequence[int]" = "auto",
    root: int = 0,
    inclusive: bool = True,
    level_algorithms: Optional[Sequence[Optional[str]]] = None,
    optimize: bool = False,
) -> CollectivePlan:
    """Build the N-level plan for one collective over one mesh shape.

    Args:
      coll: descriptor CollType (EXSCAN implies the exclusive scan form).
      sizes: physical mesh-axis sizes, outermost first (1-3 axes).
      op: operator (affects algorithm applicability, not phase structure).
      payload_bytes: per-rank payload, priced by the per-phase selector.
      order: "auto" for the tuned split, or an explicit permutation of
        ``range(len(sizes))`` mapping logical levels to physical axes.
      root: flat root rank (REDUCE only) — decomposed into per-level
        coordinates in logical rank order.
      level_algorithms: optional per-*logical-level* algorithm override
        (None or "auto" entries fall back to the selector); used by the
        legacy hierarchical wrappers.
      optimize: run the plan-optimizer pass pipeline
        (:func:`repro_torch.offload.passes.optimize_plan`) over the built plan —
        SCAN+TOTAL fusion, dead-phase elimination, permute threading. With
        ``order="auto"`` the tuned split is also priced on optimized plans.
    """
    if isinstance(coll, str):
        coll = CollType[coll.upper()]
    op = get_operator(op)
    sizes = tuple(int(s) for s in sizes)
    if not 1 <= len(sizes) <= MAX_AXES:
        raise ValueError(f"need 1..{MAX_AXES} mesh axes, got {sizes}")
    if any(s < 1 for s in sizes):
        raise ValueError(f"axis sizes must be positive: {sizes}")
    if order == "auto":
        order = plan_axis_order(
            coll, sizes, payload_bytes, op, optimize=optimize
        )
    order = tuple(int(i) for i in order)
    if sorted(order) != list(range(len(sizes))):
        raise ValueError(
            f"order {order!r} is not a permutation of range({len(sizes)})"
        )
    logical = tuple(sizes[i] for i in order)
    k = len(logical)

    def algo(kind: PhaseKind, incl: bool, level: int) -> str:
        override = None
        if level_algorithms is not None:
            override = level_algorithms[level]
        return _phase_algorithm(
            kind, incl, logical[level], payload_bytes, op, override
        )

    if coll == CollType.EXSCAN:
        inclusive = False

    if coll in (CollType.SCAN, CollType.EXSCAN):
        innermost = k - 1
        phases: Tuple[PlanPhase, ...] = (
            PlanPhase(
                PhaseKind.SCAN, innermost,
                algo(PhaseKind.SCAN, inclusive, innermost),
                inclusive=inclusive, src=("x",), dst="y",
            ),
        )
        if k > 1:
            phases += (
                PlanPhase(
                    PhaseKind.TOTAL, innermost,
                    algo(PhaseKind.TOTAL, True, innermost),
                    src=("x",), dst="t",
                ),
            )
            phases += _exscan_phases(tuple(range(k - 1)), "t", "c", "", algo)
            phases += (
                PlanPhase(
                    PhaseKind.COMBINE, -1, src=("c", "y"), dst="y",
                    guard_levels=tuple(range(k - 1)),
                ),
            )
        result = "y"
    elif coll in (CollType.REDUCE, CollType.ALLREDUCE, CollType.BARRIER):
        # one phase per level, innermost first, chained through "y" — the
        # per-axis tree reduce / ordered total / fence all share this shape
        kind = {
            CollType.REDUCE: PhaseKind.REDUCE,
            CollType.ALLREDUCE: PhaseKind.TOTAL,
            CollType.BARRIER: PhaseKind.BARRIER,
        }[coll]
        coords = (0,) * k
        if coll == CollType.REDUCE:
            if not 0 <= root < math.prod(sizes):
                raise ValueError(f"root={root} out of range for mesh {sizes}")
            coords = _unflatten(root, logical)
        phases = ()
        src = "x"
        for level in range(k - 1, -1, -1):
            phases += (
                PlanPhase(
                    kind, level, algo(kind, True, level),
                    root=coords[level], src=(src,), dst="y",
                ),
            )
            src = "y"
        result = "y"
    else:
        raise ValueError(f"unknown coll_type {coll!r}")

    plan = CollectivePlan(
        coll=coll,
        op_name=op.name,
        sizes=sizes,
        order=order,
        phases=phases,
        result=result,
    )
    if optimize:
        from repro_torch.offload.passes import optimize_plan

        plan = optimize_plan(plan, payload_bytes=payload_bytes)
    return plan


def _unflatten(rank: int, logical_sizes: Sequence[int]) -> Tuple[int, ...]:
    """Flat rank -> per-level coordinates in logical (lex) order."""
    coords = []
    rem = rank
    for s in reversed(logical_sizes):
        coords.append(rem % s)
        rem //= s
    return tuple(reversed(coords))


# ---------------------------------------------------------------------------
# Plan costing and the tuned axis split
# ---------------------------------------------------------------------------


def plan_cost(
    plan: CollectivePlan,
    payload_bytes: int,
    model: Optional[LinkModel] = None,
) -> float:
    """Predicted latency: sum of the per-phase alpha-beta-gamma estimates.

    COMBINE and IDENTITY phases are local (zero network cost); a REDUCE
    phase pays one extra root-relocation hop on top of its tree schedule. A
    FUSED_SCAN_TOTAL phase is priced as its own schedule — ``log2(p)+1``
    rounds carrying two payloads per doubling step — which is what lets the
    tuner and ``plan_axis_order`` trade the fused form (roughly half the
    rounds, one payload traversal) against the unfused pair (the alpha term
    halves; the beta term gains one extra payload, so huge messages can
    still prefer the unfused plan).

    Chunked plans (``plan.chunking > 1``) price their pipelined phases as
    ``(R + C - 1) * (alpha + B*beta/C)``: R rounds of per-round payload B
    split into C chunks, with chunk c's round r overlapping chunk c+1's
    round r-1, so the pipeline is R + C - 1 steps each carrying one chunk.
    At C=1 this reduces exactly to the unchunked ``R*alpha + R*B*beta``.
    Chunking therefore wins only when the serialized link term ``B*beta``
    outweighs the extra pipeline-fill alphas — i.e. above a payload
    threshold near ``(C/(C-1)) * (C-1)/(R-1) * alpha/beta`` — which is what
    keeps small payloads at C=1.
    """
    if model is None:
        tuning = get_active_tuning()
        fitted = tuning.fitted_model() if tuning is not None else None
        model = fitted if fitted is not None else DEFAULT_LINK_MODEL
    logical = plan.logical_sizes
    C = max(1, int(plan.chunking))
    total = 0.0

    def pipelined(rounds: int, nbytes: int, hops: float) -> float:
        return (
            (rounds + C - 1) * (model.alpha + nbytes * model.beta / C)
            + hops * model.gamma
        )

    for ph in plan.phases:
        if ph.kind in (PhaseKind.COMBINE, PhaseKind.IDENTITY):
            continue
        p_axis = logical[ph.level]
        if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
            if p_axis > 1:
                # each doubling step is one full-duplex pairwise exchange
                # (prefix forward, suffix back between the same pair) —
                # priced like recursive_doubling's butterfly: one payload
                # per step — plus the final single-hop suffix shift
                lg = alg.num_steps(p_axis)
                up_hops = sum(
                    min(1 << i, p_axis - (1 << i)) if model.ring else 1 << i
                    for i in range(lg)
                )
                total += pipelined(lg + 1, payload_bytes, up_hops + 1.0)
            continue
        if (
            ph.kind == PhaseKind.SCAN
            and C > 1
            and ph.algorithm in alg.DOUBLING_ALGORITHMS
            and p_axis > 1
        ):
            # the pipelined doubling form; the exclusive structural shift
            # rides the pipeline as one extra round
            lg = alg.num_steps(p_axis)
            shift = 0 if ph.inclusive else 1
            hops = float(shift) + sum(
                min(1 << i, p_axis - (1 << i)) if model.ring else 1 << i
                for i in range(lg)
            )
            total += pipelined(lg + shift, payload_bytes, hops)
            continue
        nbytes = 4 if ph.kind == PhaseKind.BARRIER else payload_bytes
        total += estimate_cost(ph.algorithm, p_axis, nbytes, model)
        if ph.kind == PhaseKind.REDUCE and p_axis > 1:
            total += model.alpha + nbytes * model.beta + model.gamma
    return total


def plan_axis_order(
    coll: "CollType | str",
    sizes: Sequence[int],
    payload_bytes: int,
    op: "AssocOp | str" = "sum",
    *,
    optimize: bool = False,
) -> Tuple[int, ...]:
    """Choose the logical axis order (the split) for one topology.

    Resolution mirrors ``select_algorithm``: a measured split winner from the
    active tuning table rules when one exists for this (coll, sizes) at a
    nearby payload; otherwise every permutation is priced with
    :func:`plan_cost` under the fitted-or-static LinkModel. Ties keep the
    physical order (identity split) for stability. With ``optimize=True``
    every candidate is run through the pass pipeline before pricing, so the
    chosen split is the one that is cheapest *after* fusion and dead-phase
    elimination — a split that exposes a fusible SCAN+TOTAL pair can beat
    one that looks cheaper raw.
    """
    if isinstance(coll, str):
        coll = CollType[coll.upper()]
    op = get_operator(op)
    sizes = tuple(int(s) for s in sizes)
    n = len(sizes)
    if n == 1:
        return (0,)

    tuning = get_active_tuning()
    if tuning is not None:
        winner = getattr(tuning, "split_winner", lambda *a, **k: None)(
            coll.name.lower(), sizes, payload_bytes
        )
        if winner is not None and sorted(winner) == list(range(n)):
            return tuple(winner)

    if optimize:
        from repro_torch.offload.passes import optimize_plan

    best: Optional[Tuple[float, int, Tuple[int, ...]]] = None
    identity = tuple(range(n))
    for perm in itertools.permutations(range(n)):
        plan = build_plan(
            coll, sizes, op, payload_bytes, order=perm,
            root=0, inclusive=True,
        )
        if optimize:
            plan = optimize_plan(plan)
        cost = plan_cost(plan, payload_bytes)
        key = (cost, 0 if perm == identity else 1, perm)
        if best is None or key < best:
            best = key
    return best[2]


# ---------------------------------------------------------------------------
# Lowering: the sim (stacked tensors) interpreter
# ---------------------------------------------------------------------------


def _sim_scan_chunked(
    backend: "alg.Backend",
    stacked: PyTree,
    op: AssocOp,
    p: int,
    *,
    algorithm: str,
    inclusive: bool,
    chunks: int,
) -> PyTree:
    """Chunked ``sim_scan``: identical values, pipelined exchange rounds.

    Only the doubling family has a round-pipelined form; other algorithms
    (and payloads that cannot be split — e.g. scalar-per-rank leaves, whose
    last axis on the sim backend is the *rank* axis) fall back to the plain
    whole-payload schedule. The exclusive handling mirrors ``sim_scan``
    line for line.
    """
    if (
        p == 1
        or algorithm not in alg.DOUBLING_ALGORITHMS
        or not alg.chunkable(stacked, chunks, min_ndim=2)
    ):
        return sim_scan(
            stacked, op, p, algorithm=algorithm, inclusive=inclusive,
            backend=backend,
        )
    if inclusive:
        return alg.chunked_scan_schedule(backend, stacked, op, chunks=chunks)
    identity = op.identity_like(stacked)
    rank = backend.rank()
    if (
        algorithm == "invertible_doubling"
        and op.inverse is not None
        and op.commutative
    ):
        inc = alg.chunked_scan_schedule(backend, stacked, op, chunks=chunks)
        ex = op.combine(inc, op.inverse(stacked))
        return alg._bwhere(rank != 0, ex, identity)
    out = alg.chunked_scan_schedule(
        backend, stacked, op, chunks=chunks, shift_first=True,
        identity=None if op.zero_identity else identity,
    )
    return alg._bwhere(rank != 0, out, identity)


def _spmd_scan_chunked(
    backend: "alg.SpmdBackend",
    x: PyTree,
    op: AssocOp,
    *,
    algorithm: str,
    inclusive: bool,
    chunks: int,
) -> PyTree:
    """Chunked ``dist_scan``/``dist_exscan`` body over one named axis.

    Mirrors those functions exactly (including the exclusive form's
    *absence* of a final rank-0 mask on the structural path — the shifted
    identity fill already leaves rank 0 holding the identity). A payload
    splits only along a per-rank axis: co-resident leaves carry one more
    leading dim (the stacked ranks) than a process's own.
    """
    from repro_torch import compat

    p = backend.p
    min_ndim = 1 + compat.rank_dims(backend.axis_name)
    if (
        p == 1
        or algorithm not in alg.DOUBLING_ALGORITHMS
        or not alg.chunkable(x, chunks, min_ndim=min_ndim)
    ):
        if inclusive:
            return dist_scan(x, op, backend.axis_name, algorithm=algorithm)
        return dist_exscan(x, op, backend.axis_name, algorithm=algorithm)
    if inclusive:
        return alg.chunked_scan_schedule(backend, x, op, chunks=chunks)
    identity = op.identity_like(x)
    if algorithm == "invertible_doubling" and op.inverse is not None:
        if not op.commutative:
            raise ValueError(
                "inverse-based exscan requires a commutative operator; "
                f"{op.name!r} is not"
            )
        inc = alg.chunked_scan_schedule(backend, x, op, chunks=chunks)
        ex = op.combine(inc, op.inverse(x))
        rank = backend.rank()
        return alg._bwhere(rank == 0, identity, ex)
    return alg.chunked_scan_schedule(
        backend, x, op, chunks=chunks, shift_first=True,
        identity=None if op.zero_identity else identity,
    )


def _chunked_scan_total(
    backend: "alg.Backend",
    tree: PyTree,
    op: AssocOp,
    *,
    inclusive: bool,
    chunks: int,
    min_ndim: int = 1,
) -> Tuple[PyTree, PyTree]:
    """Fused scan+total with the pipelined chunked schedule when the payload
    splits, else the plain fused schedule."""
    if backend.p == 1 or not alg.chunkable(tree, chunks, min_ndim=min_ndim):
        return alg.scan_total_schedule(backend, tree, op, inclusive=inclusive)
    return alg.chunked_scan_total_schedule(
        backend, tree, op, chunks=chunks, inclusive=inclusive
    )


def _along_axis(tree: PyTree, axis: int, fn: Callable[[PyTree], PyTree]) -> PyTree:
    """Run a leading-rank-axis schedule along mesh axis ``axis`` of stacked
    leaves; the other mesh axes ride along as payload dims."""
    moved = tree_map(lambda a: torch.movedim(a, axis, 0), tree)
    out = fn(moved)
    return tree_map(lambda a: torch.movedim(a, 0, axis), out)


def _zero_coord_mask(
    logical_sizes: Sequence[int],
    guard_levels: Sequence[int],
    device: "torch.device | str",
) -> torch.Tensor:
    """Boolean (logical mesh)-shaped mask: True where every guarded level's
    coordinate is zero (the ranks whose incoming carry is empty)."""
    k = len(logical_sizes)
    mask = torch.ones(tuple(logical_sizes), dtype=torch.bool, device=device)
    for lv in guard_levels:
        coord = torch.arange(logical_sizes[lv], device=device).reshape(
            (1,) * lv + (logical_sizes[lv],) + (1,) * (k - 1 - lv)
        )
        mask = mask & (coord == 0)
    return mask


def _check_device(x: PyTree, device: torch.device) -> None:
    got = tree_device(x)
    if got != device:
        raise ValueError(
            f"payload lives on {got} but the schedule was lowered for "
            f"{device}; move it explicitly"
        )


def lower_sim(
    plan: CollectivePlan,
    op: "AssocOp | str | None" = None,
    *,
    device: "torch.device | str" = "cuda",
    traced: bool = False,
):
    """Compile a plan to a function over flat stacked ``(p, ...)`` leaves on
    ``device`` (a payload on another device raises).

    The input's leading axis is the flat rank in logical order; internally it
    is reshaped to the logical mesh shape, phases run along single mesh axes,
    and the output is flattened back — directly comparable (bitwise, given
    exact arithmetic) to the flat single-axis reference collective.

    Each comm phase keeps one :class:`~repro_torch.core.algorithms.SimBackend`
    for the life of the lowering, so the index tensors of its permutes are
    made on the first call only: a schedule run once can then be captured
    into a CUDA graph (the tuner's amortized timing does).

    With ``traced=True`` the interpreter emits one ``phase``-category span
    per plan phase and one ``round``-category span per communication round
    (every ``backend.permute``, via
    :class:`repro_torch.obs.tracing.TracingBackend`, which synchronizes the
    device on each permuted result so the span's duration is the round's
    whole cost). It resolves the active tracer at call time, so one traced
    callable serves successive ``tracing()`` contexts; phase and round
    latencies also land in the shared metrics registry
    (``repro_phase_latency_us`` / ``repro_round_latency_us``). The traced
    path performs the same arithmetic as the untraced one, and the engine
    caches it under its own key, so the default path is untouched.

    A traced lowering also reads the chaos injector
    (:mod:`repro_torch.runtime.chaos`) at call time: while a scope is
    active, :class:`~repro_torch.runtime.chaos.ChaosBackend` wraps every
    comm phase's backend, with or without a collecting tracer (the engine
    routes planned sim dispatches here under a scope). The untraced
    lowering never reads it, so a CUDA graph captured from it can replay no
    fault. Under a tracer with ``link_probe=True``,
    :class:`~repro_torch.obs.health.LinkProbeBackend` splits each round
    into per-message ``link`` spans.

    Interpreter layouts: the unoptimized path moves every phase operand to
    the front and back again. For an *optimized* plan (``plan.optimized``)
    the interpreter threads layouts: every register remembers which logical
    level is currently fronted and converts lazily, memoizing each view
    (``plan_layout_moves`` is the static form). COMBINE operands are
    normalized to the natural mesh order first, because its guard mask is
    built over the un-permuted logical mesh. Both interpreters compute
    identical values.
    """
    op = get_operator(plan.op_name if op is None else op)
    device = resolve_device(device)
    logical = plan.logical_sizes
    k = len(logical)
    p_total = plan.p
    threaded = plan.optimized
    chunks = max(1, int(plan.chunking))
    coll_name = plan.coll.name.lower()
    sim_backends = [alg.SimBackend(p_axis, device) for p_axis in logical]

    def to_mesh(tree: PyTree) -> PyTree:
        return tree_map(lambda a: a.reshape(logical + tuple(a.shape[1:])), tree)

    def to_flat(tree: PyTree) -> PyTree:
        return tree_map(
            lambda a: a.reshape((p_total,) + tuple(a.shape[k:])), tree
        )

    def run(x: Optional[PyTree]) -> PyTree:
        # register name -> {layout: view}; layout None is the natural mesh
        # order, an int means that logical level is moved to axis 0
        regs: Dict[str, Dict[Optional[int], PyTree]] = {}

        def set_reg(name: str, tree: PyTree, layout: Optional[int]) -> None:
            regs[name] = {layout: tree}

        def get_reg(name: str, layout: Optional[int]) -> PyTree:
            views = regs[name]
            if layout in views:
                return views[layout]
            if None not in views:
                lv, tree = next(iter(views.items()))
                views[None] = tree_map(
                    lambda a: torch.movedim(a, 0, lv), tree
                )
            if layout is None:
                return views[None]
            views[layout] = tree_map(
                lambda a: torch.movedim(a, layout, 0), views[None]
            )
            return views[layout]

        def run_phase(ph, wrap) -> Tuple[PyTree, Any]:
            """Run one plan phase into the registers; returns the tree it
            produced and the comm backend it ran on (None for COMBINE and
            IDENTITY). ``wrap`` (or None) wraps that backend."""
            if ph.kind == PhaseKind.COMBINE:
                carry = get_reg(ph.src[0], None)
                local = get_reg(ph.src[1], None)
                merged = op.combine(carry, local)
                if ph.guard_levels:
                    mask = _zero_coord_mask(logical, ph.guard_levels, device)
                    merged = alg._bwhere(mask, local, merged)
                set_reg(ph.dst, merged, None)
                return merged, None
            if ph.kind == PhaseKind.IDENTITY:
                out = op.identity_like(get_reg(ph.src[0], None))
                set_reg(ph.dst, out, None)
                return out, None
            p_axis = logical[ph.level]
            backend = sim_backends[ph.level]
            if wrap is not None:
                backend = wrap(backend)
            if ph.kind == PhaseKind.SCAN:
                if chunks > 1:
                    fn = lambda t: _sim_scan_chunked(  # noqa: E731
                        backend, t, op, p_axis, algorithm=ph.algorithm,
                        inclusive=ph.inclusive, chunks=chunks,
                    )
                else:
                    fn = lambda t: sim_scan(  # noqa: E731
                        t, op, p_axis, algorithm=ph.algorithm,
                        inclusive=ph.inclusive, backend=backend,
                    )
            elif ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
                if chunks > 1:
                    fn = lambda t: _chunked_scan_total(  # noqa: E731
                        backend, t, op, inclusive=ph.inclusive,
                        chunks=chunks, min_ndim=2,
                    )
                else:
                    fn = lambda t: alg.scan_total_schedule(  # noqa: E731
                        backend, t, op, inclusive=ph.inclusive
                    )
            elif ph.kind == PhaseKind.TOTAL:
                fn = lambda t: allreduce_schedule(  # noqa: E731
                    backend, t, op, algorithm=ph.algorithm
                )
            elif ph.kind == PhaseKind.REDUCE:
                fn = lambda t: reduce_schedule(  # noqa: E731
                    backend, t, op, root=ph.root, algorithm=ph.algorithm
                )
            elif ph.kind == PhaseKind.BARRIER:
                # not reduce_ops.barrier_schedule: that mints a fresh token
                # per call, but a multi-axis fence must *thread* one token
                # through the levels so each axis fence data-depends on the
                # previous
                fn = lambda t: allreduce_schedule(  # noqa: E731
                    backend, t, MAX, algorithm=ph.algorithm
                )
            else:  # pragma: no cover - exhaustive
                raise ValueError(f"unknown phase kind {ph.kind!r}")
            if threaded:
                out = fn(get_reg(ph.src[0], ph.level))
                if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
                    set_reg(ph.dst, out[0], ph.level)
                    set_reg(ph.dst2, out[1], ph.level)
                else:
                    set_reg(ph.dst, out, ph.level)
            else:
                src = get_reg(ph.src[0], None)
                out = _along_axis(src, ph.level, fn)
                if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
                    set_reg(ph.dst, out[0], None)
                    set_reg(ph.dst2, out[1], None)
                else:
                    set_reg(ph.dst, out, None)
            return out, backend

        if plan.coll == CollType.BARRIER:
            set_reg("x", torch.ones(logical, dtype=torch.float32, device=device), None)
        else:
            _check_device(x, device)
            set_reg("x", to_mesh(x), None)
        tracer = obs_tracing.get_tracer() if traced else obs_tracing.NOOP
        injector = runtime_chaos.get_injector() if traced else None
        if injector is not None and device.type == "cuda" \
                and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "a chaos scope cannot run inside a CUDA graph capture: the "
                "graph would replay one run's fault decisions"
            )

        def lossy(b, level):
            # innermost wrapper: link-probed single-pair permutes and
            # traced rounds both see per-message chaos decisions
            if injector is None:
                return b
            return runtime_chaos.ChaosBackend(b, injector, level=level)

        for ph in plan.phases:
            if not tracer.enabled:
                run_phase(
                    ph,
                    None if injector is None
                    else (lambda b, lv=ph.level: lossy(b, lv)),
                )
                continue
            name = ph.kind.name

            def wrap(b, lv=ph.level, name=name):
                plain, b = b, lossy(b, lv)
                if getattr(tracer, "link_probe", False):
                    # per-link attribution: each round's permute split
                    # into individually timed (src, dst) messages (an
                    # exact merge), child spans of the round span
                    b = obs_health.LinkProbeBackend(
                        b, tracer, level=lv,
                        injector=getattr(tracer, "link_injector", None),
                        detector=getattr(tracer, "link_detector", None),
                        plain=plain,
                    )
                return obs_tracing.TracingBackend(
                    b, tracer, phase=f"{name}:L{lv}",
                    on_round=lambda idx, dur_us: obs_metrics.observe_round(
                        coll_name, name, idx, dur_us
                    ),
                )

            t0 = obs_tracing.now_us()
            with tracer.span(
                f"plan.phase:{name}:L{ph.level}", "phase", kind=name,
                level=ph.level, algorithm=ph.algorithm, coll=coll_name,
            ) as span:
                out, backend = run_phase(ph, wrap)
                obs_tracing._block(out)
                if backend is not None:
                    span.set(rounds=backend.rounds)
            obs_metrics.observe_phase(coll_name, name, obs_tracing.now_us() - t0)
        return to_flat(get_reg(plan.result, None))

    return run


def spmd_phase(
    ph: PlanPhase, src: PyTree, op: AssocOp, name: str, p: int,
    chunks: int = 1,
):
    """One comm phase of a plan per rank over axis ``name`` of ``p`` ranks,
    op per round (:func:`lower_spmd`'s phase body); returns the phase's
    output, or ``(scan, total)`` for FUSED_SCAN_TOTAL."""
    from repro_torch import compat

    backend = alg.SpmdBackend(name, p)
    if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
        if chunks > 1:
            return _chunked_scan_total(
                backend, src, op, inclusive=ph.inclusive,
                chunks=chunks, min_ndim=1 + compat.rank_dims(name),
            )
        return alg.scan_total_schedule(backend, src, op, inclusive=ph.inclusive)
    if ph.kind == PhaseKind.SCAN:
        if chunks > 1:
            return _spmd_scan_chunked(
                backend, src, op, algorithm=ph.algorithm,
                inclusive=ph.inclusive, chunks=chunks,
            )
        if ph.inclusive:
            return dist_scan(src, op, name, algorithm=ph.algorithm)
        return dist_exscan(src, op, name, algorithm=ph.algorithm)
    if ph.kind == PhaseKind.TOTAL:
        return allreduce_schedule(backend, src, op, algorithm=ph.algorithm)
    if ph.kind == PhaseKind.REDUCE:
        return reduce_schedule(
            backend, src, op, root=ph.root, algorithm=ph.algorithm
        )
    if ph.kind == PhaseKind.BARRIER:
        # same token-threading rationale as the sim interpreter
        return allreduce_schedule(backend, src, MAX, algorithm=ph.algorithm)
    raise ValueError(f"unknown phase kind {ph.kind!r}")  # pragma: no cover


def lower_spmd(
    plan: CollectivePlan,
    axis_names: Sequence[str],
    op: "AssocOp | str | None" = None,
):
    """Compile a plan to a function callable per rank inside
    :func:`repro_torch.compat.shard_map`.

    ``axis_names`` name the *physical* mesh axes in the same order as
    ``plan.sizes``; the plan's split decides which named axis each logical
    level runs over. Global rank order is lex over the logical levels —
    callers lay data out accordingly (outermost logical level varies
    slowest).
    """
    from repro_torch import compat

    op = get_operator(plan.op_name if op is None else op)
    axis_names = tuple(axis_names)
    if len(axis_names) != len(plan.sizes):
        raise ValueError(
            f"plan spans {len(plan.sizes)} axes; got names {axis_names}"
        )
    names_l = tuple(axis_names[i] for i in plan.order)
    chunks = max(1, int(plan.chunking))

    def run(x: Optional[PyTree]) -> PyTree:
        regs: Dict[str, PyTree] = {}
        if plan.coll == CollType.BARRIER:
            regs["x"] = compat.mesh_of(names_l[0]).ranks.rank_ones(torch.float32)
        else:
            regs["x"] = x
        for ph in plan.phases:
            if ph.kind == PhaseKind.COMBINE:
                carry, local = regs[ph.src[0]], regs[ph.src[1]]
                merged = op.combine(carry, local)
                cond = None
                for lv in ph.guard_levels:
                    z = compat.axis_index(names_l[lv]) == 0
                    cond = z if cond is None else (cond & z)
                if cond is not None:
                    merged = alg._bwhere(cond, local, merged)
                regs[ph.dst] = merged
                continue
            if ph.kind == PhaseKind.IDENTITY:
                regs[ph.dst] = op.identity_like(regs[ph.src[0]])
                continue
            out = spmd_phase(ph, regs[ph.src[0]], op, names_l[ph.level],
                             plan.logical_sizes[ph.level], chunks)
            if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
                regs[ph.dst], regs[ph.dst2] = out
            else:
                regs[ph.dst] = out
        return regs[plan.result]

    return run
