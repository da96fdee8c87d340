"""K1, the fused "NIC" collective: one launch per comm phase, every exchange
round inside it (PyTorch/CUDA counterpart of ``repro.kernels.pallas_collective``).

The source paper's thesis is that MPI_Scan wins when the whole collective
runs inside the network device. ``lower_sim`` is the op-per-round baseline;
this module is the offloaded analogue for one GPU: each communication phase
of a :class:`~repro_torch.offload.planner.CollectivePlan` on its active level
runs as a *single* kernel launch over the stacked ``(p, ...)`` leaves
(``csrc/fused_collective.cu``), which replaces the reference's
``_sim_comm_kernel``.

Three layers, as for every kernel of the port:

* :func:`comm_phase_plain` — the same rounds written with torch slicing on
  the stacked tensors (shift = ``recv[d:] = acc[:-d]`` with zero fill,
  butterfly = block swaps). The CPU path and the tests use it.
* :func:`comm_phase` — the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel on the path :func:`plan_launch` picks
  (``register`` for 2 <= p <= 16, the column tile in registers; ``column``
  otherwise, the PR 13 kernel with the column in shared memory or global
  scratch) or raises (a build or launch failure raises too).
  :data:`launches` counts the launches the C entry reports, and
  :data:`path_launches` the same by path.
* :func:`lower_fused` — the plan lowering the registry's fused backend
  (registered under the wire name ``"pallas"``) returns, the counterpart of
  ``lower_pallas``: without ``axis_names`` over stacked leaves with one K1
  launch per comm phase; with them, per rank inside
  :func:`repro_torch.compat.shard_map` with one K2 launch per comm phase
  (:mod:`repro_torch.kernels.spmd_collective`, the reference's spmd form).

:func:`supports_plan` gives the capability envelope with the reference's
reason tokens.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import algorithms as alg
from repro_torch.core import operators as ops
from repro_torch.core.operators import MAX, AssocOp, get_operator
from repro_torch.core.packet import CollType
from repro_torch.core.reduce_ops import allreduce_schedule, reduce_schedule
from repro_torch.core.scan_collective import sim_scan
from repro_torch.core.trees import (
    resolve_device,
    tree_flatten,
    tree_leaves,
    tree_unflatten,
)
from repro_torch.obs import tracing as obs_tracing
from repro_torch.offload.planner import (
    CollectivePlan,
    PhaseKind,
    _along_axis,
    _check_device,
    _zero_coord_mask,
)
from repro_torch.roofline.op_cost import charged

PyTree = Any

#: phase kinds the fused kernel implements on the active (size > 1) level
_COMM_KINDS = (
    PhaseKind.SCAN,
    PhaseKind.FUSED_SCAN_TOTAL,
    PhaseKind.TOTAL,
    PhaseKind.BARRIER,
)

#: kernel launches since import (the main path's proof that it ran K1);
#: comparison launches by a caller are that caller's to discount
launches = 0
#: the same launches by path
path_launches = {"register": 0, "column": 0}

# codes of csrc/fused_collective.cu
_KIND_CODES = {
    PhaseKind.SCAN: 0,
    PhaseKind.FUSED_SCAN_TOTAL: 1,
    PhaseKind.TOTAL: 2,
    PhaseKind.BARRIER: 2,
}
#: kernel op code and leaf count, keyed on the combine function (the flash
#: identity's neg_inf does not change the combine)
_KERNEL_OPS = {
    ops.SUM.combine: (0, 1),
    ops.PROD.combine: (1, 1),
    ops.MAX.combine: (2, 1),
    ops.MIN.combine: (3, 1),
    ops._ssd_combine: (4, 2),
    ops._flash_combine: (5, 3),
}
_DTYPE_CODES = {
    torch.int32: 0,
    torch.float32: 1,
    torch.bfloat16: 2,
    torch.float16: 3,
    torch.int8: 4,
}
#: leaf pointers per stream the kernels' C interfaces take
MAX_LEAVES = 3
_PATH_CODES = {"register": 0, "column": 1}
#: ranks the register path takes, and the row counts it is compiled for
REGISTER_P_MAX = (2, 4, 8, 16)
REGISTER_THREADS = 128
#: values of the leaf type a register-path thread may keep (streams x
#: leaves x P_MAX x VEC); more would spill
REGISTER_BUDGET = 128
#: the column path keeps each thread's column in shared memory up to this
#: many bytes per block (no opt-in attribute needed); beyond, global scratch
_SMEM_LIMIT = 48 * 1024
_BLOCKS = (256, 128, 64, 32)


def active_level(plan: CollectivePlan) -> Optional[int]:
    """The single logical level with size > 1, or None if the plan is not
    effectively single-axis (zero or several non-trivial levels)."""
    active = [lv for lv, s in enumerate(plan.logical_sizes) if s > 1]
    return active[0] if len(active) == 1 else None


def supports_plan(
    plan: CollectivePlan, axis_names: Optional[Sequence[str]] = None
) -> Tuple[bool, str]:
    """Can the fused-kernel backend lower ``plan``? Returns ``(ok, reason)``
    with the reference's stable reason tokens.

    Supported: effectively single-axis plans (one logical level of size
    > 1; size-1 levels run the identical local shortcuts), whole payloads
    (chunking == 1), hillis-steele SCAN / FUSED_SCAN_TOTAL over a
    zero-identity operator, and pow2 TOTAL/BARRIER butterflies. With
    ``axis_names`` exactly one named mesh axis is required. One token is the
    port's own: ``op:<name>`` for an operator whose combine the kernel does
    not implement (every wire operator is implemented).
    """
    if plan.chunking > 1:
        return False, "chunked"
    if axis_names is not None and (
        len(axis_names) != 1 or len(plan.sizes) != 1
    ):
        return False, "multi_axis_mesh"
    lv = active_level(plan)
    if lv is None:
        return False, "not_single_axis"
    p = plan.logical_sizes[lv]
    op = get_operator(plan.op_name)
    for ph in plan.phases:
        if ph.kind in (PhaseKind.COMBINE, PhaseKind.IDENTITY):
            continue
        if ph.level != lv:
            continue  # size-1 level: local shortcut, no kernel needed
        if ph.kind == PhaseKind.SCAN:
            if ph.algorithm != "hillis_steele":
                return False, f"algorithm:{ph.algorithm}"
            if not op.zero_identity:
                return False, "op_flags"
        elif ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
            if not op.zero_identity:
                return False, "op_flags"
        elif ph.kind in (PhaseKind.TOTAL, PhaseKind.BARRIER):
            if p & (p - 1):
                return False, "non_pow2_butterfly"
        else:
            return False, f"phase:{ph.kind.name.lower()}"
        if ph.kind != PhaseKind.BARRIER and op.combine not in _KERNEL_OPS:
            return False, f"op:{op.name}"
    return True, ""


def kernel_round_structure(
    plan: CollectivePlan,
) -> Tuple[Tuple[str, int], ...]:
    """``(phase_kind_name, rounds)`` per fused comm phase, in plan order —
    the round structure the kernel executes internally."""
    lv = active_level(plan)
    if lv is None:
        return ()
    p = plan.logical_sizes[lv]
    return tuple(
        (
            ph.kind.name,
            alg.phase_round_count(ph.kind.name, p, inclusive=ph.inclusive),
        )
        for ph in plan.phases
        if ph.kind in _COMM_KINDS and ph.level == lv
    )


# ---------------------------------------------------------------------------
# The plain version: the kernel's rounds with torch slicing
# ---------------------------------------------------------------------------


def _shift_rows(v: torch.Tensor, d: int) -> torch.Tensor:
    """Rows move by ``d`` (+d toward higher ranks); rows with no sender are
    zero."""
    p = v.shape[0]
    out = torch.zeros_like(v)
    if d > 0:
        out[d:] = v[: p - d]
    else:
        out[: p + d] = v[-d:]
    return out


def _swap_blocks(v: torch.Tensor, d: int) -> torch.Tensor:
    """XOR-partner round: row r receives row r ^ d (2*(p / 2d) block swaps)."""
    p = v.shape[0]
    rest = tuple(v.shape[1:])
    return v.reshape((p // (2 * d), 2, d) + rest).flip(1).reshape(v.shape)


def _check_pow2(kind: PhaseKind, p: int) -> None:
    if p & (p - 1):
        raise ValueError(
            f"{kind.name} runs the pow2 XOR butterfly; p={p} is not a power "
            "of two"
        )


def comm_phase_plain(
    kind: PhaseKind, p: int, op: AssocOp, tree: PyTree, *,
    inclusive: bool = True,
):
    """One comm phase over stacked ``(p, ...)`` leaves, written with torch
    slicing; returns a tree, or ``(scan, total)`` for FUSED_SCAN_TOTAL."""
    leaves, spec = tree_flatten(tree)

    def combine(lhs: List[torch.Tensor], rhs: List[torch.Tensor]):
        merged = op.combine(tree_unflatten(lhs, spec), tree_unflatten(rhs, spec))
        return tree_flatten(merged)[0]

    def shift(vals, d):
        return [_shift_rows(v, d) for v in vals]

    if kind in (PhaseKind.TOTAL, PhaseKind.BARRIER):
        _check_pow2(kind, p)
        acc = leaves
        rank = torch.arange(p, device=leaves[0].device)
        for d in alg.doubling_strides(p):
            rv = [_swap_blocks(v, d) for v in acc]
            lo = combine(rv, acc)
            hi = combine(acc, rv)
            partner_lower = (rank & d) != 0
            acc = [
                torch.where(
                    partner_lower.reshape((p,) + (1,) * (l.ndim - 1)), l, h
                )
                for l, h in zip(lo, hi)
            ]
        return tree_unflatten(acc, spec)
    if kind not in (PhaseKind.SCAN, PhaseKind.FUSED_SCAN_TOTAL):
        raise ValueError(f"{kind.name} is not a fused comm phase")
    fused = kind == PhaseKind.FUSED_SCAN_TOTAL
    pre = leaves if inclusive else shift(leaves, 1)
    suf = leaves
    for d in alg.doubling_strides(p):
        new_pre = combine(shift(pre, d), pre)
        if fused:
            suf = combine(suf, shift(suf, -d))
        pre = new_pre
    if not fused:
        return tree_unflatten(pre, spec)
    if inclusive:
        total = combine(pre, shift(suf, -1))
        y = pre
    else:
        total = combine(pre, suf)
        y = [v.clone() for v in pre]
        for v in y:
            v[0] = 0
    return tree_unflatten(y, spec), tree_unflatten(total, spec)


# ---------------------------------------------------------------------------
# The CUDA kernel and its wrapper
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    from repro_torch.kernels._build import load_library

    lib = load_library("fused_collective")
    fn = lib.k1_fused_comm
    if fn.argtypes is None:  # first use: declare the signature
        fn.argtypes = (
            [ctypes.c_int] * 6
            + [ctypes.c_longlong]
            + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 11
            + [ctypes.POINTER(ctypes.c_int)]
        )
        fn.restype = ctypes.c_int
    return lib


def register_vec(kind: PhaseKind, itemsize: int, n_leaves: int,
                 p_max: int) -> int:
    """Columns a register-path thread owns: 16 bytes of the leaf type,
    halved while the thread would keep more than :data:`REGISTER_BUDGET`
    values (the kernel's ``reg::vec_for``)."""
    vec = 16 // itemsize
    streams = 2 if kind == PhaseKind.FUSED_SCAN_TOTAL else 1
    while vec > 1 and streams * n_leaves * p_max * vec > REGISTER_BUDGET:
        vec //= 2
    return vec


@dataclass(frozen=True)
class LaunchPlan:
    """How one K1 call runs: its path, block, grid and buffers."""

    path: str        # "register" or "column"
    block: int       # threads a block
    grid: int        # blocks (grid.x)
    p_max: int       # register path: rows compiled for (0 on the column path)
    vec: int         # columns a thread (1 on the column path)
    smem_bytes: int  # column path: a block's shared column buffer
    scratch: int     # column path: elements of global scratch (0: shared)
    launches: int


@functools.lru_cache(maxsize=1024)
def plan_launch(
    kind: PhaseKind, p: int, M: int, dtype: torch.dtype, n_leaves: int,
    aligned: bool, *, path: Optional[str] = None,
) -> LaunchPlan:
    """The path, block and grid of one K1 call over ``(p, M)`` rows of
    ``n_leaves`` leaves; ``aligned`` says every row starts on 16 bytes.
    ``register`` for 2 <= p <= 16 (VEC = 1 for rows not aligned), else
    ``column``. :func:`_launch` follows it; the C entry checks it. ``path``
    names a path to take instead, for a comparison of the two."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the fused kernel takes {sorted(map(str, _DTYPE_CODES))}; got {dtype}"
        )
    fits = 2 <= p <= REGISTER_P_MAX[-1]
    if path is None:
        path = "register" if fits else "column"
    if path not in _PATH_CODES or (path == "register" and not fits):
        raise ValueError(f"K1 has no {path!r} path for p={p}")
    launches_ = 1 if M > 0 else 0
    if path == "register":
        p_max = next(n for n in REGISTER_P_MAX if n >= p)
        vec = register_vec(kind, dtype.itemsize, n_leaves, p_max) if aligned else 1
        per_block = REGISTER_THREADS * vec
        return LaunchPlan("register", REGISTER_THREADS, -(-M // per_block),
                          p_max, vec, 0, 0, launches_)
    streams = 2 if kind == PhaseKind.FUSED_SCAN_TOTAL else 1
    for block in _BLOCKS:
        smem = streams * n_leaves * p * block * dtype.itemsize
        if smem <= _SMEM_LIMIT:
            return LaunchPlan("column", block, -(-M // block), 0, 1, smem, 0,
                              launches_)
    block = _BLOCKS[0]
    return LaunchPlan("column", block, -(-M // block), 0, 1, 0,
                      streams * n_leaves * p * M, launches_)


def _unbroadcast(out: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """Undo the launch-time broadcast of one leaf: its result values are
    copies along the broadcast dims, so index them away."""
    if out.shape == shape:
        return out
    extra = out.ndim - len(shape)
    idx = (0,) * extra + tuple(
        slice(0, 1) if s == 1 and o != 1 else slice(None)
        for s, o in zip(shape, out.shape[extra:])
    )
    return out[idx]


def _stage(
    kind: PhaseKind, p: int, op: AssocOp, leaves: List[torch.Tensor], who: str,
):
    """Check one launch's leaves (a combine the collective kernels implement,
    one wire dtype and device, a leading axis of ``p`` ranks) and lay them
    out as contiguous ``(p, M)`` rows. Returns ``(op_code, rows, outputs,
    totals, back)``: empty outputs (``totals`` only for FUSED_SCAN_TOTAL,
    else None), and ``back`` to give results the leaves' own shapes."""
    entry = _KERNEL_OPS.get(op.combine)
    if entry is None:
        raise ValueError(f"the {who} has no combine for op {op.name!r}")
    op_code, n_leaves = entry
    if n_leaves != len(leaves):
        raise ValueError(
            f"op {op.name!r} combines {n_leaves} leaves; got {len(leaves)}"
        )
    dtype = leaves[0].dtype
    device = leaves[0].device
    if any(l.dtype != dtype or l.device != device for l in leaves):
        raise ValueError(f"{who} leaves must share one dtype and device")
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the {who} takes {sorted(map(str, _DTYPE_CODES))}; got {dtype}"
        )
    if n_leaves > 1 and not dtype.is_floating_point:
        raise ValueError(f"op {op.name!r} needs a floating dtype; got {dtype}")
    if any(l.ndim < 1 or l.shape[0] != p for l in leaves):
        raise ValueError(
            f"{who} leaves need a leading rank axis of {p}; got "
            f"{[tuple(l.shape) for l in leaves]}"
        )
    shapes = [l.shape for l in leaves]
    if n_leaves > 1:
        leaves = list(torch.broadcast_tensors(*leaves))
    full = leaves[0].shape
    flat = [l.reshape(p, -1).contiguous() for l in leaves]
    ys = [torch.empty_like(f) for f in flat]
    fused = kind == PhaseKind.FUSED_SCAN_TOTAL
    ts = [torch.empty_like(f) for f in flat] if fused else None

    def back(outs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [
            _unbroadcast(o.reshape(full), s) for o, s in zip(outs, shapes)
        ]

    return op_code, flat, ys, ts, back


def _pointers(ts_: Optional[List[torch.Tensor]]) -> list:
    """Up to three leaf pointers, the unused ones null."""
    got = [t.data_ptr() for t in ts_] if ts_ is not None else []
    return got + [None] * (MAX_LEAVES - len(got))


def _dispatch(kind: PhaseKind, op: AssocOp, tree: PyTree, launch):
    """Run ``launch(leaves) -> (outputs, totals)`` once, or once a leaf for
    an elementwise op over a multi-leaf payload (its leaves are
    independent); returns a tree, or ``(scan, total)`` for
    FUSED_SCAN_TOTAL."""
    leaves, spec = tree_flatten(tree)
    entry = _KERNEL_OPS.get(op.combine)
    if entry is not None and entry[1] == 1 and len(leaves) > 1:
        groups = [[leaf] for leaf in leaves]
    else:
        groups = [leaves]
    outs = [launch(group) for group in groups]
    ys = [y for got, _ in outs for y in got]
    if kind != PhaseKind.FUSED_SCAN_TOTAL:
        return tree_unflatten(ys, spec)
    ts = [t for _, got in outs for t in got]
    return tree_unflatten(ys, spec), tree_unflatten(ts, spec)


def aligned_rows(tensors: List[torch.Tensor], M: int) -> bool:
    """Does every ``(p, M)`` row of ``tensors`` start on 16 bytes?"""
    return (M * tensors[0].element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors
    )


def _launch(
    kind: PhaseKind, p: int, op: AssocOp, leaves: List[torch.Tensor],
    inclusive: bool, path: Optional[str],
) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
    global launches
    op_code, flat, ys, ts, back = _stage(kind, p, op, leaves, "fused kernel")
    dtype, device = flat[0].dtype, flat[0].device
    M = flat[0].shape[1]
    plan = plan_launch(kind, p, M, dtype, len(flat),
                       aligned_rows(flat + ys + (ts or []), M), path=path)
    if M > 0:
        lib = _library()
        scratch = None
        if plan.scratch:
            scratch = torch.empty(plan.scratch, dtype=dtype, device=device)
        made = ctypes.c_int(0)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.k1_fused_comm(
                _PATH_CODES[plan.path], _KIND_CODES[kind], op_code,
                _DTYPE_CODES[dtype], int(inclusive), p, M, plan.p_max,
                plan.vec, plan.block, plan.smem_bytes,
                *_pointers(flat), *_pointers(ys), *_pointers(ts),
                None if scratch is None else scratch.data_ptr(),
                stream, ctypes.byref(made),
            )
        launches += made.value
        path_launches[plan.path] += made.value
        if rc != 0:
            raise RuntimeError(
                f"fused collective kernel launch failed (code {rc}) on the "
                f"{plan.path} path for {kind.name} op={op.name} dtype={dtype} "
                f"p={p} M={M}"
            )
    return back(ys), (back(ts) if ts is not None else None)


def comm_phase(
    kind: PhaseKind, p: int, op: AssocOp, tree: PyTree, *,
    inclusive: bool = True, path: Optional[str] = None,
):
    """Run one comm phase: the plain version for CPU tensors, the CUDA
    kernel on the path :func:`plan_launch` picks for CUDA tensors (no
    fallback between the two). ``path`` names a path to take instead, for a
    comparison of the two. Under a ``CostMode`` a call counts as one K1
    charge at K1's own cost."""
    leaves = tree_leaves(tree)
    if leaves and leaves[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused kernel for device {leaves[0].device}")
    with charged("k1", phase=kind.name, p=p,
                 numel=sum(t.numel() for t in leaves),
                 dtype=leaves[0].dtype if leaves else torch.float32):
        if not leaves or leaves[0].device.type == "cpu":
            return comm_phase_plain(kind, p, op, tree, inclusive=inclusive)
        if kind not in _KIND_CODES:
            raise ValueError(f"{kind.name} is not a fused comm phase")
        if _KIND_CODES[kind] == 2:
            _check_pow2(kind, p)
        return _dispatch(
            kind, op, tree,
            lambda group: _launch(kind, p, op, group, inclusive, path),
        )


# ---------------------------------------------------------------------------
# Plan lowering: lower_sim's phase loop with every comm phase on the active
# level replaced by one fused launch
# ---------------------------------------------------------------------------


def _sim_fallback_fn(ph, op, backend) -> Callable[[PyTree], PyTree]:
    """The op-per-round functions lower_sim uses — only reached for size-1
    levels, where they are communication-free local shortcuts."""
    if ph.kind == PhaseKind.SCAN:
        return lambda t: sim_scan(
            t, op, backend.p, algorithm=ph.algorithm,
            inclusive=ph.inclusive, backend=backend,
        )
    if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
        return lambda t: alg.scan_total_schedule(
            backend, t, op, inclusive=ph.inclusive
        )
    if ph.kind == PhaseKind.TOTAL:
        return lambda t: allreduce_schedule(
            backend, t, op, algorithm=ph.algorithm
        )
    if ph.kind == PhaseKind.REDUCE:
        return lambda t: reduce_schedule(
            backend, t, op, root=ph.root, algorithm=ph.algorithm
        )
    if ph.kind == PhaseKind.BARRIER:
        return lambda t: allreduce_schedule(
            backend, t, MAX, algorithm=ph.algorithm
        )
    raise ValueError(f"unknown phase kind {ph.kind!r}")


def _lower_fused_spmd(plan: CollectivePlan, op: AssocOp, axis_names):
    """The per-rank phase loop (``_lower_pallas_spmd``): COMBINE with the
    rank-0 guard, IDENTITY, and one K2 launch per comm phase."""
    from repro_torch import compat
    from repro_torch.kernels.spmd_collective import comm_phase_spmd

    name = axis_names[plan.order[0]]
    p = plan.sizes[0]

    def run(x: Optional[PyTree] = None) -> PyTree:
        regs = {}
        if plan.coll == CollType.BARRIER:
            # the fence token, threaded through the phases per rank
            regs["x"] = compat.mesh_of(name).ranks.rank_ones(torch.float32)
        else:
            regs["x"] = x
        for ph in plan.phases:
            if ph.kind == PhaseKind.COMBINE:
                merged = op.combine(regs[ph.src[0]], regs[ph.src[1]])
                if ph.guard_levels:
                    keep = None
                    for _ in ph.guard_levels:
                        z = compat.axis_index(name) == 0
                        keep = z if keep is None else keep & z
                    merged = alg._bwhere(keep, regs[ph.src[1]], merged)
                regs[ph.dst] = merged
                continue
            if ph.kind == PhaseKind.IDENTITY:
                regs[ph.dst] = op.identity_like(regs[ph.src[0]])
                continue
            phase_op = MAX if ph.kind == PhaseKind.BARRIER else op
            out = comm_phase_spmd(
                ph.kind, p, name, phase_op, regs[ph.src[0]],
                inclusive=ph.inclusive,
            )
            if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
                regs[ph.dst], regs[ph.dst2] = out
            else:
                regs[ph.dst] = out
        return regs[plan.result]

    return run


def lower_fused(
    plan: CollectivePlan,
    op: "AssocOp | str | None" = None,
    *,
    device: "torch.device | str" = "cuda",
    axis_names: Optional[Sequence[str]] = None,
    traced: bool = False,
):
    """Compile a supported plan to fused-kernel schedules.

    Without ``axis_names``: a function over flat stacked ``(p, ...)`` leaves
    on ``device``, one K1 launch per comm phase, with the calling convention
    of :func:`repro_torch.offload.planner.lower_sim`. With them: a function
    run per rank inside :func:`repro_torch.compat.shard_map` over one named
    axis (whose mesh decides the device), one K2 launch per comm phase, with
    the calling convention of :func:`~repro_torch.offload.planner.lower_spmd`.
    Both give the op-per-round lowerings' values (same arithmetic, operand
    order and zero fills). Raises ``ValueError`` for plans outside
    :func:`supports_plan`; callers wanting a soft fallback go through the
    lowering registry (:mod:`repro_torch.offload.backends`).

    ``traced=True`` (stacked leaves only) records, under a collecting
    tracer, one ``phase`` span for each K1 launch and
    ``phase_round_count`` ``round`` spans splitting it evenly
    (:func:`repro_torch.obs.tracing.add_kernel_round_spans`): the launch
    is bracketed by two device syncs, so the phase span is its whole cost.
    """
    op = get_operator(plan.op_name if op is None else op)
    ok, reason = supports_plan(plan, axis_names)
    if not ok:
        raise ValueError(
            f"plan not supported by the fused backend ({reason}); "
            f"use the registry default lowering"
        )
    if axis_names is not None:
        return _lower_fused_spmd(plan, op, tuple(axis_names))
    device = resolve_device(device)
    logical = plan.logical_sizes
    k = len(logical)
    p_total = plan.p
    lv_active = active_level(plan)
    coll_name = plan.coll.name.lower()
    sim_backends = [alg.SimBackend(p_axis, device) for p_axis in logical]

    def to_mesh(tree: PyTree) -> PyTree:
        leaves, spec = tree_flatten(tree)
        return tree_unflatten(
            [a.reshape(logical + tuple(a.shape[1:])) for a in leaves], spec
        )

    def to_flat(tree: PyTree) -> PyTree:
        leaves, spec = tree_flatten(tree)
        return tree_unflatten(
            [a.reshape((p_total,) + tuple(a.shape[k:])) for a in leaves], spec
        )

    def run(x: Optional[PyTree]) -> PyTree:
        tracer = obs_tracing.get_tracer() if traced else obs_tracing.NOOP
        regs = {}
        if plan.coll == CollType.BARRIER:
            regs["x"] = torch.ones(logical, dtype=torch.float32, device=device)
        else:
            _check_device(x, device)
            regs["x"] = to_mesh(x)
        for ph in plan.phases:
            if ph.kind == PhaseKind.COMBINE:
                merged = op.combine(regs[ph.src[0]], regs[ph.src[1]])
                if ph.guard_levels:
                    mask = _zero_coord_mask(logical, ph.guard_levels, device)
                    merged = alg._bwhere(mask, regs[ph.src[1]], merged)
                regs[ph.dst] = merged
                continue
            if ph.kind == PhaseKind.IDENTITY:
                regs[ph.dst] = op.identity_like(regs[ph.src[0]])
                continue
            p_axis = logical[ph.level]
            rounds = 0
            if ph.level == lv_active and ph.kind in _COMM_KINDS:
                phase_op = MAX if ph.kind == PhaseKind.BARRIER else op
                fn = lambda t, _ph=ph, _op=phase_op: comm_phase(  # noqa: E731
                    _ph.kind, p_axis, _op, t, inclusive=_ph.inclusive
                )
                rounds = alg.phase_round_count(
                    ph.kind.name, p_axis, inclusive=ph.inclusive
                )
            else:
                fn = _sim_fallback_fn(ph, op, sim_backends[ph.level])
            if tracer.enabled and rounds:
                obs_tracing._block(regs[ph.src[0]])
                t0 = obs_tracing.now_us()
                out = obs_tracing._block(
                    _along_axis(regs[ph.src[0]], ph.level, fn)
                )
                obs_tracing.add_kernel_round_spans(
                    tracer,
                    phase=f"{ph.kind.name}:L{ph.level}",
                    coll=coll_name,
                    rounds=rounds,
                    start_us=t0,
                    end_us=obs_tracing.now_us(),
                )
            else:
                out = _along_axis(regs[ph.src[0]], ph.level, fn)
            if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
                regs[ph.dst], regs[ph.dst2] = out
            else:
                regs[ph.dst] = out
        return to_flat(regs[plan.result])

    return run
