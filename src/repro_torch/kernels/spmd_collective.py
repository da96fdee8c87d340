"""K2, the per-rank collective kernel: one launch per comm phase, every
exchange round inside it, each rank putting its accumulator straight into
its partner's memory (PyTorch/CUDA counterpart of the spmd form of
``repro.kernels.pallas_collective``, ``_spmd_comm_kernel``).

Two paths, which :func:`plan_launch` picks from the rank count:

* ``cluster`` (2 <= p <= 16): one thread-block cluster of p CTAs a column
  tile, a rank a CTA (128 threads, each with V vectors of 16 bytes a
  leaf); every put goes into the partner CTA's shared memory and completes
  on its barrier there. The launch needs nothing but its
  outputs: no workspace, no host read afterwards.
* ``flags`` (any other p; the ground of the multi-GPU form): thread blocks
  of every rank in one cooperative launch, puts into receive regions in
  device memory, signal flags, and a status word the wrapper reads after
  the launch.

Three layers, as for every kernel of the port:

* :func:`comm_phase_spmd_plain` — the reference kernel's rounds written with
  :class:`~repro_torch.core.algorithms.SpmdBackend` permutes, line for line:
  cyclic full-permutation sends, the receiver's mask back to zero fill, the
  exclusive entry shift, the prefix stream ``combine(masked_recv, acc)``,
  the suffix stream ``combine(acc, masked_recv)``, the butterfly's
  ``partner_lower`` choice and the fused exits. It runs per rank inside
  :func:`repro_torch.compat.shard_map`, under either kind of rank group; the
  CPU path and the tests use it.
* :func:`comm_phase_spmd` — the wrapper. A CPU tensor takes the plain
  version; CUDA tensors of co-resident ranks launch the kernel
  (``csrc/spmd_collective.cu``) for all ranks at once on the planned path,
  or raise. CUDA tensors under a process group raise
  ``NotImplementedError``: that launch needs peer pointers on other GPUs.
  :data:`launches` counts the launches the C entry reports, and
  :data:`path_launches` the same by path.
* :class:`_Workspace` — the flags path's host side: the signal flags, the
  status word and the launch epoch, kept per device, rank count and
  stream; each launch takes its receive regions (one per exchange and
  rank) from the caching allocator and builds their peer table.

The lowering that calls it is ``fused_collective.lower_fused(plan, op,
axis_names=...)``, the counterpart of ``_lower_pallas_spmd``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import algorithms as alg
from repro_torch.core.operators import AssocOp
from repro_torch.core.trees import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.kernels.fused_collective import (
    _DTYPE_CODES,
    _KIND_CODES,
    _check_pow2,
    _dispatch,
    _pointers,
    _stage,
    aligned_rows,
)
from repro_torch.offload.planner import PhaseKind

PyTree = Any

#: kernel launches since import (the main path's proof that it ran K2);
#: comparison launches by a caller are that caller's to discount
launches = 0
#: the same launches by path
path_launches = {"cluster": 0, "flags": 0}

#: a rank that waits longer than this for a partner gives up: on the flags
#: path the wrapper then raises, on the cluster path the kernel traps,
#: instead of hanging
TIMEOUT_S = 2.0

_PATH_CODES = {"cluster": 0, "flags": 1}
#: ranks the cluster path takes: a cluster of more than 8 CTAs is beyond
#: the portable size, and 16 is Hopper's largest
CLUSTER_MIN_P, CLUSTER_MAX_P = 2, 16
#: threads a CTA of the cluster path; each carries V vectors of 16 bytes a
#: leaf (:func:`cluster_row_vecs`)
CLUSTER_THREADS = 128
#: the flags kernel's tile: 256 threads x 4 elements
FLAGS_TILE = 1024


# ---------------------------------------------------------------------------
# The plain version: the reference kernel's rounds with SpmdBackend permutes
# ---------------------------------------------------------------------------


def comm_phase_spmd_plain(
    kind: PhaseKind, p: int, axis_name: str, op: AssocOp, tree: PyTree, *,
    inclusive: bool = True,
):
    """One comm phase per rank over ``axis_name`` (size ``p``), written with
    :class:`SpmdBackend` permutes; returns a tree, or ``(scan, total)`` for
    FUSED_SCAN_TOTAL."""
    leaves, spec = tree_flatten(tree)
    backend = alg.SpmdBackend(axis_name, p)
    rank = backend.rank()
    fused = kind == PhaseKind.FUSED_SCAN_TOTAL

    def combine(lhs: List[torch.Tensor], rhs: List[torch.Tensor]):
        merged = op.combine(tree_unflatten(lhs, spec), tree_unflatten(rhs, spec))
        return tree_flatten(merged)[0]

    def exchange(vals: List[torch.Tensor], partner) -> List[torch.Tensor]:
        """One full-permutation round: rank r's values go to partner(r)."""
        return backend.permute(vals, [(r, partner(r)) for r in range(p)])

    def masked(vals: List[torch.Tensor], keep) -> List[torch.Tensor]:
        return [alg._bwhere(keep, v, torch.zeros_like(v)) for v in vals]

    if kind in (PhaseKind.TOTAL, PhaseKind.BARRIER):
        # pow2 butterfly: the XOR rounds are full permutations, so the flag
        # stream of allreduce_schedule is constantly 1 and the masked
        # combine reduces to a plain one
        _check_pow2(kind, p)
        acc = leaves
        for d in alg.doubling_strides(p):
            rv = exchange(acc, lambda r, d=d: r ^ d)
            partner_lower = (rank & d) != 0
            lo = combine(rv, acc)
            hi = combine(acc, rv)
            acc = [alg._bwhere(partner_lower, l, h) for l, h in zip(lo, hi)]
        return tree_unflatten(acc, spec)
    if kind not in (PhaseKind.SCAN, PhaseKind.FUSED_SCAN_TOTAL):
        raise ValueError(f"{kind.name} is not a fused comm phase")
    pre = leaves
    if not inclusive:
        # structural entry shift: rank r starts from x_{r-1}
        pre = masked(exchange(leaves, lambda r: (r + 1) % p), rank >= 1)
    suf = leaves
    for d in alg.doubling_strides(p):
        new_pre = combine(
            masked(exchange(pre, lambda r, d=d: (r + d) % p), rank >= d), pre
        )
        if fused:
            suf = combine(
                suf,
                masked(exchange(suf, lambda r, d=d: (r - d + p) % p),
                       rank < p - d),
            )
        pre = new_pre
    if not fused:
        return tree_unflatten(pre, spec)
    # fused exits (same arithmetic as alg.scan_total_schedule)
    if inclusive:
        rv = exchange(suf, lambda r: (r - 1 + p) % p)
        total = combine(pre, masked(rv, rank < p - 1))
        y = pre
    else:
        total = combine(pre, suf)
        y = masked(pre, rank != 0)
    return tree_unflatten(y, spec), tree_unflatten(total, spec)


# ---------------------------------------------------------------------------
# The CUDA kernel, its buffers and its wrapper
# ---------------------------------------------------------------------------


def bind(lib: ctypes.CDLL):
    """The C entry point ``k2_spmd_comm`` of a loaded library, its argument
    types set."""
    fn = lib.k2_spmd_comm
    if fn.argtypes is None:  # first use: declare the signature
        fn.argtypes = (
            [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 12
            + [ctypes.c_uint, ctypes.c_double, ctypes.c_void_p,
               ctypes.POINTER(ctypes.c_int)]
        )
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point of the library built from ``csrc``."""
    from repro_torch.kernels._build import load_library

    return bind(load_library("spmd_collective"))


def exchanges(kind: PhaseKind, p: int, inclusive: bool) -> int:
    """Exchanges (puts + signals) one rank makes in one phase: the receive
    regions and flag rows the kernel needs per rank."""
    steps = alg.num_steps(p)
    if kind in (PhaseKind.TOTAL, PhaseKind.BARRIER):
        return steps
    if kind == PhaseKind.SCAN:
        return steps + (0 if inclusive else 1)
    return 2 * steps + 1  # fused: two streams a round, plus entry or exit


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cluster_row_vecs(itemsize: int, n_leaves: int) -> int:
    """16-byte vectors a cluster-path thread carries a leaf (the kernel's
    ``cl::row_vecs``): the most of 4, 2, 1 that keeps ``n_leaves * V <= 6``
    (at p = 16 a fused phase's 9 slots then take at most 108 KiB, so two
    CTAs share an SM) and a thread's values (two streams and the received
    vectors) within 96."""
    vec = 4
    while vec > 1 and (n_leaves * vec > 6
                       or 3 * n_leaves * (16 // itemsize) * vec > 96):
        vec //= 2
    return vec


@dataclass(frozen=True)
class LaunchPlan:
    """How one K2 call runs: its path, cluster, tile, grid, shared memory
    and launches."""

    path: str                     # "cluster" or "flags"
    cluster: Tuple[int, int, int]  # CTAs a cluster (1, 1, 1 on the flags path)
    tile: int                     # elements of one rank row of a tile
    grid: Tuple[int, int, int]    # blocks; the flags path's grid.x is the
                                  # most it takes, capped at run time at what
                                  # the device holds at once
    slots: int                    # exchanges a rank receives, one slot (or
                                  # receive region) each
    shared_bytes: int             # dynamic shared memory a CTA
    launches: int


@functools.lru_cache(maxsize=1024)
def plan_launch(
    kind: PhaseKind, p: int, M: int, dtype: torch.dtype, n_leaves: int, *,
    inclusive: bool = True, path: Optional[str] = None,
) -> LaunchPlan:
    """The path of one K2 call over ``(p, M)`` rows of ``n_leaves`` leaves:
    ``cluster`` for 2 <= p <= 16, ``flags`` otherwise. :func:`_launch`
    follows it; the C entry checks its tile and shared bytes. ``path``
    names a path to take instead, for a comparison of the two."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the spmd kernel takes {sorted(map(str, _DTYPE_CODES))}; got {dtype}"
        )
    fits = CLUSTER_MIN_P <= p <= CLUSTER_MAX_P
    if path is None:
        path = "cluster" if fits else "flags"
    if path not in _PATH_CODES or (path == "cluster" and not fits):
        raise ValueError(f"K2 has no {path!r} path for p={p}")
    slots = exchanges(kind, p, inclusive)
    launches_ = 1 if M > 0 else 0
    if path == "cluster":
        row_bytes = CLUSTER_THREADS * 16 * cluster_row_vecs(dtype.itemsize,
                                                            n_leaves)
        tile = row_bytes // dtype.itemsize
        bar_bytes = _cdiv(8 * slots, 16) * 16  # one mbarrier a slot
        shared = bar_bytes + slots * n_leaves * row_bytes
        return LaunchPlan("cluster", (p, 1, 1), tile,
                          (p * _cdiv(M, tile), 1, 1), slots, shared, launches_)
    return LaunchPlan("flags", (1, 1, 1), FLAGS_TILE,
                      (_cdiv(M, FLAGS_TILE), p, 1), slots, 0, launches_)


class _Workspace:
    """The flags path's state that outlives a launch, for ``p`` co-resident
    ranks on one device and one stream: the signal flags, the status word
    and the launch epoch.

    Rank ``q``'s flag rows are a slice of one stacked allocation that the
    flag table points into. The epoch goes up by one per launch, so the
    flags (zeroed at allocation) never need a reset. The receive regions
    are not kept: each launch takes them from the caching allocator, and
    the wrapper waits for the kernel before it lets them go. The lock keeps
    one launch and its status read together when threads share a stream.
    """

    def __init__(self, device: torch.device, p: int) -> None:
        self.device = device
        self.p = p
        self.lock = threading.Lock()
        self.flags = torch.zeros(0, dtype=torch.int32, device=device)
        self.status = torch.zeros(4, dtype=torch.int32, device=device)
        self.epoch = 0
        self._flag_table: Optional[torch.Tensor] = None
        self._flag_words = 0

    def flag_table(self, flag_words: int) -> Tuple[torch.Tensor, int]:
        """The flag table for per-rank rows of ``flag_words`` flags, and the
        next epoch; grows the flags (and restarts the epoch) as needed."""
        p = self.p
        if self.flags.numel() < p * flag_words or self.epoch >= 0xFFFFFFFF:
            self.flags = torch.zeros(max(1, p * flag_words), dtype=torch.int32,
                                     device=self.device)
            self.epoch = 0
            self._flag_table = None
        if self._flag_table is None or self._flag_words != flag_words:
            self._flag_table = self.table(self.flags, 4 * flag_words)
            self._flag_words = flag_words
        self.epoch += 1
        return self._flag_table, self.epoch

    def table(self, base: torch.Tensor, stride_bytes: int) -> torch.Tensor:
        """The peer table of ``p`` regions of ``stride_bytes`` laid end to
        end from ``base``, built on the device (no host copy)."""
        start = base.data_ptr()
        return torch.arange(start, start + self.p * stride_bytes, stride_bytes,
                            dtype=torch.int64, device=self.device)


_WORKSPACES: Dict[Tuple[torch.device, int, int], _Workspace] = {}


def _launch(
    kind: PhaseKind, p: int, op: AssocOp, leaves: List[torch.Tensor],
    inclusive: bool, path: Optional[str],
) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
    # co-resident ranks: row r of every leaf is rank r's value
    op_code, flat, ys, ts, back = _stage(kind, p, op, leaves, "spmd kernel")
    dtype, device = flat[0].dtype, flat[0].device
    M = flat[0].shape[1]
    plan = plan_launch(kind, p, M, dtype, len(flat), inclusive=inclusive,
                       path=path)
    if M == 0:
        return back(ys), (back(ts) if ts is not None else None)
    entry = _entry()
    what = f"{kind.name} op={op.name} dtype={dtype} p={p} M={M} ({plan.path})"
    aligned = aligned_rows(flat + ys + (ts or []), M)
    made = ctypes.c_int(0)

    def run(recv=None, flags=None, status=None, epoch=0) -> None:
        global launches
        rc = entry(
            _PATH_CODES[plan.path], _KIND_CODES[kind], op_code,
            _DTYPE_CODES[dtype], int(inclusive), p, M, plan.tile,
            plan.shared_bytes, int(aligned),
            *_pointers(flat), *_pointers(ys), *_pointers(ts),
            recv, flags, status, epoch, TIMEOUT_S, stream, ctypes.byref(made),
        )
        launches += made.value
        path_launches[plan.path] += made.value
        if rc == -3:
            raise RuntimeError(
                f"spmd kernel: {p} co-resident ranks cannot all be resident "
                f"on {device} ({what})"
            )
        if rc != 0:
            raise RuntimeError(f"spmd kernel launch failed (code {rc}) for {what}")

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if plan.path == "cluster":
            # the kernel's waits trap past their deadline: nothing to read
            # back, so the launch returns without waiting for the device
            run()
            return back(ys), (back(ts) if ts is not None else None)
        key = (device, p, stream)
        ws = _WORKSPACES.get(key)
        if ws is None:
            ws = _WORKSPACES.setdefault(key, _Workspace(device, p))
        with ws.lock:
            recv_bytes = plan.slots * len(flat) * M * flat[0].element_size()
            recv = torch.empty(p * recv_bytes, dtype=torch.uint8, device=device)
            recv_tab = ws.table(recv, recv_bytes)
            flag_tab, epoch = ws.flag_table(plan.slots * _cdiv(M, plan.tile))
            run(recv_tab.data_ptr(), flag_tab.data_ptr(), ws.status.data_ptr(),
                epoch)
            # waits for the kernel, so recv may go back to the allocator
            code, rank, ex, tile = ws.status.tolist()
            if code != 0:
                # a later launch must not meet this one's flags or status
                _WORKSPACES.pop(key, None)
                raise RuntimeError(
                    f"spmd kernel: rank {rank} timed out after {TIMEOUT_S} s "
                    f"waiting for exchange {ex} of tile {tile} ({what})"
                )
    return back(ys), (back(ts) if ts is not None else None)


def comm_phase_spmd(
    kind: PhaseKind, p: int, axis_name: str, op: AssocOp, tree: PyTree, *,
    inclusive: bool = True, path: Optional[str] = None,
):
    """Run one comm phase per rank over ``axis_name``: the plain version for
    CPU tensors, one K2 launch (all co-resident ranks at once) on the path
    :func:`plan_launch` picks for CUDA tensors; no fallback between the two.
    ``path`` names a path to take instead, for a comparison of the two."""
    from repro_torch import compat

    leaves = tree_leaves(tree)
    if not leaves or leaves[0].device.type == "cpu":
        return comm_phase_spmd_plain(
            kind, p, axis_name, op, tree, inclusive=inclusive
        )
    if leaves[0].device.type != "cuda":
        raise ValueError(f"no spmd kernel for device {leaves[0].device}")
    mesh = compat.mesh_of(axis_name)
    if not mesh.coresident:
        raise NotImplementedError(
            "K2 over one rank per process needs peer pointers into other "
            "GPUs' memory (symmetric memory); the port launches it for "
            "co-resident ranks only"
        )
    if mesh.axis_names != (axis_name,):
        raise ValueError(
            f"K2 runs over a one-axis mesh, as the reference's spmd kernel; "
            f"got axes {mesh.axis_names}"
        )
    if kind not in _KIND_CODES:
        raise ValueError(f"{kind.name} is not a fused comm phase")
    if _KIND_CODES[kind] == 2:
        _check_pow2(kind, p)
    return _dispatch(
        kind, op, tree,
        lambda group: _launch(kind, p, op, group, inclusive, path),
    )
