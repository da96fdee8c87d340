"""K2, the per-rank collective kernel: one launch per comm phase, every
exchange round inside it, each rank exchanging with its partners through
peer puts and signal flags (PyTorch/CUDA counterpart of the spmd form of
``repro.kernels.pallas_collective``, ``_spmd_comm_kernel``).

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
  (``csrc/spmd_collective.cu``) for all ranks at once, or raise. CUDA
  tensors under a process group raise ``NotImplementedError``: that launch
  needs peer pointers on other GPUs. :data:`launches` counts launches.
* :class:`_Workspace` — the host side that owns the kernel's buffers: the
  signal flags, the status word and the launch epoch, kept per device,
  rank count and stream; each launch takes its receive regions (one per
  exchange and rank) from the caching allocator and builds their peer
  table.

The lowering that calls it is ``fused_collective.lower_fused(plan, op,
axis_names=...)``, the counterpart of ``_lower_pallas_spmd``.
"""

from __future__ import annotations

import ctypes
import threading
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
)
from repro_torch.offload.planner import PhaseKind

PyTree = Any

#: kernel launches since import (the main path's proof that it ran K2);
#: comparison launches by a caller are that caller's to discount
launches = 0

#: a rank that waits longer than this for a partner's signal gives up, and
#: the wrapper raises instead of hanging
TIMEOUT_S = 2.0


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


def _library() -> ctypes.CDLL:
    from repro_torch.kernels._build import load_library

    lib = load_library("spmd_collective")
    fn = lib.k2_spmd_comm
    if fn.argtypes is None:  # first use: declare the signature
        fn.argtypes = (
            [ctypes.c_int] * 5
            + [ctypes.c_longlong]
            + [ctypes.c_void_p] * 12
            + [ctypes.c_uint, ctypes.c_double, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.k2_tile_elems.restype = ctypes.c_int
    return lib


def exchanges(kind: PhaseKind, p: int, inclusive: bool) -> int:
    """Exchanges (puts + signals) one rank makes in one phase: the receive
    regions and flag rows the kernel needs per rank."""
    steps = alg.num_steps(p)
    if kind in (PhaseKind.TOTAL, PhaseKind.BARRIER):
        return steps
    if kind == PhaseKind.SCAN:
        return steps + (0 if inclusive else 1)
    return 2 * steps + 1  # fused: two streams a round, plus entry or exit


class _Workspace:
    """The kernel's state that outlives a launch, for ``p`` co-resident
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
    inclusive: bool,
) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
    global launches
    # co-resident ranks: row r of every leaf is rank r's value
    op_code, flat, ys, ts, back = _stage(kind, p, op, leaves, "spmd kernel")
    dtype, device = flat[0].dtype, flat[0].device
    M = flat[0].shape[1]
    if M > 0:
        lib = _library()
        n_ex = exchanges(kind, p, inclusive)
        ntiles = -(-M // lib.k2_tile_elems())
        what = f"{kind.name} op={op.name} dtype={dtype} p={p} M={M}"
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            key = (device, p, stream)
            ws = _WORKSPACES.get(key)
            if ws is None:
                ws = _WORKSPACES.setdefault(key, _Workspace(device, p))
            with ws.lock:
                recv_bytes = n_ex * len(flat) * M * flat[0].element_size()
                recv = torch.empty(p * recv_bytes, dtype=torch.uint8,
                                   device=device)
                recv_tab = ws.table(recv, recv_bytes)
                flag_tab, epoch = ws.flag_table(n_ex * ntiles)
                rc = lib.k2_spmd_comm(
                    _KIND_CODES[kind], op_code, _DTYPE_CODES[dtype],
                    int(inclusive), p, M,
                    *_pointers(flat), *_pointers(ys), *_pointers(ts),
                    recv_tab.data_ptr(), flag_tab.data_ptr(),
                    ws.status.data_ptr(), epoch, TIMEOUT_S, stream,
                )
                if rc == -3:
                    raise RuntimeError(
                        f"spmd kernel: {p} co-resident ranks cannot all be "
                        f"resident on {device} ({what})"
                    )
                if rc != 0:
                    raise RuntimeError(
                        f"spmd kernel launch failed (code {rc}) for {what}"
                    )
                launches += 1
                # waits for the kernel, so recv may go back to the allocator
                code, rank, ex, tile = ws.status.tolist()
                if code != 0:
                    # a later launch must not meet this one's flags or status
                    _WORKSPACES.pop(key, None)
                    raise RuntimeError(
                        f"spmd kernel: rank {rank} timed out after "
                        f"{TIMEOUT_S} s waiting for exchange {ex} of tile "
                        f"{tile} ({what})"
                    )
    return back(ys), (back(ts) if ts is not None else None)


def comm_phase_spmd(
    kind: PhaseKind, p: int, axis_name: str, op: AssocOp, tree: PyTree, *,
    inclusive: bool = True,
):
    """Run one comm phase per rank over ``axis_name``: the plain version for
    CPU tensors, one K2 launch (all co-resident ranks at once) for CUDA
    tensors; no fallback between the two."""
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
        kind, op, tree, lambda group: _launch(kind, p, op, group, inclusive)
    )
