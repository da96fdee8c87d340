"""K2, the per-rank collective kernel: one launch per comm phase, every
exchange round inside it, each rank putting its accumulator straight into
its partner's memory (PyTorch/CUDA counterpart of the spmd form of
``repro.kernels.pallas_collective``, ``_spmd_comm_kernel``).

Three paths, which :func:`plan_launch` picks from the rank group and count:

* ``cluster`` (co-resident ranks, 2 <= p <= 16): one thread-block cluster
  of p CTAs a column tile, a rank a CTA (128 threads, each with V vectors
  of 16 bytes a leaf); every put goes into the partner CTA's shared memory
  and completes on its barrier there. The launch needs nothing but its
  outputs: no workspace, no host read afterwards.
* ``flags`` (co-resident ranks, any other p): thread blocks of every rank in
  one cooperative launch, puts into receive regions in device memory,
  signal flags, and a status word the wrapper reads after the launch.
* ``peers`` (one rank per process of a ``torch.distributed`` group, any p):
  the flags path's program for this process's rank alone. Its receive
  regions, flags and done words live in one block of device memory per
  rank, which every other process maps with CUDA IPC
  (:class:`_PeerWorkspace`); a put goes straight into the partner's block,
  on the same GPU or another.

Four layers, as for every kernel of the port:

* :func:`comm_phase_spmd_plain` — the reference kernel's rounds written with
  :class:`~repro_torch.core.algorithms.SpmdBackend` permutes, line for line:
  cyclic full-permutation sends, the receiver's mask back to zero fill, the
  exclusive entry shift, the prefix stream ``combine(masked_recv, acc)``,
  the suffix stream ``combine(acc, masked_recv)``, the butterfly's
  ``partner_lower`` choice and the fused exits. It runs per rank inside
  :func:`repro_torch.compat.shard_map`, under either kind of rank group; the
  CPU path and the tests use it.
* :func:`comm_phase_spmd` — the wrapper. A CPU tensor takes the plain
  version; CUDA tensors launch the kernel: for co-resident ranks all at
  once on the cluster or flags path, under a process group this rank's
  launch on the peers path. A failed build, IPC mapping or launch raises;
  nothing falls back. :data:`launches` counts the launches the C entries
  report, and :data:`path_launches` the same by path.
* :class:`_Workspace` — the flags path's host side: the signal flags, the
  status word and the launch epoch, kept per device, rank count and
  stream; each launch takes its receive regions (one per exchange and
  rank) from the caching allocator and builds their peer table.
* :class:`_PeerWorkspace` — the peers path's host side, per process group
  and device: this rank's block, every peer's block mapped, the device
  tables, the status word and the epoch, registered collectively and kept
  across launches.

The lowering that calls it is ``fused_collective.lower_fused(plan, op,
axis_names=...)``, the counterpart of ``_lower_pallas_spmd``.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import threading
import weakref
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
from repro_torch.roofline.op_cost import charged

PyTree = Any

#: kernel launches since import (the main path's proof that it ran K2);
#: comparison launches by a caller are that caller's to discount
launches = 0
#: the same launches by path
path_launches = {"cluster": 0, "flags": 0, "peers": 0}

#: a rank that waits longer than this for a partner gives up: on the flags
#: path the wrapper then raises, on the cluster path the kernel traps,
#: instead of hanging
TIMEOUT_S = 2.0
#: the peers path's deadline. Its ranks are processes, each launching when
#: its own host program gets there: a partner's launch may come after
#: seconds of that partner's host work, and on one GPU the contexts are
#: time-sliced as well (a dispatch took 2.7-38 ms at p = 2-8 on an H100).
#: A rank that waits longer raises in its own process.
PEERS_TIMEOUT_S = 30.0

_PATH_CODES = {"cluster": 0, "flags": 1, "peers": 2}
#: ranks the cluster path takes: a cluster of more than 8 CTAs is beyond
#: the portable size, and 16 is Hopper's largest
CLUSTER_MIN_P, CLUSTER_MAX_P = 2, 16
#: threads a CTA of the cluster path (``csrc/spmd_collective.cu``'s
#: ``cl::THREADS``); each carries V vectors of 16 bytes a leaf
#: (:func:`cluster_row_vecs`)
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


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point ``k2_spmd_comm`` of the library built from
    ``csrc``, its argument types set."""
    from repro_torch.kernels._build import load_library

    fn = load_library("spmd_collective").k2_spmd_comm
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
def _peers_library() -> ctypes.CDLL:
    """The library built from ``csrc`` with the peers path's C entry points
    typed: ``k2_spmd_peers`` and the IPC calls ``k2_ipc_alloc``,
    ``k2_ipc_open``, ``k2_ipc_close`` and ``k2_ipc_free``."""
    from repro_torch.kernels._build import load_library

    lib = load_library("spmd_collective")
    lib.k2_spmd_peers.argtypes = (
        [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p] * 13
        + [ctypes.c_uint, ctypes.c_uint, ctypes.c_double,
           ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    )
    lib.k2_spmd_peers.restype = ctypes.c_int
    ptr = ctypes.POINTER(ctypes.c_void_p)
    for name, args in (
        ("k2_ipc_alloc", [ctypes.c_int, ctypes.c_size_t, ptr,
                          ctypes.c_char_p]),
        ("k2_ipc_open", [ctypes.c_int, ctypes.c_char_p, ptr]),
        ("k2_ipc_close", [ctypes.c_int, ctypes.c_void_p]),
        ("k2_ipc_free", [ctypes.c_int, ctypes.c_void_p]),
    ):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    lib.k2_ipc_handle_bytes.restype = ctypes.c_int
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

    path: str                     # "cluster", "flags" or "peers"
    cluster: Tuple[int, int, int]  # CTAs a cluster (1, 1, 1 off the cluster path)
    tile: int                     # elements of one rank row of a tile
    grid: Tuple[int, int, int]    # blocks; the flags and peers paths' grid.x
                                  # is the most they take, capped at run time
                                  # at what the device holds at once
    slots: int                    # exchanges a rank receives, one slot (or
                                  # receive region) each
    shared_bytes: int             # dynamic shared memory a CTA
    launches: int


@functools.lru_cache(maxsize=1024)
def plan_launch(
    kind: PhaseKind, p: int, M: int, dtype: torch.dtype, n_leaves: int, *,
    inclusive: bool = True, path: Optional[str] = None,
    processes: bool = False,
) -> LaunchPlan:
    """The path of one K2 call over ``(p, M)`` rows of ``n_leaves`` leaves:
    ``peers`` for one rank per process (``processes``), else ``cluster`` for
    2 <= p <= 16 and ``flags`` otherwise. :func:`_launch` follows it; the C
    entry checks its tile and shared bytes. ``path`` names a co-resident
    path to take instead, for a comparison of the two."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the spmd kernel takes {sorted(map(str, _DTYPE_CODES))}; got {dtype}"
        )
    fits = CLUSTER_MIN_P <= p <= CLUSTER_MAX_P
    if path is None:
        path = "peers" if processes else "cluster" if fits else "flags"
    if (path not in _PATH_CODES or (path == "cluster" and not fits)
            or (path == "peers") != processes):
        raise ValueError(f"K2 has no {path!r} path for p={p}"
                         + (" in processes" if processes else ""))
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
    return LaunchPlan(path, (1, 1, 1), FLAGS_TILE,
                      (_cdiv(M, FLAGS_TILE), 1 if processes else p, 1), slots,
                      0, launches_)


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


def peer_epoch(epoch: int) -> Tuple[int, int, int]:
    """The peers path's bookkeeping for launch ``epoch`` (1, 2, ... since the
    last registration): ``(parity, done, need)``. The launch uses the flags
    and receive regions of set ``parity``; it publishes ``done`` (its launch
    ``epoch - 1`` has ended, so every read of that launch is over); before
    its first put it waits until each partner's done word reaches ``need``,
    the last launch that used set ``parity`` (0: nothing to wait for)."""
    return epoch & 1, epoch - 1, max(0, epoch - 2)


class _CudaIpc:
    """Blocks of device memory shared between processes with legacy CUDA IPC
    (the C entries beside K2): what :class:`_PeerWorkspace` allocates,
    exports, maps and frees. Pointers are ints, handles bytes."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.lib = _peers_library()

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(
                f"K2 peers path: {what} failed on {self.device} (CUDA error "
                f"{rc}); legacy CUDA IPC between the group's processes is "
                "needed"
            )

    def alloc(self, nbytes: int) -> Tuple[int, bytes]:
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(self.lib.k2_ipc_handle_bytes())
        self._check(self.lib.k2_ipc_alloc(self.device.index, nbytes,
                                          ctypes.byref(ptr), handle),
                    f"cudaMalloc / cudaIpcGetMemHandle of {nbytes} bytes")
        return ptr.value, handle.raw

    def open(self, handle: bytes) -> int:
        ptr = ctypes.c_void_p()
        self._check(self.lib.k2_ipc_open(self.device.index, handle,
                                         ctypes.byref(ptr)),
                    "cudaIpcOpenMemHandle of a peer's block")
        return ptr.value

    def close(self, ptr: int) -> None:
        self._check(self.lib.k2_ipc_close(self.device.index, ptr),
                    "cudaIpcCloseMemHandle")

    def free(self, ptr: int) -> None:
        self._check(self.lib.k2_ipc_free(self.device.index, ptr), "cudaFree")


class _PeerWorkspace:
    """The peers path's state for one process group on one device: this
    rank's block of device memory, every rank's block as this process sees
    it (its own, and the others mapped with CUDA IPC), the device tables of
    peer pointers, the status word and the epoch.

    Every rank's block has one layout, for capacities of ``F`` flag words
    and ``R`` receive bytes a parity set::

        [0, 256)                      the done word (peer_epoch's "done")
        [256, 256 + 8F)               flags, parity set 0 then 1
        [256 + 8F, 256 + 8F + 2R)     receive regions, parity set 0 then 1

    Flags only ever hold epochs, so a stale flag never equals the epoch a
    reader waits for, whatever layout an earlier call gave its set.

    Registration is collective: it runs on every rank at the same call,
    because every rank makes the same calls (one SPMD program) and grows at
    the first that needs more than the capacities. Each rank allocates its
    new block, unmaps its peers' old blocks, and sends its handle, its
    capacities and its epoch to all with ``dist.all_gather_object`` over
    the group; a rank frees its old block only after that exchange, by
    which every peer has unmapped it. A group whose ranks disagree on
    capacities or epoch (ranks that do not run one program) raises on every
    rank, and the workspace is dropped. ``ipc`` makes, maps and frees the
    blocks (:class:`_CudaIpc` on a GPU; tests pass a fake).
    """

    HEADER = 256
    #: epochs a registration serves before the next restarts them at 1
    EPOCH_LIMIT = 0xFFFFFFF0

    def __init__(self, group: Any, device: torch.device, p: int, rank: int,
                 ipc: Any = None) -> None:
        self.group = weakref.ref(group)
        self.device = device
        self.p = p
        self.rank = rank
        self.ipc = _CudaIpc(device) if ipc is None else ipc
        self.lock = threading.Lock()
        self.flag_words = 0      # F
        self.recv_bytes = 0      # R
        self.local: Optional[int] = None
        self.bases: List[int] = []
        self.handles: List[bytes] = []
        self.epoch = 0
        self.registrations = 0
        self.status = torch.zeros(4, dtype=torch.int32, device=device)
        #: (5, p) int64 on the device: receive regions of set 0 and 1,
        #: flags of set 0 and 1, done words
        self.tables: Optional[torch.Tensor] = None

    def layout(self, F: int, R: int) -> Tuple[int, int, int]:
        """Byte offsets of (flags of set 0, receive regions of set 0, the
        block's end) for capacities F and R."""
        flags0 = self.HEADER
        recv0 = flags0 + 8 * F
        return flags0, recv0, recv0 + 2 * R

    def reserve(self, flag_words: int, recv_bytes: int) -> None:
        """Make room for one launch's flags and receive regions a parity
        set; registers anew (collectively) when they outgrow the block or
        the epochs run out."""
        if (flag_words <= self.flag_words and recv_bytes <= self.recv_bytes
                and self.tables is not None and self.epoch < self.EPOCH_LIMIT):
            return
        def grow(need: int, have: int) -> int:  # powers of two from 256
            return 1 << (max(need, 256) - 1).bit_length() if need > have \
                else have

        self._register(grow(flag_words, self.flag_words),
                       grow(recv_bytes, self.recv_bytes))

    def _register(self, F: int, R: int) -> None:
        import torch.distributed as dist

        group = self.group()
        if group is None:
            raise RuntimeError("K2 peers path: the process group is gone")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._unmap()
        new, handle = self.ipc.alloc(self.layout(F, R)[2])
        mine = (self.rank, F, R, self.epoch, handle)
        got: List[Any] = [None] * self.p
        dist.all_gather_object(got, mine, group=group)
        agreed = ([g[0] for g in got] == list(range(self.p))
                  and all(g[1:4] == mine[1:4] for g in got))
        old, self.local = self.local, new
        if old is not None:
            self.ipc.free(old)  # every peer unmapped it before the exchange
        if not agreed:
            self.release()
            raise RuntimeError(
                "K2 peers path: the group's ranks registered (rank, flag "
                f"words, receive bytes, epoch) {[g[:4] for g in got]}; every "
                "rank must make the same calls"
            )
        self.handles = [g[4] for g in got]
        self.bases = [new if q == self.rank else self.ipc.open(h)
                      for q, h in enumerate(self.handles)]
        self.flag_words, self.recv_bytes = F, R
        self.epoch = 0
        flags0, recv0, _ = self.layout(F, R)
        offsets = (recv0, recv0 + R, flags0, flags0 + 4 * F, 0)
        self.tables = torch.tensor(
            [[b + off for b in self.bases] for off in offsets],
            dtype=torch.int64, device=self.device)
        self.status.zero_()
        self.registrations += 1

    def next_epoch(self) -> Tuple[int, int, int]:
        """The next launch's epoch, parity set and the done word its
        partners must have reached (:func:`peer_epoch`)."""
        self.epoch += 1
        parity, _, need = peer_epoch(self.epoch)
        return self.epoch, parity, need

    def _unmap(self) -> None:
        bases, self.bases = self.bases, []
        for q, b in enumerate(bases):
            if q != self.rank:
                self.ipc.close(b)

    def release(self) -> None:
        """Unmap the peers' blocks and free this rank's (no collective: at
        the group's end, or after a failure)."""
        self.tables = None
        try:
            self._unmap()
        finally:
            local, self.local = self.local, None
            if local is not None:
                self.ipc.free(local)


_PEER_WORKSPACES: Dict[Tuple[int, torch.device], _PeerWorkspace] = {}
_PEER_LOCK = threading.Lock()


def peer_workspace(group: Any, device: torch.device, p: int, rank: int,
                   ipc: Any = None) -> _PeerWorkspace:
    """The peers path's workspace of ``group`` on ``device`` (made on first
    use, released when the group object goes away or at exit)."""
    key = (id(group), device)
    with _PEER_LOCK:
        ws = _PEER_WORKSPACES.get(key)
        if ws is not None and ws.group() is not group:
            ws = None  # a group that reused a freed group's id
        if ws is None:
            ws = _PeerWorkspace(group, device, p, rank, ipc)
            _PEER_WORKSPACES[key] = ws
            weakref.finalize(group, _drop_peer_workspace, key, ws)
        if (ws.p, ws.rank) != (p, rank):
            raise ValueError(f"K2 peers path: rank {rank} of {p} on a "
                             f"workspace of rank {ws.rank} of {ws.p}")
        return ws


def _drop_peer_workspace(key, ws: _PeerWorkspace) -> None:
    with _PEER_LOCK:
        if _PEER_WORKSPACES.get(key) is ws:
            del _PEER_WORKSPACES[key]
    try:
        ws.release()
    except RuntimeError:
        pass  # the CUDA context may already be gone at exit


def release_peer_workspaces() -> None:
    """Unmap and free every peers-path workspace of this process; call it
    before ``dist.destroy_process_group()`` (it also runs at exit)."""
    with _PEER_LOCK:
        items = list(_PEER_WORKSPACES.items())
    for key, ws in items:
        _drop_peer_workspace(key, ws)


atexit.register(release_peer_workspaces)


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


def _launch_peers(
    kind: PhaseKind, p: int, rank: int, group: Any, op: AssocOp,
    leaves: List[torch.Tensor], inclusive: bool,
) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
    # one rank per process: every leaf is this rank's own value
    global launches
    op_code, flat, ys, ts, back1 = _stage(
        kind, 1, op, [l.unsqueeze(0) for l in leaves], "spmd kernel")
    dtype, device = flat[0].dtype, flat[0].device
    M = flat[0].shape[1]
    plan = plan_launch(kind, p, M, dtype, len(flat), inclusive=inclusive,
                       processes=True)

    def back(outs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [o.squeeze(0) for o in back1(outs)]

    if M == 0:
        return back(ys), (back(ts) if ts is not None else None)
    lib = _peers_library()
    what = (f"{kind.name} op={op.name} dtype={dtype} rank {rank} of p={p} "
            f"M={M} (peers)")
    ws = peer_workspace(group, device, p, rank)
    made = ctypes.c_int(0)
    with ws.lock, torch.cuda.device(device):
        ws.reserve(plan.slots * _cdiv(M, plan.tile),
                   plan.slots * len(flat) * M * flat[0].element_size())
        epoch, parity, need = ws.next_epoch()
        tab = ws.tables
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.k2_spmd_peers(
            _KIND_CODES[kind], op_code, _DTYPE_CODES[dtype], int(inclusive),
            p, rank, M, plan.tile,
            *_pointers(flat), *_pointers(ys), *_pointers(ts),
            tab[parity].data_ptr(), tab[2 + parity].data_ptr(),
            tab[4].data_ptr(), ws.status.data_ptr(), epoch, need,
            PEERS_TIMEOUT_S, stream, ctypes.byref(made),
        )
        launches += made.value
        path_launches["peers"] += made.value
        if rc != 0:
            _drop_peer_workspace((id(group), device), ws)
            raise RuntimeError(
                f"spmd kernel launch failed (code {rc}) for {what}")
        # waits for the kernel: the next launch (or registration) starts
        # after every read of this one
        code, who, ex, tile = ws.status.tolist()
        if code != 0:
            _drop_peer_workspace((id(group), device), ws)
            waited = ("its partners' done words" if ex < 0
                      else f"exchange {ex} of tile {tile}")
            raise RuntimeError(
                f"spmd kernel: rank {who} timed out after {PEERS_TIMEOUT_S} "
                f"s waiting for {waited} ({what})"
            )
    return back(ys), (back(ts) if ts is not None else None)


def comm_phase_spmd(
    kind: PhaseKind, p: int, axis_name: str, op: AssocOp, tree: PyTree, *,
    inclusive: bool = True, path: Optional[str] = None,
):
    """Run one comm phase per rank over ``axis_name``: the plain version for
    CPU tensors; for CUDA tensors one K2 launch on the path
    :func:`plan_launch` picks, for all co-resident ranks at once or, under a
    process group, for this process's rank. No fallback between any two.
    ``path`` names a co-resident path to take instead, for a comparison.
    Under a ``CostMode`` a call counts as one K2 charge at K2's own cost."""
    leaves = tree_leaves(tree)
    if leaves and leaves[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"no spmd kernel for device {leaves[0].device}")
    with charged("k2", phase=kind.name, p=p,
                 numel=sum(t.numel() for t in leaves),
                 dtype=leaves[0].dtype if leaves else torch.float32):
        return _comm_phase_spmd(kind, p, axis_name, op, tree, leaves,
                                inclusive, path)


def _comm_phase_spmd(kind, p, axis_name, op, tree, leaves, inclusive, path):
    from repro_torch import compat

    if not leaves or leaves[0].device.type == "cpu":
        return comm_phase_spmd_plain(
            kind, p, axis_name, op, tree, inclusive=inclusive
        )
    mesh = compat.mesh_of(axis_name)
    ax = mesh.axis(axis_name)
    if mesh.shape[ax] != p or mesh.size != p:
        raise ValueError(
            f"K2 runs over one mesh axis of p={p} ranks, every other axis of "
            f"size 1; got axes {mesh.axis_names} of {mesh.shape}"
        )
    if kind not in _KIND_CODES:
        raise ValueError(f"{kind.name} is not a fused comm phase")
    if _KIND_CODES[kind] == 2:
        _check_pow2(kind, p)
    if not mesh.coresident:
        if path is not None:
            raise ValueError("a process group takes K2's peers path only")
        rank = mesh.ranks.coords[ax]
        return _dispatch(
            kind, op, tree,
            lambda part: _launch_peers(kind, p, rank, mesh.group, op, part,
                                       inclusive),
        )
    return _dispatch(
        kind, op, tree,
        lambda group: _launch(kind, p, op, group, inclusive, path),
    )
