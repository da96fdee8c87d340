"""K3, the on-chip block scan: inclusive or exclusive add / max / mul prefix
scan along the last axis of a 2-D ``(R, L)`` tensor (PyTorch/CUDA counterpart
of ``repro.kernels.prefix_scan``).

The paper offloads the inter-node scan to the NIC; this is the intra-node
half. :func:`scan_rows` is the wrapper: a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.ref_prefix_scan`), as a ``meta`` one does
(shapes alone, for a counted dry run), a CUDA tensor launches
``csrc/prefix_scan.cu`` on the path that :func:`plan_launch` picks, or
raises:

* ``rows`` (a row of at most :data:`ROWS_MAX_BYTES`): one warp a row, several
  rows a block, the row's 16-byte vectors all loaded before any combine, the
  lane totals scanned with shuffles; no shared memory, no barrier.
* ``tiles`` (longer rows, at least :data:`TILES_MIN_ROWS` of them): one block
  a row walking tiles, the next tile's loads in flight while the current one
  is scanned, one barrier a tile.
* ``lookback`` (few long rows): each row cut into chunks, one block a chunk,
  joined by a decoupled look-back over one 64-bit status word a chunk. The
  status words are scratch of each call, zeroed by one memset in the C entry
  (no kernel launch).

The exclusive shift happens in the kernel on every path. ``reverse=True``
scans each row back to front, for the add scan only (the kernel's
instantiation for it reads its vectors from the row's end and reverses them
in registers; the plain version flips).

:class:`PrefixScan` is the scan as a ``torch.autograd.Function``: the
gradient of an add scan is the add scan of the incoming gradient run back to
front, inclusive or exclusive as the forward was, so K3 computes its own
backward on the card (the plain version both ways on the CPU).
:func:`repro_torch.kernels.ops.prefix_scan` takes it under autograd, and
raises ``NotImplementedError`` for a ``max`` or ``mul`` scan of a tensor
that requires grad: those have no backward here.

Every call of :func:`scan_rows` runs in the span ``k3.call``
(:mod:`repro_torch.obs.tracing`). :data:`launches` counts every kernel
launch (one a call);
:data:`reverse_launches` counts the back-to-front ones among them, which on
the training path are the Function's backward; :data:`path_launches` counts
them by path.

Under a :class:`~repro_torch.roofline.op_cost.CostMode` each call of
:func:`scan_rows`, the one place K3 launches (forward, its recomputation
and the Function's backward alike), counts as one K3 charge at K3's own
cost, whichever implementation runs.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_prefix_scan
from repro_torch.obs import tracing as obs_tracing
from repro_torch.roofline.op_cost import charged

#: kernel launches since import (the main path's proof that it ran K3)
launches = 0
#: the back-to-front launches among :data:`launches` (K3's backward)
reverse_launches = 0
#: :data:`launches` by path
path_launches = {"rows": 0, "tiles": 0, "lookback": 0}

_OP_CODES = {"add": 0, "max": 1, "mul": 2}
_DTYPE_CODES = {
    torch.int32: 0,
    torch.float32: 1,
    torch.bfloat16: 2,
    torch.float16: 3,
    torch.int8: 4,
}
_PATH_CODES = {"rows": 0, "tiles": 1, "lookback": 2}
#: the longest row, in bytes, that the rows path takes (eight of its
#: 1 KiB batches): at 2048 float32 rows on an H100 the rows path beat the
#: tiles path at 4 and 8 KiB a row and lost at 12 and 16 KiB (PR 24's chip
#: runs)
ROWS_MAX_BYTES = 8192
#: the fewest rows that the tiles path takes: two per SM of an H100 (132);
#: fewer long rows leave SMs idle and take the look-back instead
TILES_MIN_ROWS = 264
#: 64-bit scratch words before the look-back's status words (the ticket, the
#: timeout: a look-back wait past 2 s traps, so the next synchronisation
#: raises instead of hanging)
HEAD_WORDS = 2
#: the kernels' design (``csrc/prefix_scan.cu``'s constants of the same
#: names): bytes a lane loads at once on the vector variant, threads a block
#: of each path (a warp a row on the rows path) and vectors a thread holds a
#: look-back chunk
VEC_BYTES = 16
ROW_THREADS = 256
TILE_THREADS = 256
CHUNK_THREADS = 128
CHUNK_VECS = 8


@dataclass(frozen=True)
class LaunchPlan:
    """How one call (one kernel launch) runs: its path, vector width,
    block, chunks and grid, and the look-back's scratch."""

    path: str            # "rows", "tiles" or "lookback"
    vec: int             # elements a lane loads at once (1: one-element variant)
    threads: int         # threads a block
    rows_per_block: int  # rows a block scans
    chunk: int           # elements of a row one block scans (L off the look-back)
    chunks: int          # chunks a row (1 off the look-back)
    blocks: int          # the grid
    status_words: int    # 64-bit scratch words, zeroed a call (0 off the look-back)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def _plan(R: int, L: int, dtype: torch.dtype, op: str, reverse: bool,
          aligned: bool, path: Optional[str],
          vec: Optional[int]) -> LaunchPlan:
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the scan kernel takes {sorted(map(str, _DTYPE_CODES))}; got {dtype}"
        )
    if op not in _OP_CODES:
        raise ValueError(f"unknown op {op!r}")
    if reverse and op != "add":
        raise ValueError(f"only the add scan runs back to front; got {op!r}")
    if path is None:
        if L * dtype.itemsize <= ROWS_MAX_BYTES:
            path = "rows"
        else:
            path = "tiles" if R >= TILES_MIN_ROWS else "lookback"
    elif path not in _PATH_CODES:
        raise ValueError(f"no K3 path {path!r}; paths: {sorted(_PATH_CODES)}")
    wide = max(1, VEC_BYTES // dtype.itemsize)
    if vec is None:
        vec = wide if aligned and L % wide == 0 else 1
    elif vec not in (1, wide):
        raise ValueError(f"K3 loads 1 or {wide} elements of {dtype}; got {vec}")
    elif L % vec:
        raise ValueError(f"a vector of {vec} does not divide L = {L}")
    if path == "rows":
        per_block = ROW_THREADS // 32
        return LaunchPlan("rows", vec, ROW_THREADS, per_block, L, 1,
                          _cdiv(R, per_block), 0)
    if path == "tiles":
        return LaunchPlan("tiles", vec, TILE_THREADS, 1, L, 1, R, 0)
    chunk = CHUNK_THREADS * vec * CHUNK_VECS
    chunks = _cdiv(L, chunk)
    return LaunchPlan("lookback", vec, CHUNK_THREADS, 1, chunk, chunks,
                      R * chunks, HEAD_WORDS + R * chunks)


def plan_launch(
    R: int, L: int, dtype: torch.dtype, op: str = "add",
    exclusive: bool = False, reverse: bool = False, ptrs: Sequence[int] = (),
    *, path: Optional[str] = None, vec: Optional[int] = None,
) -> LaunchPlan:
    """The path, vector width, block, grid and scratch of one call on a
    contiguous ``(R, L)`` tensor whose input and output start at ``ptrs``;
    :func:`_launch` follows it. The vector variant loads :data:`VEC_BYTES`
    at once where ``L`` is a multiple of that many elements and every
    pointer is aligned to that many bytes, else one element. ``exclusive``
    changes nothing: the shift is in registers. ``path`` and ``vec`` name a
    path or width instead, for a comparison only."""
    del exclusive
    aligned = not any(p % VEC_BYTES for p in ptrs)
    return _plan(R, L, dtype, op, reverse, aligned, path, vec)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point ``k3_prefix_scan`` of the library built from
    ``csrc``, its argument types set."""
    fn = _build.load_library("prefix_scan").k3_prefix_scan
    # (code, x, y, R, L, ws, stream): every argument declared a pointer,
    # which ctypes converts from an int fastest; the integers (long long in
    # C) pass in the same 64-bit registers on an LP64 host
    fn.argtypes = [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    return fn


#: the calls planned so far (see :func:`_call`)
_CALLS: dict = {}


def _call(R: int, L: int, dtype: torch.dtype, op: str, exclusive: bool,
          reverse: bool, aligned: bool, path: Optional[str],
          vec: Optional[int]):
    """The plan of a call and the call packed into the C entry's one word
    (``csrc/prefix_scan.cu``: path, op, dtype, vector width, exclusive,
    reverse, grid), kept for the calls to come."""
    key = (R, L, dtype, op, exclusive, reverse, aligned, path, vec)
    hit = _CALLS.get(key)
    if hit is None:
        plan = _plan(R, L, dtype, op, reverse, aligned, path, vec)
        code = (_PATH_CODES[plan.path] | _OP_CODES[op] << 2
                | _DTYPE_CODES[dtype] << 4 | plan.vec << 7
                | int(exclusive) << 12 | int(reverse) << 13
                | plan.blocks << 16)
        hit = _CALLS[key] = (plan, code)
    return hit


def _launch(
    x: torch.Tensor, op: str, exclusive: bool, reverse: bool, *,
    path: Optional[str] = None, vec: Optional[int] = None,
) -> torch.Tensor:
    """Run the planned kernel of the library built from ``csrc``."""
    global launches, reverse_launches
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the scan kernel takes {sorted(map(str, _DTYPE_CODES))}; got {x.dtype}"
        )
    x = x.contiguous()
    R, L = x.shape
    y = torch.empty_like(x)
    if R == 0 or L == 0:
        return y
    device = x.get_device()
    if device != _build.current_device():
        raise ValueError(
            f"the scan's input lies on cuda:{device}, the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    xp, yp = x.data_ptr(), y.data_ptr()
    plan, code = _call(R, L, x.dtype, op, exclusive, reverse,
                       not (xp | yp) % VEC_BYTES, path, vec)
    ws = None
    if plan.status_words:
        ws = torch.empty(plan.status_words, dtype=torch.int64, device=x.device)
    rc = _entry()(code, xp, yp, R, L, None if ws is None else ws.data_ptr(),
                  _build.raw_stream(device))
    if rc != 0:
        raise RuntimeError(
            f"prefix scan kernel launch failed (code {rc}) on the {plan.path} "
            f"path for op={op} dtype={x.dtype} shape={(R, L)} reverse={reverse}"
        )
    launches += 1
    reverse_launches += int(reverse)
    path_launches[plan.path] += 1
    return y


def scan_rows(
    x: torch.Tensor, *, op: str = "add", exclusive: bool = False,
    reverse: bool = False,
) -> torch.Tensor:
    """Scan every row of a 2-D tensor, back to front with ``reverse`` (an
    add scan only): the plain version for a CPU (or ``meta``) tensor, the
    CUDA kernel for a CUDA tensor (no fallback between the two). The result
    carries no autograd history; a gradient goes through
    :class:`PrefixScan`."""
    if x.ndim != 2:
        raise ValueError(f"expected 2D (rows, length), got {tuple(x.shape)}")
    if reverse and op != "add":
        raise ValueError(f"only the add scan runs back to front; got {op!r}")
    on_card = x.is_cuda
    if not on_card and x.device.type not in ("cpu", "meta"):
        raise ValueError(f"no scan kernel for device {x.device}")
    with obs_tracing.span("k3.call", "kernel"), charged(
            "k3", rows=x.shape[0], length=x.shape[1], dtype=x.dtype,
            reverse=reverse):
        if on_card:
            return _launch(x, op, exclusive, reverse)
        if reverse:
            return ref_prefix_scan(x.flip(-1), op,
                                   exclusive=exclusive).flip(-1)
        return ref_prefix_scan(x, op, exclusive=exclusive)


class PrefixScan(torch.autograd.Function):
    """An add scan of the rows of a 2-D tensor whose gradient is K3 run back
    to front (:func:`scan_rows` both ways, so the CPU takes the plain
    version both ways)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, exclusive: bool) -> torch.Tensor:
        ctx.exclusive = exclusive
        with torch.no_grad():
            return scan_rows(x.detach(), op="add", exclusive=exclusive)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return (scan_rows(grad.contiguous(), op="add",
                          exclusive=ctx.exclusive, reverse=True), None)
