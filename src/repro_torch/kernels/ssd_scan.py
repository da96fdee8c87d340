"""K4, the diagonal SSM recurrence ``h_t = a_t * h_{t-1} + b_t`` along time of
``(N, T, D)`` operands (PyTorch/CUDA counterpart of
``repro.kernels.ssd_scan``).

:func:`ssd_rows` is the wrapper: a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.ref_ssd_scan`), a CUDA tensor launches
``csrc/ssd_scan.cu`` on the path that :func:`plan_launch` picks, or raises:

* ``chunked`` (``T`` of at least two chunks): a block scans one time chunk of
  ``D_TILE`` features into a (decay product, state) pair and takes its
  carry-in from the blocks before it through a decoupled look-back in device
  memory, so ``a`` and ``b`` are read once and ``h`` written once. The
  look-back's status words and values are scratch allocated for each call
  (the status words with ``torch.zeros``: one memset a call).
* ``column`` (shorter ``T``, nothing to look back on): one thread a
  ``(n, d)`` column walking time, started from ``h0``.

:data:`launches` counts the kernels that the C entry point reports having
launched, and :data:`path_launches` the same by path.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_ssd_scan
from repro_torch.roofline.op_cost import charged

#: kernel launches since import (the main path's proof that it ran K4)
launches = 0
#: the same, by path
path_launches = {"chunked": 0, "column": 0}

_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
_PATH_CODES = {"column": 0, "chunked": 1}
#: threads a block of the column path (one feature column each); small
#: blocks spread the N * D columns over more SMs
COLUMN_THREADS = 64
#: scratch words before the tiles' status words (the ticket, the timeout)
HEAD_WORDS = 2
#: a look-back wait longer than this traps (the context is lost, the next
#: synchronisation raises) instead of hanging
TIMEOUT_S = 2.0
#: the chunked kernel's design (``csrc/ssd_scan.cu``'s ``STEPS``, ``TW``,
#: ``FW`` and ``VEC_BYTES``): time steps a warp holds, warps along time and
#: along features, and bytes a thread loads at once
STEPS = 16
TIME_WARPS = 4
FEATURE_WARPS = 2
VEC_BYTES = 16
#: time steps a block of the chunked path
CHUNK = STEPS * TIME_WARPS


@dataclass(frozen=True)
class LaunchPlan:
    """How one call runs: its path, tile, vector width, grid and scratch."""

    path: str          # "chunked" or "column"
    vec: int           # values a thread loads at once (1 on the column path)
    d_tile: int        # features a block
    chunk: int         # time steps a block (T on the column path)
    chunks: int        # time chunks of a column (1 on the column path)
    blocks: int        # the grid
    threads: int       # threads a block
    launches: int      # kernel launches of the call
    status_words: int  # int32 scratch words, zeroed (0 on the column path)
    value_floats: int  # float32 scratch for the look-back's values


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def _plan(N: int, T: int, D: int, path: str, vec: int) -> LaunchPlan:
    if path == "column":
        blocks = N * _cdiv(D, COLUMN_THREADS)
        return LaunchPlan("column", 1, COLUMN_THREADS, T, 1, blocks,
                          COLUMN_THREADS, 1, 0, 0)
    d_tile = 32 * vec * FEATURE_WARPS
    chunks = _cdiv(T, CHUNK)
    tiles = N * _cdiv(D, d_tile) * chunks
    threads = 32 * TIME_WARPS * FEATURE_WARPS
    return LaunchPlan("chunked", vec, d_tile, CHUNK, chunks, tiles,
                      threads, 1, HEAD_WORDS + tiles * FEATURE_WARPS,
                      3 * d_tile * tiles)


def plan_launch(
    N: int, T: int, D: int, dtype: torch.dtype, ptrs: Sequence[int] = (), *,
    path: Optional[str] = None,
) -> LaunchPlan:
    """The path, tile, vector width, grid and scratch of one call on
    contiguous ``(N, T, D)`` operands whose data start at ``ptrs`` (a, b and
    h); :func:`_launch` follows it. ``T`` under two chunks takes the column
    path; the chunked path loads :data:`VEC_BYTES` at once (4 floats, 8
    bf16 / fp16 values) where ``D`` is a multiple of that many values and
    every pointer is aligned to that many bytes, else one value. ``path``
    names a path instead, for a comparison only."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the SSD kernel takes {sorted(map(str, _DTYPE_CODES))}; got {dtype}"
        )
    if path is None:
        path = "chunked" if T >= 2 * CHUNK else "column"
    elif path not in _PATH_CODES:
        raise ValueError(f"no SSD path {path!r}; paths: {sorted(_PATH_CODES)}")
    elif path == "chunked" and T < 2 * CHUNK:
        raise ValueError(f"the chunked path needs T >= {2 * CHUNK}; got {T}")
    vec = VEC_BYTES // dtype.itemsize
    if path == "column" or D % vec or any(p % VEC_BYTES for p in ptrs):
        vec = 1
    return _plan(N, T, D, path, vec)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point ``k4_ssd_scan`` of the library built from
    ``csrc``, its argument types set."""
    fn = _build.load_library("ssd_scan").k4_ssd_scan
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(
    a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor], *,
    path: Optional[str] = None,
) -> torch.Tensor:
    """Run the planned kernel of the library built from ``csrc``."""
    global launches
    if b.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the SSD kernel takes {sorted(map(str, _DTYPE_CODES))}; got {b.dtype}"
        )
    a, b = a.contiguous(), b.contiguous()
    if h0 is not None:
        h0 = h0.contiguous()
    N, T, D = b.shape
    h = torch.empty_like(b)
    if h.numel() == 0:
        return h
    plan = plan_launch(N, T, D, b.dtype,
                       (a.data_ptr(), b.data_ptr(), h.data_ptr()), path=path)
    ints = values = None
    if plan.path == "chunked":
        ints = torch.zeros(plan.status_words, dtype=torch.int32, device=b.device)
        values = torch.empty(plan.value_floats, dtype=torch.float32,
                             device=b.device)
    made = ctypes.c_int(0)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = _entry()(
            _DTYPE_CODES[b.dtype], _PATH_CODES[plan.path], plan.vec,
            plan.d_tile, plan.chunk, a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), h.data_ptr(), N, T, D,
            plan.blocks, None if ints is None else ints.data_ptr(),
            None if values is None else values.data_ptr(), TIMEOUT_S, stream,
            ctypes.byref(made),
        )
    launches += made.value
    path_launches[plan.path] += made.value
    if rc != 0:
        raise RuntimeError(
            f"SSD scan kernel launch failed (code {rc}) on the {plan.path} "
            f"path for dtype={b.dtype} shape={(N, T, D)}"
        )
    return h


def ssd_rows(
    a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
    path: Optional[str] = None,
) -> torch.Tensor:
    """The state trajectory ``h`` of 3-D ``(N, T, D)`` operands, ``h0`` of
    shape ``(N, D)`` or None: the plain version for CPU (or ``meta``)
    tensors, the CUDA kernel for CUDA tensors (no fallback between the
    two). ``path`` names the CUDA kernel's path instead of
    :func:`plan_launch`, for a comparison only. Under a ``CostMode`` a
    call counts as one K4 charge at K4's own cost."""
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(
            f"expected matching 3D (N, T, D) shapes, got {tuple(a.shape)} "
            f"{tuple(b.shape)}"
        )
    if h0 is not None and h0.shape != (b.shape[0], b.shape[2]):
        raise ValueError(f"h0 must be (N, D); got {tuple(h0.shape)}")
    tensors = [a, b] + ([] if h0 is None else [h0])
    if any(t.device != b.device for t in tensors):
        raise ValueError("a, b and h0 must share one device")
    if b.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"no SSD kernel for device {b.device}")
    N, T, D = b.shape
    with charged("k4", rows=N, time=T, width=D, dtype=b.dtype,
                 h0=h0 is not None):
        if b.device.type != "cuda":
            return ref_ssd_scan(a, b, h0)[0]
        if any(t.dtype != b.dtype for t in tensors):
            raise ValueError("the SSD kernel needs a, b and h0 of one dtype")
        return _launch(a, b, h0, path=path)
