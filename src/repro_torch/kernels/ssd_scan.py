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


@dataclass(frozen=True)
class Build:
    """The compile-time design of a build of ``csrc/ssd_scan.cu`` (its
    ``K4_*`` macros, which ``k4_ssd_build`` reports)."""

    steps: int = 16          # time steps a warp holds (K4_STEPS)
    time_warps: int = 4      # warps along time (K4_TIME_WARPS)
    feature_warps: int = 2   # warps along features (K4_FEATURE_WARPS)
    vec_bytes: int = 16      # bytes a thread loads at once (K4_VEC_BYTES)
    stage: int = 0           # 1: a and b staged by cp.async (K4_STAGE)
    order: int = 1           # ticket order, 1: column fastest (K4_ORDER)

    @property
    def chunk(self) -> int:
        """Time steps a block, L."""
        return self.steps * self.time_warps

    def d_tile(self, vec: int) -> int:
        """Features a block at vector width ``vec``."""
        return 32 * vec * self.feature_warps


#: the design the shipped source compiles to
SHIPPED = Build()


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
def _plan(N: int, T: int, D: int, path: str, vec: int, build: Build) -> LaunchPlan:
    if path == "column":
        blocks = N * _cdiv(D, COLUMN_THREADS)
        return LaunchPlan("column", 1, COLUMN_THREADS, T, 1, blocks,
                          COLUMN_THREADS, 1, 0, 0)
    d_tile = build.d_tile(vec)
    chunks = _cdiv(T, build.chunk)
    tiles = N * _cdiv(D, d_tile) * chunks
    threads = 32 * build.time_warps * build.feature_warps
    return LaunchPlan("chunked", vec, d_tile, build.chunk, chunks, tiles,
                      threads, 1, HEAD_WORDS + tiles * build.feature_warps,
                      3 * d_tile * tiles)


def plan_launch(
    N: int, T: int, D: int, dtype: torch.dtype, ptrs: Sequence[int] = (), *,
    build: Build = SHIPPED, path: Optional[str] = None,
) -> LaunchPlan:
    """The path, tile, vector width, grid and scratch of one call on
    contiguous ``(N, T, D)`` operands whose data start at ``ptrs`` (a, b and
    h); :func:`_launch` follows it. ``T`` under two chunks takes the column
    path; the chunked path loads ``build.vec_bytes`` at once (4 floats, 8
    bf16 / fp16 values) where ``D`` is a multiple of that many values and
    every pointer is aligned to that many bytes, else one value. ``path`` names a path instead, for a comparison only."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the SSD kernel takes {sorted(map(str, _DTYPE_CODES))}; got {dtype}"
        )
    if path is None:
        path = "chunked" if T >= 2 * build.chunk else "column"
    elif path not in _PATH_CODES:
        raise ValueError(f"no SSD path {path!r}; paths: {sorted(_PATH_CODES)}")
    elif path == "chunked" and T < 2 * build.chunk:
        raise ValueError(f"the chunked path needs T >= {2 * build.chunk}; got {T}")
    vec = build.vec_bytes // dtype.itemsize
    if path == "column" or D % vec or any(p % build.vec_bytes for p in ptrs):
        vec = 1
    return _plan(N, T, D, path, vec, build)


@dataclass(frozen=True)
class Entry:
    """A loaded build's C entry point and the design it was compiled to."""

    fn: object
    build: Build


def bind(lib: ctypes.CDLL) -> Entry:
    """The entry point ``k4_ssd_scan`` of a loaded library, its argument
    types set, with the build's design read from ``k4_ssd_build``."""
    design = (ctypes.c_int * 6)()
    lib.k4_ssd_build.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.k4_ssd_build.restype = None
    lib.k4_ssd_build(design)
    fn = lib.k4_ssd_scan
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
    ]
    fn.restype = ctypes.c_int
    return Entry(fn, Build(*design))


@functools.lru_cache(maxsize=None)
def _entry() -> Entry:
    """The entry point of the library built from ``csrc``, whose design must
    be the one :data:`SHIPPED` plans for."""
    entry = bind(_build.load_library("ssd_scan"))
    if entry.build != SHIPPED:
        raise RuntimeError(
            f"ssd_scan.cu compiles to {entry.build}, the wrapper plans for "
            f"{SHIPPED}"
        )
    return entry


def _launch(
    a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor], *,
    path: Optional[str] = None, entry: Optional[Entry] = None,
) -> torch.Tensor:
    """Run the planned kernel through ``entry`` (default: the library built
    from ``csrc``; another build's :func:`bind` for a comparison)."""
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
    entry = entry or _entry()
    plan = plan_launch(N, T, D, b.dtype,
                       (a.data_ptr(), b.data_ptr(), h.data_ptr()),
                       build=entry.build, path=path)
    ints = values = None
    if plan.path == "chunked":
        ints = torch.zeros(plan.status_words, dtype=torch.int32, device=b.device)
        values = torch.empty(plan.value_floats, dtype=torch.float32,
                             device=b.device)
    made = ctypes.c_int(0)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = entry.fn(
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
    shape ``(N, D)`` or None: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (no fallback between the two). ``path`` names
    the CUDA kernel's path instead of :func:`plan_launch`, for a comparison
    only."""
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
    if b.device.type == "cpu":
        return ref_ssd_scan(a, b, h0)[0]
    if b.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {b.device}")
    if any(t.dtype != b.dtype for t in tensors):
        raise ValueError("the SSD kernel needs a, b and h0 of one dtype")
    return _launch(a, b, h0, path=path)
