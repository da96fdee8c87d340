"""K6, the chunk output of the chunked SSD: ``y = y_intra + y_inter`` of
:func:`repro_torch.models.mamba._ssd_chunked` for every (batch, chunk, head)
in one launch (``csrc/ssd_chunk.cu``). It has no counterpart among the
reference's kernels: the reference computes the chunk output in jnp.

:func:`chunk_out` is the wrapper: a CPU (or ``meta``) tensor takes the plain
version (:func:`repro_torch.kernels.ref.ref_ssd_chunk_out`), a CUDA tensor
launches the kernel or raises. Both take the same operands, which the
wrapper checks on every device:

* ``scores`` ``(B, c, Q, Q)``: the chunk's ``C B^T`` in the model's type
  (bfloat16 or float16), as its einsum rounded them;
* ``seg`` ``(B, c, H, Q)`` float32: the within-chunk cumulative log decay in
  K3's layout;
* ``x`` ``(B, c, Q, H, P)``: the dt-scaled inputs, in the model's type;
* ``C`` ``(B, c, Q, N)`` in the model's type, its rows evenly strided (a
  view of wider rows, such as the C half of the mixer's BC projection, is
  taken as it is);
* ``S_exc`` ``(B, c, H, P, N)`` float32: each chunk's incoming state;

with the type, ``Q``, ``P`` and ``N`` that :func:`takes` admits. It returns
y ``(B, c, Q, H, P)`` in float32.

:data:`launches` counts the kernels that the C entry point reports having
launched. Each call of :func:`chunk_out` is one ``k6.call`` span
(:mod:`repro_torch.obs.tracing`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_ssd_chunk_out
from repro_torch.obs import tracing as obs_tracing
from repro_torch.roofline.op_cost import charged

#: kernel launches since import (the main path's proof that it ran K6)
launches = 0

_DTYPE_CODES = {torch.bfloat16: 2, torch.float16: 3}
#: the kernel's widths and tiles (``csrc/ssd_chunk.cu``'s ``HEAD_DIM``,
#: ``STATE``, ``ROWS`` and ``MAX_CHUNK``): features a head, state entries,
#: query rows a block (the chunk length's unit) and the longest chunk
HEAD_DIM = 64
STATE = 128
CHUNK_ROWS = 64
MAX_CHUNK = 256


def takes(dtype: Optional[torch.dtype], Q: int, P: int, N: int) -> bool:
    """Whether K6 is built for a call: scores, x and C all of ``dtype``
    (None where they differ), bfloat16 or float16; chunks of a multiple of
    ``CHUNK_ROWS`` rows up to ``MAX_CHUNK``; ``P = HEAD_DIM``, ``N = STATE``."""
    return (dtype in _DTYPE_CODES and Q % CHUNK_ROWS == 0
            and 0 < Q <= MAX_CHUNK and P == HEAD_DIM and N == STATE)


def _rows_stride(C: torch.Tensor) -> int:
    """The element stride between consecutive rows of a ``(B, c, Q, N)``
    ``C`` whose rows are evenly strided, or 0 where they are not."""
    B, nc, Q, N = C.shape
    if C.stride(3) != 1 and N > 1:
        return 0
    ld = C.stride(2) if Q > 1 else N
    for size, stride, want in ((nc, C.stride(1), Q * ld),
                               (B, C.stride(0), nc * Q * ld)):
        if size > 1 and stride != want:
            return 0
    return ld


def _check(scores, seg, x, C, S_exc) -> int:
    """Raise on what the kernel does not take; returns C's row stride."""
    if scores.ndim != 4 or x.ndim != 5 or seg.ndim != 4 or C.ndim != 4 \
            or S_exc.ndim != 5:
        raise ValueError(
            "expected scores (B, c, Q, Q), seg (B, c, H, Q), x (B, c, Q, H, P), "
            "C (B, c, Q, N) and S_exc (B, c, H, P, N); got "
            f"{[tuple(t.shape) for t in (scores, seg, x, C, S_exc)]}")
    B, nc, Q, H, P = x.shape
    N = C.shape[-1]
    if (scores.shape != (B, nc, Q, Q) or seg.shape != (B, nc, H, Q)
            or C.shape != (B, nc, Q, N) or S_exc.shape != (B, nc, H, P, N)):
        raise ValueError(
            f"operands disagree: scores {tuple(scores.shape)}, seg "
            f"{tuple(seg.shape)}, x {tuple(x.shape)}, C {tuple(C.shape)}, "
            f"S_exc {tuple(S_exc.shape)}")
    dtype = x.dtype if scores.dtype == C.dtype == x.dtype else None
    if not takes(dtype, Q, P, N):
        raise ValueError(
            f"K6 takes scores, x and C of one type, bfloat16 or float16, "
            f"chunks of a multiple of {CHUNK_ROWS} rows up to {MAX_CHUNK}, "
            f"P = {HEAD_DIM} and N = {STATE}; got {scores.dtype}, {x.dtype}, "
            f"{C.dtype}, Q = {Q}, P = {P}, N = {N}")
    if seg.dtype != torch.float32 or S_exc.dtype != torch.float32:
        raise ValueError(
            f"K6 takes seg and S_exc in float32; got {seg.dtype}, {S_exc.dtype}")
    if any(t.device != x.device for t in (scores, seg, C, S_exc)):
        raise ValueError("K6's operands must share one device")
    if x.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"no K6 for device {x.device}")
    if not all(t.is_contiguous() for t in (scores, seg, x, S_exc)):
        raise ValueError("K6 takes scores, seg, x and S_exc contiguous")
    ld = _rows_stride(C)
    if ld < N or ld % 8:
        raise ValueError(
            "K6 takes C with unit-stride rows evenly strided by a multiple of "
            f"8 elements; got strides {C.stride()}")
    if x.device.type == "cuda" and any(
            t.data_ptr() % 16 for t in (scores, seg, x, C, S_exc)):
        raise ValueError("K6 takes operands whose data start on 16 bytes")
    return ld


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point ``k6_ssd_chunk`` of the library built from
    ``csrc``, its argument types set."""
    fn = _build.load_library("ssd_chunk").k6_ssd_chunk
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(scores, seg, x, C, S_exc, ld: int) -> torch.Tensor:
    """Run the kernel of the library built from ``csrc``."""
    global launches
    B, nc, Q, H, P = x.shape
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    made = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        rc = _entry()(
            _DTYPE_CODES[x.dtype], scores.data_ptr(), seg.data_ptr(),
            x.data_ptr(), C.data_ptr(), ld, S_exc.data_ptr(), y.data_ptr(),
            B * nc, Q, H, _build.raw_stream(x.device.index), ctypes.byref(made))
    launches += made.value
    if rc != 0:
        raise RuntimeError(
            f"K6 launch failed (code {rc}) for dtype={x.dtype} "
            f"x={tuple(x.shape)}")
    return y


def chunk_out(scores: torch.Tensor, seg: torch.Tensor, x: torch.Tensor,
              C: torch.Tensor, S_exc: torch.Tensor) -> torch.Tensor:
    """The chunk output y ``(B, c, Q, H, P)`` float32 (the module docstring
    gives the operands): the plain version for CPU (or ``meta``) tensors,
    the CUDA kernel for CUDA tensors (no fallback between the two). Under a
    ``CostMode`` a call counts as one K6 charge at K6's own cost."""
    ld = _check(scores, seg, x, C, S_exc)
    B, nc, Q, H, P = x.shape
    with obs_tracing.span("k6.call", "kernel"), charged(
            "k6", batch=B, chunks=nc, chunk=Q, heads=H, head_dim=P,
            state=C.shape[-1], dtype=x.dtype):
        if x.device.type != "cuda":
            return ref_ssd_chunk_out(scores, seg, x, C, S_exc)
        return _launch(scores, seg, x, C, S_exc, ld)
