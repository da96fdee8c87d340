"""K4, the diagonal SSM recurrence ``h_t = a_t * h_{t-1} + b_t`` along time of
``(N, T, D)`` operands (PyTorch/CUDA counterpart of
``repro.kernels.ssd_scan``).

:func:`ssd_rows` is the wrapper: a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.ref_ssd_scan`), a CUDA tensor launches
``csrc/ssd_scan.cu`` (one thread a ``(n, d)`` column walking time in the
natural layout, started from ``h0``) or raises. :data:`launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_ssd_scan

#: kernel launches since import (the main path's proof that it ran K4)
launches = 0

_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
#: threads a block (one feature column each); small blocks spread the
#: N * D columns over more SMs
THREADS = 64


def _library() -> ctypes.CDLL:
    lib = _build.load_library("ssd_scan")
    fn = lib.k4_ssd_scan
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _launch(
    a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]
) -> torch.Tensor:
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
    lib = _library()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = lib.k4_ssd_scan(
            _DTYPE_CODES[b.dtype], a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), h.data_ptr(),
            N, T, D, THREADS, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"SSD scan kernel launch failed (code {rc}) for dtype={b.dtype} "
            f"shape={(N, T, D)}"
        )
    launches += 1
    return h


def ssd_rows(
    a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The state trajectory ``h`` of 3-D ``(N, T, D)`` operands, ``h0`` of
    shape ``(N, D)`` or None: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (no fallback between the two)."""
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
    return _launch(a, b, h0)
