"""K5, forward flash attention over ``(BH, S, D)`` operands with causal,
sliding-window and ``q_offset`` masks (PyTorch/CUDA counterpart of
``repro.kernels.flash_attention``).

:func:`attention` is the wrapper: a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.ref_flash_attention`), a CUDA tensor
launches ``csrc/flash_attention.cu`` (one block a ``(bh, 64-row query tile)``,
K/V tiles in shared memory, the running ``(m, l, acc)`` in float32 registers,
the ragged ``Skv`` masked in the kernel) or raises. :data:`launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_flash_attention

#: kernel launches since import (the main path's proof that it ran K5)
launches = 0

_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
#: head sizes the kernel is compiled for
HEAD_DIMS = (32, 64, 128)
_MAX_BH = 65535  # grid.y


def _library() -> ctypes.CDLL:
    lib = _build.load_library("flash_attention")
    fn = lib.k5_flash_attention
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    window: int, q_offset: int,
) -> torch.Tensor:
    global launches
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the flash kernel takes {sorted(map(str, _DTYPE_CODES))}; got {q.dtype}"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the flash kernel needs q, k and v of one dtype")
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head sizes {HEAD_DIMS}; got {D}")
    if BH > _MAX_BH:
        raise ValueError(f"the flash kernel takes at most {_MAX_BH} heads; got {BH}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.k5_flash_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), BH, Sq, Skv, D, int(causal), int(window),
            int(q_offset), 1.0 / (D ** 0.5), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed (code {rc}) for "
            f"dtype={q.dtype} q={tuple(q.shape)} k={tuple(k.shape)}"
        )
    launches += 1
    return o


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, q_offset: int = 0,
) -> torch.Tensor:
    """Attention of ``(BH, Sq, D)`` queries over ``(BH, Skv, D)`` keys and
    values: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (no fallback between the two)."""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(
            f"expected (BH, Sq, D) q and matching (BH, Skv, D) k, v; got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if k.shape[1] == 0:
        raise ValueError("attention over zero keys")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must share one device")
    if q.device.type == "cpu":
        return ref_flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    return _launch(q, k, v, causal=causal, window=window, q_offset=q_offset)
