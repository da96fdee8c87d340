"""K5, forward flash attention over ``(BH, S, D)`` operands with causal,
sliding-window and ``q_offset`` masks (PyTorch/CUDA counterpart of
``repro.kernels.flash_attention``).

:func:`attention` is the wrapper: a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.ref_flash_attention`), a CUDA tensor
launches the kernels of ``csrc/flash_attention.cu`` on the path that
:func:`plan_launch` picks, or raises:

* ``decode`` (``Sq <= DECODE_MAX_SQ``, every dtype): the keys of each head
  are split into chunks so that the grid fills the card; one launch writes
  float32 partials ``(m, l, acc)`` per chunk and a second combines them
  (one launch when a single chunk suffices).
* ``tc`` (bfloat16 / float16, longer queries): both products on the tensor
  cores (``wgmma``), K/V tiles brought in by TMA.
* ``simt`` (float32, longer queries): the products on the CUDA cores in
  float32.

:data:`launches` counts the kernel launches that the C entry point reports
having made (each counted once ``cudaGetLastError()`` passed it). Each call
of :func:`attention` is one ``k5.call`` span (:mod:`repro_torch.obs.tracing`).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_flash_attention
from repro_torch.obs import tracing as obs_tracing
from repro_torch.roofline.op_cost import charged

#: kernel launches since import (the main path's proof that it ran K5)
launches = 0

_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
_PATH_CODES = {"simt": 0, "tc": 1, "decode": 2}
#: head sizes the kernels are compiled for
HEAD_DIMS = (32, 64, 128)
_MAX_BH = 65535  # the simt kernel's grid.y

#: query rows up to which a call takes the decode path
DECODE_MAX_SQ = 16
#: streaming multiprocessors of an H100; the decode grid aims at four
#: blocks on each (and keeps at least two where the keys allow)
SMS = 132
DECODE_TARGET_BLOCKS = 4 * SMS
#: query rows and keys a block of the tensor-core kernel takes
#: (``csrc/flash_attention.cu``'s ``tc::BQ`` and ``tc::BKV``)
TC_BLOCK_Q = 128
TC_BLOCK_KV = 128
#: query rows a block of the simt kernel takes (its ``BQ``)
SIMT_BLOCK_Q = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class LaunchPlan:
    """How one call runs: its path, tiles, key splits and launches."""

    path: str        # "decode", "tc" or "simt"
    block_q: int     # query rows a block (decode: every row of the call)
    block_kv: int    # keys a staged tile
    splits: int      # key chunks of each head (1 off the decode path)
    split_len: int   # keys a chunk (decode), a multiple of block_kv
    key_lo: int      # first key of chunk 0 (decode), a multiple of block_kv
    launches: int    # kernel launches of the call
    blocks: int      # blocks of the first launch

    def split_ranges(self, Skv: int) -> List[Tuple[int, int]]:
        """The ``[start, end)`` keys of each decode chunk."""
        return [(self.key_lo + i * self.split_len,
                 min(Skv, self.key_lo + (i + 1) * self.split_len))
                for i in range(self.splits)]


def key_range(Sq: int, Skv: int, *, causal: bool, window: int,
              q_offset: int) -> Tuple[int, int]:
    """The ``[begin, end)`` keys that some query row sees, or every key when
    a row sees none (the kernels' per-block key range). Both ends of a row's
    visible range grow with its position, so only the first and last rows
    can see no key."""

    def visible(qpos: int) -> Tuple[int, int]:
        lo = max(0, qpos - window + 1) if window > 0 else 0
        hi = min(Skv - 1, qpos) if causal else Skv - 1
        return lo, hi

    lo, hi = visible(q_offset)
    lo2, hi2 = visible(q_offset + Sq - 1)
    if lo > hi or lo2 > hi2:
        return 0, Skv
    return lo, hi2 + 1


def decode_tile(D: int, dtype: torch.dtype) -> int:
    """Keys a staged tile of the decode kernel: 64, or 32 for rows wider
    than 256 bytes (float32 at D = 128)."""
    return 64 if D * dtype.itemsize <= 256 else 32


@functools.lru_cache(maxsize=256)
def plan_launch(
    BH: int, Sq: int, Skv: int, D: int, dtype: torch.dtype, *,
    causal: bool, window: int, q_offset: int,
) -> LaunchPlan:
    """The path, tiles, key splits and launches of one call; :func:`_launch`
    follows it."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the flash kernels take {sorted(map(str, _DTYPE_CODES))}; got {dtype}"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head sizes {HEAD_DIMS}; got {D}")
    if Sq <= DECODE_MAX_SQ:
        tk = decode_tile(D, dtype)
        begin, end = key_range(Sq, Skv, causal=causal, window=window,
                               q_offset=q_offset)
        key_lo = begin // tk * tk
        span = end - key_lo
        want = _cdiv(DECODE_TARGET_BLOCKS, max(BH, 1))
        split_len = _cdiv(_cdiv(span, want), tk) * tk
        splits = _cdiv(span, split_len)
        return LaunchPlan("decode", Sq, tk, splits, split_len, key_lo,
                          1 if splits == 1 else 2, BH * splits)
    if dtype in (torch.bfloat16, torch.float16):
        return LaunchPlan("tc", TC_BLOCK_Q, TC_BLOCK_KV, 1, 0, 0, 1,
                          BH * _cdiv(Sq, TC_BLOCK_Q))
    return LaunchPlan("simt", SIMT_BLOCK_Q, 32 if D == 128 else 64, 1, 0, 0, 1,
                      BH * _cdiv(Sq, SIMT_BLOCK_Q))


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point ``k5_flash_attention`` of the library built from
    ``csrc``, its argument types set."""
    fn = _build.load_library("flash_attention").k5_flash_attention
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
    ]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor whose data starts on 16 bytes (TMA and the
    16-byte copies need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    window: int, q_offset: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """Run the planned kernels of the library built from ``csrc``; the
    scores are ``(q . k) * scale`` (None: ``1 / sqrt(D)``)."""
    global launches
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the flash kernels need q, k and v of one dtype")
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    plan = plan_launch(BH, Sq, Skv, D, q.dtype, causal=causal, window=window,
                       q_offset=q_offset)
    if plan.path == "simt" and BH > _MAX_BH:
        raise ValueError(
            f"the float32 flash kernel takes at most {_MAX_BH} heads; got {BH}"
        )
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    work = o
    if plan.launches == 2:
        work = torch.empty(BH * plan.splits * Sq * (D + 2), device=q.device,
                           dtype=torch.float32)
    made = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(
            _DTYPE_CODES[q.dtype], _PATH_CODES[plan.path], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), work.data_ptr(), BH, Sq,
            Skv, D, int(causal), int(window), int(q_offset), scale,
            plan.key_lo, plan.split_len, plan.splits, stream, ctypes.byref(made),
        )
    launches += made.value
    if rc != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed (code {rc}) on the "
            f"{plan.path} path for dtype={q.dtype} q={tuple(q.shape)} "
            f"k={tuple(k.shape)}"
        )
    return o


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of ``(BH, Sq, D)`` queries over ``(BH, Skv, D)`` keys and
    values, the scores ``(q . k) * scale`` (None: ``1 / sqrt(D)``): the plain
    version for CPU (or ``meta``) tensors, the CUDA kernels for CUDA tensors
    (no fallback between the two). Under a ``CostMode`` a call counts as one
    K5 charge at K5's own cost."""
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
    if q.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"no flash kernel for device {q.device}")
    with obs_tracing.span("k5.call", "kernel"), charged(
            "k5", bh=q.shape[0], sq=q.shape[1], skv=k.shape[1], d=q.shape[2],
            dtype=q.dtype, causal=causal, window=window, q_offset=q_offset):
        if q.device.type != "cuda":
            return ref_flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, scale=scale)
        return _launch(q, k, v, causal=causal, window=window,
                       q_offset=q_offset, scale=scale)
