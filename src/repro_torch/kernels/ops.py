"""Public wrappers over the on-chip kernels (port of ``repro.kernels.ops``).

The device of the input decides what runs: a CPU tensor takes the plain
PyTorch version (:mod:`repro_torch.kernels.ref`), a CUDA tensor launches the
hand-written CUDA kernel (K3 :mod:`~repro_torch.kernels.prefix_scan`, K4
:mod:`~repro_torch.kernels.ssd_scan`, K5
:mod:`~repro_torch.kernels.flash_attention`, K6
:mod:`~repro_torch.kernels.ssd_chunk`) or raises. There is no fallback
from one to the other.

Signatures and layouts are the reference's. The wrappers flatten to the
kernels' 2-D / 3-D forms and reshape back. Differences:

* ``force_pallas`` is gone (the device decides);
* ``block_rows`` / ``block_len`` / ``block_time`` / ``block_q`` /
  ``block_kv`` are accepted and ignored: the CUDA kernels choose their own
  tiles, and nothing is padded (each kernel masks its ragged edge);
* the exclusive shift of ``prefix_scan`` happens inside K3 on the card;
* ``prefix_scan`` has a gradient (the reference's comes from the jnp path
  off the TPU): for ``op="add"`` it is K3 run back to front
  (:class:`~repro_torch.kernels.prefix_scan.PrefixScan`); a ``max`` or
  ``mul`` scan of a tensor that requires grad raises
  ``NotImplementedError``;
* ``ssd_scan``, ``flash_attention`` and ``ssd_chunk_out`` have no
  backward: under autograd, with an input that requires grad, each raises
  ``NotImplementedError`` instead of returning a result without autograd
  history (K4-K6 write into a fresh tensor through ctypes, which would drop
  the gradient);
* ``ssd_chunk_out`` (K6) has no counterpart among the reference's kernels:
  the reference computes the chunked SSD's chunk output in jnp;
* ``ssd_scan`` starts K4's recurrence from ``h0`` instead of folding it in
  afterwards through a multiplicative prefix scan (one pass instead of
  three; the same function up to rounding).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import prefix_scan as _scan
from repro_torch.kernels import ssd_chunk as _chunk
from repro_torch.kernels import ssd_scan as _ssd


def _no_grad_through(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd would need a backward that ``name`` lacks."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"no gradient for {name}: its kernel has no backward; call it "
            "under torch.no_grad() or on inputs that do not require grad")


def prefix_scan(
    x: torch.Tensor,
    *,
    op: str = "add",
    exclusive: bool = False,
    block_rows: int = 256,
    block_len: int = 512,
) -> torch.Tensor:
    """Prefix scan along the last axis of an arbitrary-rank tensor.

    ``block_rows`` / ``block_len`` are accepted for the reference's
    signature and ignored. Under autograd an add scan's gradient is K3 run
    back to front.
    """
    del block_rows, block_len
    if x.ndim == 0:
        raise ValueError("prefix_scan needs at least one axis")
    flat = x.reshape(-1, x.shape[-1])
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _scan.scan_rows(flat, op=op, exclusive=exclusive).reshape(x.shape)
    if op != "add":
        raise NotImplementedError(
            f"no gradient for a {op!r} prefix scan: only the add scan has a "
            "backward (K3 run back to front)")
    return _scan.PrefixScan.apply(flat, exclusive).reshape(x.shape)


def ssd_scan(
    a: torch.Tensor,
    b: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    *,
    block_rows: int = 256,
    block_time: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diagonal recurrence h_t = a_t h_{t-1} + b_t along axis -2 of (..., T, D).

    Returns (h, h_last) with h: (..., T, D), h_last: (..., D). ``h0`` of shape
    (..., D) broadcasts against the trajectory as the reference's
    ``h0[..., None, :]`` does, batch axes included; a shape that does not
    broadcast, or a 0-d ``h0``, raises ``ValueError``.
    ``block_rows`` / ``block_time`` are accepted for the reference's
    signature and ignored.
    """
    del block_rows, block_time
    _no_grad_through("ssd_scan", a, b, h0)
    if a.ndim < 2 or a.shape != b.shape:
        raise ValueError(
            f"expected matching (..., T, D) shapes, got {tuple(a.shape)} "
            f"{tuple(b.shape)}"
        )
    shape = b.shape
    if h0 is not None:
        if h0.ndim == 0:
            raise ValueError("h0 needs a feature axis: (..., D)")
        try:
            shape = torch.broadcast_shapes(
                shape, h0.shape[:-1] + (1,) + h0.shape[-1:])
        except RuntimeError as err:
            raise ValueError(
                f"h0 {tuple(h0.shape)} does not broadcast against the "
                f"trajectory {tuple(b.shape)}") from err
        a, b = a.expand(shape), b.expand(shape)
        h0 = h0.expand(shape[:-2] + shape[-1:])
    N, T, D = math.prod(shape[:-2]), shape[-2], shape[-1]
    h0_2 = None if h0 is None else h0.reshape(N, D)
    h = _ssd.ssd_rows(a.reshape(N, T, D), b.reshape(N, T, D), h0_2)
    h = h.reshape(shape)
    return h, h[..., -1, :]


def flash_attention(
    q: torch.Tensor,      # (BH, Sq, D)
    k: torch.Tensor,      # (BH, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    block_q: int = 128,
    block_kv: int = 128,
) -> torch.Tensor:
    """Flash attention over flattened (batch*heads, seq, head_dim) operands.

    ``block_q`` / ``block_kv`` are accepted for the reference's signature
    and ignored.
    """
    del block_q, block_kv
    _no_grad_through("flash_attention", q, k, v)
    return _flash.attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset)


def ssd_chunk_out(
    scores: torch.Tensor,   # (B, c, Q, Q) the chunk's C B^T, model type
    seg: torch.Tensor,      # (B, c, H, Q) float32 cumulative log decay
    x: torch.Tensor,        # (B, c, Q, H, P) dt-scaled inputs, model type
    C: torch.Tensor,        # (B, c, Q, N) model type, rows evenly strided
    S_exc: torch.Tensor,    # (B, c, H, P, N) float32 incoming states
) -> torch.Tensor:
    """The chunked SSD's chunk output ``y_intra + y_inter``, (B, c, Q, H, P)
    in float32: K6 on the card, its plain version on the CPU
    (:mod:`repro_torch.kernels.ssd_chunk` gives the operands' contract)."""
    _no_grad_through("ssd_chunk_out", scores, seg, x, C, S_exc)
    return _chunk.chunk_out(scores, seg, x, C, S_exc)
