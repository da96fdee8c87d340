"""Plain PyTorch versions of the on-chip kernels (port of
``repro.kernels.ref``).

These are the semantic ground truth of K3 (prefix scan), K4 (diagonal SSM
recurrence), K5 (flash attention) and K6 (the chunked SSD's chunk output):
the wrappers in :mod:`repro_torch.kernels.ops` run them for CPU tensors, the CPU tests hold
them against the JAX reference, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card. No CUDA tensor on the main path reaches them.

They keep the reference's identities: the ``max`` scan's identity is
``finfo(dtype).min`` (``iinfo.min`` for integers), not ``-inf``, and masked
attention scores are ``-1e30``, not ``-inf``.

Two choices are the port's own and match what the kernels compute:

* bfloat16 / float16 ``add`` and ``mul`` scans, and the SSD recurrence on
  those types, run in float32 and round once per output (the kernels keep
  their carry in float32), where the reference's ``associative_scan`` rounds
  at each combine. The CPU tests hold both at the reference suite's bf16
  tolerance.
* Integer sums and products wrap in the input's type (``dtype=`` pins the
  result type, which ``torch.cumsum`` would otherwise widen to int64).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30

_HALF = (torch.bfloat16, torch.float16)


def scan_identity(op: str, dtype: torch.dtype):
    """The value an exclusive scan shifts in: 0 / 1, or the lowest finite
    value of ``dtype`` for ``max``."""
    if op == "add":
        return 0
    if op == "mul":
        return 1
    if op == "max":
        info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
        return info.min
    raise ValueError(f"unknown op {op!r}")


def ref_prefix_scan(
    x: torch.Tensor, op: str = "add", *, exclusive: bool = False
) -> torch.Tensor:
    """Prefix scan along the LAST axis. op in {add, max, mul}."""
    ident = scan_identity(op, x.dtype)  # validates op
    if op == "max":
        out = torch.cummax(x, dim=-1).values if x.shape[-1] else x.clone()
    else:
        fn = torch.cumsum if op == "add" else torch.cumprod
        if x.dtype in _HALF:
            out = fn(x.float(), dim=-1).to(x.dtype)
        else:
            out = fn(x, dim=-1, dtype=x.dtype)
    if exclusive and x.shape[-1]:
        pad = torch.full_like(x[..., :1], ident)
        out = torch.cat([pad, out[..., :-1]], dim=-1)
    return out


def _pair_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the pairs ``(a_t, b_t)`` along axis -2 under
    ``(al, bl) . (ar, br) = (ar*al, ar*bl + br)``: distance doubling."""
    A, B = a.clone(), b.clone()
    T = a.shape[-2]
    d = 1
    while d < T:
        a_r, b_r = A[..., d:, :], B[..., d:, :]
        a_l, b_l = A[..., :-d, :], B[..., :-d, :]
        A = torch.cat([A[..., :d, :], a_r * a_l], dim=-2)
        B = torch.cat([B[..., :d, :], a_r * b_l + b_r], dim=-2)
        d *= 2
    return A, B


def ref_ssd_scan(
    a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t along axis -2.

    a, b: (..., T, D); h0: (..., D) initial state (zeros if None).
    Returns (h, h_last): the full state trajectory and the final state.
    """
    dtype = b.dtype
    if dtype in _HALF:
        a, b = a.float(), b.float()
        h0 = None if h0 is None else h0.float()
    if h0 is None:
        h0 = torch.zeros(a.shape[:-2] + a.shape[-1:], dtype=b.dtype, device=b.device)
    A, B = _pair_scan(a, b)
    # fold in the initial state: h_t = B_t + A_t * h0
    h = (B + A * h0[..., None, :]).to(dtype)
    return h, h[..., -1, :]


def ref_chunk_state(
    a_cum_last: torch.Tensor, x_decay: torch.Tensor, B_blk: torch.Tensor
) -> torch.Tensor:
    """Oracle for the SSD chunk-state matmul: state = (decayed x)^T @ B.

    x_decay: (..., T, P) inputs pre-scaled by a_cum_last/a_cum_t;
    B_blk: (..., T, N). Returns (..., P, N).
    """
    del a_cum_last
    return torch.einsum("...tp,...tn->...pn", x_decay, B_blk)


def ref_ssd_chunk_out(
    scores: torch.Tensor, seg: torch.Tensor, x: torch.Tensor, C: torch.Tensor,
    S_exc: torch.Tensor,
) -> torch.Tensor:
    """The chunked SSD's chunk output, ``y_intra + y_inter`` of
    ``models.mamba._ssd_chunked`` (whose eager path is these two functions):
    ``scores`` (B, c, Q, Q) the chunk's ``C B^T``, ``seg`` (B, c, H, Q) the
    within-chunk cumulative log decay, ``x`` (B, c, Q, H, P) the dt-scaled
    inputs, ``C`` (B, c, Q, N), ``S_exc`` (B, c, H, P, N) each chunk's
    incoming state. Returns (B, c, Q, H, P) in the operands' promoted type
    (float32 for a bf16 model)."""
    return ref_ssd_chunk_intra(scores, seg, x) + ref_ssd_chunk_inter(C, S_exc, seg)


def ref_ssd_chunk_intra(scores: torch.Tensor, seg: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """``y_intra``: the causal, decayed scores ``W`` (B, c, Q, Q, H) times
    ``x``; operands as :func:`ref_ssd_chunk_out`'s."""
    Q = scores.shape[-1]
    seg = seg.transpose(2, 3)                                    # (B,c,Q,H)
    Lmat = torch.exp(
        torch.clamp(seg[:, :, :, None, :] - seg[:, :, None, :, :], -60.0, 0.0)
    )                                                            # (B,c,i,j,H)
    ii = torch.arange(Q, device=scores.device)
    causal = (ii[:, None] >= ii[None, :]).to(scores.dtype)
    W = scores[..., None] * Lmat * causal[None, None, :, :, None]
    return _promoted_einsum("bcijh,bcjhp->bcihp", W, x)


def ref_ssd_chunk_inter(C: torch.Tensor, S_exc: torch.Tensor,
                        seg: torch.Tensor) -> torch.Tensor:
    """``y_inter``: each row's read of its chunk's incoming state, decayed
    to the row; operands as :func:`ref_ssd_chunk_out`'s."""
    decay = torch.exp(seg.transpose(2, 3))[..., None]            # (B,c,Q,H,1)
    return _promoted_einsum("bcin,bchpn->bcihp", C, S_exc) * decay


def _promoted_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over operands promoted to their common type, as the
    models' ``einsum`` (and ``jnp.einsum``) promote them."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(spec, a.to(dt), b.to(dt))


def attention_mask(
    Sq: int, Skv: int, *, causal: bool, window: int, q_offset: int,
    kv_len: Optional[int], device,
) -> torch.Tensor:
    """(Sq, Skv) boolean visibility: ``kpos < kv_len``, ``qpos >= kpos``
    when causal, ``qpos - kpos < window`` when ``window > 0``."""
    if kv_len is None:
        kv_len = Skv
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = kpos < kv_len
    if causal:
        mask = mask & (qpos >= kpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    return mask


def ref_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool = True, window: int = 0, q_offset: int = 0,
    kv_len: Optional[int] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain softmax attention oracle for the flash kernel. (BH, S, D); the
    scores are ``(q . k) * scale`` (None: divided by ``sqrt(D)``)."""
    BH, Sq, D = q.shape
    _, Skv, _ = k.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    s = s / (D ** 0.5) if scale is None else s * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len, device=q.device)
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)
