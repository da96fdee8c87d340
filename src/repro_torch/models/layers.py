"""Transformer substrate: norms, RoPE/M-RoPE, GQA attention (blocked flash,
sliding window, KV-cache decode), gated MLP (port of ``repro.models.layers``).

Parameters live in ``nn.Module``s (:class:`Norm`, :class:`Attention`,
:class:`MLP`) whose attribute names are the reference's param-dict keys, so a
reference pytree maps onto a module's ``state_dict`` leaf for leaf
(:func:`repro_torch.interop.model_params_from_numpy`). The functions keep the
reference's names and take a module where the reference takes a dict.

Differences from the reference:

* under a mesh (:mod:`repro_torch.sharding`) the regions the reference runs
  in ``shard_map`` (explicit TP, sequence-sharded decode attention) run in
  :func:`repro_torch.compat.block_shard_map`; its placement constraints
  (``shard``) are the identity, so the mesh branches that are constraints
  only compute the local path;
* ``flash_attention`` runs a call that records no gradient, with bf16 or
  fp16 operands of a head size K5 is built for and more than
  ``DECODE_MAX_SQ`` query rows on the card, on K5's tensor-core path
  (:func:`k5_takes`; the reference computes its attention in jnp, outside
  any Pallas kernel); every other call (training, float32, the CPU, other
  head sizes) takes the reference's own blocked attention in plain
  PyTorch, with its blocks, its ``-1e30`` mask fill and its ``1e-30``
  clamp. The reference's ``seq_shard`` only places query blocks and is left
  out;
* the reference's ``jax.checkpoint`` sites go through :func:`remat`
  (``torch.utils.checkpoint``, non-reentrant), which checkpoints only while
  grad is enabled: serving under ``torch.inference_mode()`` runs each body
  once, as before;
* ``torch.einsum`` takes one dtype, so :func:`einsum` promotes its operands
  as ``jnp.einsum`` does; ``preferred_element_type=float32`` becomes an
  einsum of float32 operands (a product of two bf16 values is exact in
  float32, and the sum accumulates in float32 in both);
* ``cache_len`` and ``window`` are Python ints (the layers run eagerly), and
  a cache update returns a new tensor: a cache handed in is never written.
"""

from __future__ import annotations

import functools
import importlib
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import compat, perf_flags
from repro_torch.compat import P
from repro_torch.obs import tracing as obs_tracing
from repro_torch.sharding import current_topology, use_topology

# the module (``repro_torch.kernels`` exports the function under its name)
K5 = importlib.import_module("repro_torch.kernels.flash_attention")

Device = Union[torch.device, str]

NEG_INF = -1e30


def torch_dtype(name: str) -> torch.dtype:
    """A config's ``dtype`` string as a torch dtype (bf16 or float32, as the
    reference's ``init_lm`` reads it)."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def param(gen: torch.Generator, shape, scale: float, dtype: torch.dtype,
          device: Device) -> nn.Parameter:
    """A weight drawn from ``gen`` (standard normal times ``scale``) on the
    generator's device, then moved to ``device``: one generator seed gives
    the same weights on the CPU and on the card. On the ``meta`` device
    nothing is drawn."""
    if torch.device(device).type == "meta":
        return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"),
                            requires_grad=False)
    w = torch.randn(shape, generator=gen, device=gen.device) * scale
    return nn.Parameter(w.to(dtype).to(device), requires_grad=False)


def const(value: torch.Tensor, dtype: torch.dtype,
          device: Device) -> nn.Parameter:
    """A weight with a fixed initial value (zeros, ones, a table)."""
    return nn.Parameter(value.to(dtype).to(device), requires_grad=False)


def einsum(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over operands promoted to their common dtype, as
    ``jnp.einsum`` promotes them."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in operands))
    return torch.einsum(spec, *(o.to(dt) for o in operands))


def remat(fn, *args):
    """``jax.checkpoint(fn)(*args)``: while grad is enabled, ``fn``'s
    activations are dropped after the forward and recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant); without grad, ``fn(*args)``.
    The recomputation runs under the topology and the bound mesh axes of the
    forward, whichever thread autograd runs it on."""
    if not torch.is_grad_enabled():
        return fn(*args)
    topo = current_topology()
    meshes = compat.bound_meshes()

    def again(*a):
        with use_topology(topo), compat.bind_meshes(meshes):
            return fn(*a)

    from torch.utils.checkpoint import checkpoint

    return checkpoint(again, *args, use_reentrant=False)


def einsum_f32(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=jnp.float32)``."""
    return torch.einsum(spec, *(o.float() for o in operands))


def tp_out_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Projection einsum whose output crosses a TP psum under a mesh.

    With ``tp_reduce_bf16`` the product is emitted in bf16, as in the
    reference (which does so without a mesh too)."""
    if perf_flags.FLAGS.tp_reduce_bf16:
        return torch.einsum(spec, a.bfloat16(), b.bfloat16())
    return einsum(spec, a, b)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(dt)


def layernorm(p: "Norm", x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(dt)


def norm(p: "Norm", x: torch.Tensor, kind: str = "rmsnorm",
         eps: Optional[float] = None) -> torch.Tensor:
    """RMSNorm or LayerNorm, at each one's default eps unless ``eps``
    names another."""
    if kind == "rmsnorm":
        return rmsnorm(p.scale, x) if eps is None else rmsnorm(p.scale, x, eps)
    return layernorm(p, x) if eps is None else layernorm(p, x, eps)


def attention_scale(cfg, head_dim: int) -> float:
    """The score scale: the configuration's ``attention_multiplier`` where
    it sets one, else ``1 / sqrt(head_dim)``."""
    mult = getattr(cfg, "attention_multiplier", None)
    return 1.0 / math.sqrt(head_dim) if mult is None else float(mult)


class Norm(nn.Module):
    """``init_norm``: rmsnorm keeps a zero-initialised ``scale`` (applied as
    ``1 + scale``), layernorm a ``scale`` of ones and a ``bias``."""

    def __init__(self, d: int, kind: str, dtype: torch.dtype, device: Device):
        super().__init__()
        self.kind = kind
        if kind == "rmsnorm":
            self.scale = const(torch.zeros(d), dtype, device)
            self.bias = None
        else:
            self.scale = const(torch.ones(d), dtype, device)
            self.bias = const(torch.zeros(d), dtype, device)


def init_norm(d: int, kind: str, dtype: torch.dtype, device: Device) -> Norm:
    return Norm(d, kind, dtype, device)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def _rope_freqs(head_dim: int, theta: float, device: Device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4
) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)       # (d/2,)
    angles = positions[..., None].float() * freqs             # (B, S, d/2)
    return _rotate(x, angles)


def mrope_sections(head_dim: int) -> tuple:
    """Qwen2-VL splits head_dim/2 freq slots 1:1.5:1.5 over (t, h, w) —
    (16, 24, 24) at head_dim=128; scaled proportionally otherwise."""
    half = head_dim // 2
    t = max(1, half // 4)
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(
    x: torch.Tensor,
    positions3: torch.Tensor,
    theta: float = 1e4,
    sections: tuple = None,
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: positions3 (B, S, 3) = (t, h, w) streams.

    head_dim/2 frequency slots are split across the three position streams
    (sections sum to head_dim/2); text tokens carry t==h==w so M-RoPE reduces
    to 1-D RoPE for them.
    """
    d = x.shape[-1]
    if sections is None:
        sections = mrope_sections(d)
    assert sum(sections) == d // 2, (sections, d)
    freqs = _rope_freqs(d, theta, x.device)
    parts = []
    start = 0
    for i, sec in enumerate(sections):
        f = freqs[start:start + sec]
        parts.append(positions3[..., i][..., None].float() * f)
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """``init_attention``: wq (d, h, hd), wk / wv (d, kh, hd), wo (h, hd, d),
    and zero biases bq / bk / bv with ``qkv_bias``."""

    def __init__(self, gen: torch.Generator, cfg, dtype: torch.dtype,
                 device: Device):
        super().__init__()
        d = cfg.d_model
        hd = cfg.resolved_head_dim
        h, kh = cfg.num_heads, cfg.num_kv_heads
        s = 1.0 / math.sqrt(d)
        self.wq = param(gen, (d, h, hd), s, dtype, device)
        self.wk = param(gen, (d, kh, hd), s, dtype, device)
        self.wv = param(gen, (d, kh, hd), s, dtype, device)
        self.wo = param(gen, (h, hd, d), s, dtype, device)
        if cfg.qkv_bias:
            self.bq = const(torch.zeros(h, hd), dtype, device)
            self.bk = const(torch.zeros(kh, hd), dtype, device)
            self.bv = const(torch.zeros(kh, hd), dtype, device)
        else:
            self.bq = self.bk = self.bv = None


def init_attention(gen: torch.Generator, cfg, dtype: torch.dtype,
                   device: Device) -> Attention:
    return Attention(gen, cfg, dtype, device)


def _qkv(p: Attention, x: torch.Tensor, xkv: Optional[torch.Tensor] = None):
    xkv = x if xkv is None else xkv
    q = tp_out_einsum("bsd,dhk->bshk", x, p.wq)
    k = tp_out_einsum("bsd,dhk->bshk", xkv, p.wk)
    v = tp_out_einsum("bsd,dhk->bshk", xkv, p.wv)
    if p.bq is not None:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    return q, k, v


def _window_mask(delta: torch.Tensor, window: int) -> torch.Tensor:
    """Keys older than ``window`` positions are masked (``window`` > 0)."""
    if window > 0:
        return delta < window
    return torch.ones_like(delta, dtype=torch.bool)


def k5_takes(device_type: str, dtype: Optional[torch.dtype], head_dim: int,
             sq: int, records_grad: bool) -> bool:
    """Whether :func:`flash_attention` runs a call on K5's tensor-core path:
    operands on the card, all bf16 or all fp16 (``dtype`` None where they
    differ), a head size K5 is built for, more query rows than its decode
    path takes, and no autograd graph recorded (K5 has no backward)."""
    return (device_type == "cuda"
            and dtype in (torch.bfloat16, torch.float16)
            and head_dim in K5.HEAD_DIMS
            and sq > K5.DECODE_MAX_SQ
            and not records_grad)


def _k5_attention(q, k, v, *, causal: bool, window: int, q_offset: int,
                  scale: float) -> torch.Tensor:
    """``flash_attention`` on K5: ``(B, S, H, D)`` to K5's ``(B H, S, D)``,
    each KV head copied to its ``G`` query heads (query head ``kh G + g``
    reads KV head ``kh``, as the blocked path's ``(Kh, G)`` split does),
    and the result back to ``(B, Sq, H, D)``, contiguous."""
    B, Sq, H, D = q.shape
    _, Sk, Kh, _ = k.shape
    G = H // Kh

    def heads(t):  # (B, Sk, Kh, D) -> (B H, Sk, D), one copy
        return (t.transpose(1, 2)[:, :, None].expand(B, Kh, G, Sk, D)
                .reshape(B * H, Sk, D))

    o = K5.attention(q.transpose(1, 2).reshape(B * H, Sq, D), heads(k),
                     heads(v), causal=causal, window=window,
                     q_offset=q_offset, scale=scale)
    return o.reshape(B, H, Sq, D).transpose(1, 2).contiguous()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    q_block: int = 1024,
    kv_block: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of every query row, on K5 or as a memory-safe blocked
    attention (an online softmax over KV blocks).

    q: (B, Sq, H, D); k/v: (B, Sk, Kh, D) with H = G*Kh (GQA). ``window`` > 0
    masks keys older than ``window`` positions (sliding-window attention).
    ``q_offset`` is the absolute position of q[0]. The reference's
    ``seq_shard`` (query blocks sharded over a mesh axis) is a mesh path,
    not ported. ``scale`` multiplies the scores (None: ``1 / sqrt(D)``).

    A call that :func:`k5_takes` runs on K5's tensor-core path: the scores
    accumulate in float32, the softmax is in float32, the probabilities
    enter the PV product in q's type, and key tiles that no query row of a
    tile sees are skipped. Every other call takes the blocked path, which
    ``q_block``, ``kv_block`` and ``perf_flags``' ``attn_probs_bf16`` shape;
    they do nothing on K5.
    """
    window = int(window)
    B, Sq, H, D = q.shape
    _, Sk, Kh, _ = k.shape
    G = H // Kh
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    dtype = q.dtype if k.dtype == v.dtype == q.dtype else None
    records_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if k5_takes(q.device.type, dtype, D, Sq, records_grad):
        return _k5_attention(q, k, v, causal=bool(causal), window=window,
                             q_offset=int(q_offset), scale=scale)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    nq = -(-Sq // q_block)
    nk = -(-Sk // kv_block)
    # pad to block multiples
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * q_block - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * kv_block - Sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * kv_block - Sk))
    qp = (qp * scale).reshape(B, nq, q_block, Kh, G, D)
    kp = kp.reshape(B, nk, kv_block, Kh, D)
    vp = vp.reshape(B, nk, kv_block, Kh, D)
    dev = q.device
    q_pos = q_offset + torch.arange(nq * q_block, device=dev).reshape(nq, q_block)
    k_pos = torch.arange(nk * kv_block, device=dev).reshape(nk, kv_block)
    k_valid = (torch.arange(nk * kv_block, device=dev) < Sk).reshape(nk, kv_block)
    probs_bf16 = perf_flags.FLAGS.attn_probs_bf16

    def block(qb, qpos, kb, vb, kpos, kval):
        # qb: (B, q_block, Kh, G, D); kb/vb: (B, kv_block, Kh, D)
        s = einsum("bqhgd,bkhd->bhgqk", qb, kb).float()
        mask = kval[None, None, None, None, :]
        if causal is not None and causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])[None, None, None]
        mask = mask & _window_mask(qpos[:, None] - kpos[None, :], window)[None, None, None]
        s = torch.where(mask, s, NEG_INF)
        m = torch.amax(s, dim=-1)                         # (B,h,g,q)
        probs = torch.exp(s - m[..., None])
        l = torch.sum(probs, dim=-1)
        if probs_bf16:
            o = einsum_f32("bhgqk,bkhd->bhgqd", probs.bfloat16(), vb.bfloat16())
        else:
            o = einsum("bhgqk,bkhd->bhgqd", probs, vb.float())
        return m, l, o

    outs = []
    for qi in range(nq):
        qb, qpos = qp[:, qi], q_pos[qi]
        m = torch.full((B, Kh, G, q_block), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Kh, G, q_block), dtype=torch.float32, device=dev)
        o = torch.zeros((B, Kh, G, q_block, D), dtype=torch.float32, device=dev)
        for ki in range(nk):
            mb, lb, ob = remat(block, qb, qpos, kp[:, ki], vp[:, ki],
                               k_pos[ki], k_valid[ki])
            mn = torch.maximum(m, mb)
            c1 = torch.exp(m - mn)
            c2 = torch.exp(mb - mn)
            m, l, o = mn, l * c1 + lb * c2, o * c1[..., None] + ob * c2[..., None]
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])   # (B,h,g,q,D)
    # outs: (nq, B, Kh, G, q_block, D) -> (B, Sq, H, D)
    out = torch.stack(outs, 0)
    out = torch.movedim(out, 0, 3).reshape(B, Kh, G, nq * q_block, D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, nq * q_block, H, D)
    return out[:, :Sq].to(q.dtype)


def attention_block(
    p: Attention,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg,
    *,
    causal: bool = True,
    window: int = 0,
    xkv: Optional[torch.Tensor] = None,
    positions3: Optional[torch.Tensor] = None,
    return_kv: bool = False,
):
    """Full-sequence attention (train / prefill), one ``attn.block`` span.
    Under a mesh with the ``explicit_tp`` flag the projections run
    head-sharded with an owned psum; otherwise the reference's mesh branches
    only place data.

    With return_kv=True also returns the (roped-k, v) pair for decode caches.
    """
    with obs_tracing.span("attn.block", "attn"):
        topo = current_topology()
        explicit = (not perf_flags.FLAGS.attn_seq_over_tp
                    and _tp_ready(topo, cfg.num_heads))
        if explicit:
            q, k, v = explicit_tp_qkv(p, x, xkv, topo)
        else:
            q, k, v = _qkv(p, x, xkv)
        if xkv is None:  # self-attention: rotate both q and k
            if positions3 is not None and cfg.mrope:
                q = apply_mrope(q, positions3, cfg.rope_theta)
                k = apply_mrope(k, positions3, cfg.rope_theta)
            elif cfg.rope_theta > 0:
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)
        out = flash_attention(
            q, k, v, causal=causal, window=window,
            kv_block=perf_flags.FLAGS.attn_kv_block,
            scale=attention_scale(cfg, q.shape[-1]),
        )
        if explicit:
            out = explicit_tp_wo(out, p.wo, topo)
        else:
            out = tp_out_einsum("bshk,hkd->bsd", out, p.wo)
        if return_kv:
            return out, (k, v)
        return out


def _write_row(cache: torch.Tensor, row: torch.Tensor, at: int) -> torch.Tensor:
    """``lax.dynamic_update_slice(cache, row, (0, at, 0, 0))`` as a new
    tensor: the start clamps into range as XLA clamps it."""
    at = min(max(int(at), 0), cache.shape[1] - row.shape[1])
    return cache.slice_scatter(row.to(cache.dtype), dim=1, start=at,
                               end=at + row.shape[1])


def decode_attention(
    p: Attention,
    x: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: int,
    cfg,
    *,
    window: int = 0,
    update_cache: bool = True,
    positions3: Optional[torch.Tensor] = None,
):
    """One-token decode vs a (B, S_max, Kh, D) KV cache.

    Returns (out, new_k_cache, new_v_cache). The new token is written at
    ``cache_len``. For cross-attention pass update_cache=False.
    """
    cache_len = int(cache_len)
    window = int(window)
    B, S_max, Kh, D = k_cache.shape
    q, k, v = _qkv(p, x)
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    if positions3 is not None and cfg.mrope:
        q = apply_mrope(q, positions3, cfg.rope_theta)
        k = apply_mrope(k, positions3, cfg.rope_theta)
    elif cfg.rope_theta > 0:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if update_cache:
        k_cache = _write_row(k_cache, k, cache_len)
        v_cache = _write_row(v_cache, v, cache_len)
    H = cfg.num_heads
    G = H // Kh
    qh = (q * attention_scale(cfg, D)).reshape(B, Kh, G, D)
    s = einsum_f32("bhgd,bshd->bhgs", qh, k_cache)
    kpos = torch.arange(S_max, device=x.device)
    valid = kpos <= cache_len
    valid = valid & _window_mask(cache_len - kpos, window)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    attn_w = torch.softmax(s, dim=-1)
    o = einsum_f32("bhgs,bshd->bhgd", attn_w.to(v_cache.dtype), v_cache)
    o = o.reshape(B, 1, H, D).to(x.dtype)
    out = einsum("bshk,hkd->bsd", o, p.wo)
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

_ACT = {
    "silu": F.silu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
}


class MLP(nn.Module):
    """``init_mlp``: w_in (d, ff), w_out (ff, d), and w_gate (d, ff) when
    gated."""

    def __init__(self, gen: torch.Generator, d: int, ff: int,
                 dtype: torch.dtype, device: Device, gated: bool = True):
        super().__init__()
        s_in = 1.0 / math.sqrt(d)
        s_out = 1.0 / math.sqrt(ff)
        self.w_in = param(gen, (d, ff), s_in, dtype, device)
        self.w_out = param(gen, (ff, d), s_out, dtype, device)
        self.w_gate = param(gen, (d, ff), s_in, dtype, device) if gated else None


def init_mlp(gen: torch.Generator, d: int, ff: int, dtype: torch.dtype,
             device: Device, gated: bool = True) -> MLP:
    return MLP(gen, d, ff, dtype, device, gated)


def mlp_block(p: MLP, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    topo = current_topology()
    if _tp_ready(topo, p.w_in.shape[-1]):
        return explicit_tp_mlp(p, x, act, topo)
    a = _ACT[act]
    h = tp_out_einsum("bsd,df->bsf", x, p.w_in)
    if p.w_gate is not None:
        g = tp_out_einsum("bsd,df->bsf", x, p.w_gate)
        h = a(g) * h
    else:
        h = a(h)
    return tp_out_einsum("bsf,fd->bsd", h, p.w_out)


def decode_kv_mode(cfg) -> str:
    """Cache layout for decode: 'heads' when kv heads divide the model axis,
    'seq' (sequence-sharded cache + LSE psum merge) otherwise, 'local'
    off-mesh."""
    topo = current_topology()
    if topo.mesh is None or topo.model_size <= 1:
        return "local"
    return "heads" if cfg.num_kv_heads % topo.model_size == 0 else "seq"


def seq_sharded_decode_attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: int,
    cfg,
    *,
    axis_name: str,
    window: int = 0,
):
    """Decode attention with the KV cache sharded along SEQUENCE over
    ``axis_name``, inside a :func:`~repro_torch.compat.block_shard_map`
    region: every leaf carries ``R`` rank rows. q: (R, B, 1, H, D), k / v:
    (R, B, 1, Kh, D), the caches (R, B, S_shard, Kh, D).

    The owner shard writes the new token; each shard scores its cache
    shard, and the partial (m, l, o) triplets merge with the associative
    flash combine through pmax / psum, the same operator algebra as the
    scan collective. Returns the merged per-head outputs (R, B, 1, H, D)
    and the caches; the wo projection happens outside."""
    R, B, S_shard, Kh, D = k_cache.shape
    dev = k_cache.device
    idx = compat.axis_index_rows(axis_name, 2).to(torch.int64)   # (R, 1)
    # the owner shard writes the new kv at its offset, as the reference's
    # dynamic_update_slice under where(owner, ...)
    local_start = idx * S_shard
    kpos = local_start + torch.arange(S_shard, device=dev)      # (R, S)
    write = (kpos == cache_len)[:, None, :, None, None]
    k_cache = torch.where(write, k.to(k_cache.dtype), k_cache)
    v_cache = torch.where(write, v.to(v_cache.dtype), v_cache)

    H = cfg.num_heads
    G = H // Kh
    qh = (q * attention_scale(cfg, D)).reshape(R, B, Kh, G, D)
    s = einsum_f32("rbhgd,rbshd->rbhgs", qh, k_cache)
    valid = (kpos <= cache_len) & _window_mask(cache_len - kpos, int(window))
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1)
    probs = torch.exp(s - m[..., None])
    l = torch.sum(probs, dim=-1)
    o = einsum_f32("rbhgs,rbshd->rbhgd", probs.to(v_cache.dtype), v_cache)
    # associative flash merge across shards
    mg = compat.pmax(m, axis_name)
    c = torch.exp(m - mg)
    lg = compat.psum(l * c, axis_name)
    og = compat.psum(o * c[..., None], axis_name)
    o = (og / torch.clamp(lg, min=1e-30)[..., None]).reshape(R, B, 1, H, D)
    return o.to(q.dtype), k_cache, v_cache


def cached_attention(p, x, kc, vc, cache_len, cfg, *, window=0, kv_mode="local"):
    """One-token attention against a KV cache, dispatching on cache layout:
    'seq' runs the sequence-sharded region; 'heads' and 'local' run
    :func:`decode_attention` (a 'heads' cache only places heads)."""
    if kv_mode != "seq":
        return decode_attention(p, x, kc, vc, cache_len, cfg, window=window)
    topo = current_topology()
    axis = topo.model_axis
    dp = topo.batch_axes
    B = x.shape[0]
    cache_len = int(cache_len)
    dpspec = dp[0] if len(dp) == 1 else dp
    bspec = dpspec if (B % topo.dp_size == 0 and B > 1) else None
    q, k, v = _qkv(p, x)
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

    def region(q, k, v, kc, vc):
        return seq_sharded_decode_attention_core(
            q, k, v, kc, vc, cache_len, cfg, axis_name=axis, window=window)

    cspec = P(bspec, axis, None, None)
    rspec = P(bspec, None, None, None)
    o, kc, vc = compat.block_shard_map(
        region, topo.mesh,
        in_specs=(rspec, rspec, rspec, cspec, cspec),
        out_specs=(rspec, cspec, cspec),
    )(q, k, v, kc, vc)
    out = einsum("bshk,hkd->bsd", o, p.wo)
    return out, kc, vc


# ---------------------------------------------------------------------------
# Explicit-TP projections (perf flag: explicit_tp)
#
# The reference runs these projections inside shard_map so that each TP
# psum is one the model owns, cast to the activation dtype before it
# reduces. Here they run in block_shard_map regions over (R, ...) rows, the
# weights block-sharded along the model axis.
# ---------------------------------------------------------------------------


def _tp_ready(topo, *dims) -> bool:
    return (
        perf_flags.FLAGS.explicit_tp
        and topo.mesh is not None
        and topo.model_size > 1
        and all(d % topo.model_size == 0 for d in dims)
    )


def _batch_spec_entry(topo, batch_dim: int):
    """DP sharding entry for a batch dim, or None when it can't shard."""
    if batch_dim % max(topo.dp_size, 1) != 0 or batch_dim <= 1:
        return None
    dp = topo.batch_axes
    return dp[0] if len(dp) == 1 else dp


def explicit_tp_mlp(p: MLP, x: torch.Tensor, act: str, topo) -> torch.Tensor:
    """Gated MLP with explicit ff-sharded compute + an owned psum in the
    activation dtype."""
    axis = topo.model_axis
    dpspec = _batch_spec_entry(topo, x.shape[0])
    a = _ACT[act]

    def region(x_l, w_in, w_gate, w_out):
        h = einsum("rbsd,rdf->rbsf", x_l, w_in)
        if w_gate is not None:
            h = a(einsum("rbsd,rdf->rbsf", x_l, w_gate)) * h
        else:
            h = a(h)
        out = einsum("rbsf,rfd->rbsd", h, w_out)
        return compat.psum(out.to(x_l.dtype), axis)

    xspec = P(dpspec, None, None)
    wspec = P(None, axis)
    return compat.block_shard_map(
        region, topo.mesh,
        in_specs=(xspec, wspec, wspec, P(axis, None)), out_specs=xspec,
    )(x, p.w_in, p.w_gate, p.w_out)


def explicit_tp_qkv(p: Attention, x: torch.Tensor,
                    xkv: Optional[torch.Tensor], topo):
    """Head-sharded q/k/v projections in a region (k / v replicated when
    the kv heads do not divide the model axis)."""
    axis = topo.model_axis
    msize = topo.model_size
    dpspec = _batch_spec_entry(topo, x.shape[0])
    kv_sharded = p.wk.shape[1] % msize == 0

    def region(x_l, xkv_l, wq, wk, wv, bq, bk, bv):
        q = einsum("rbsd,rdhk->rbshk", x_l, wq)
        k = einsum("rbsd,rdhk->rbshk", xkv_l, wk)
        v = einsum("rbsd,rdhk->rbshk", xkv_l, wv)
        if bq is not None:
            q = q + bq[:, None, None]
            k = k + bk[:, None, None]
            v = v + bv[:, None, None]
        return q, k, v

    xspec = P(dpspec, None, None)
    hspec = P(None, axis, None)
    kvspec = hspec if kv_sharded else P(None, None, None)
    hbspec = P(axis, None)
    kvbspec = hbspec if kv_sharded else P(None, None)
    out_h = P(dpspec, None, axis, None)
    out_kv = out_h if kv_sharded else P(dpspec, None, None, None)
    return compat.block_shard_map(
        region, topo.mesh,
        in_specs=(xspec, xspec, hspec, kvspec, kvspec, hbspec, kvbspec,
                  kvbspec),
        out_specs=(out_h, out_kv, out_kv),
    )(x, x if xkv is None else xkv, p.wq, p.wk, p.wv, p.bq, p.bk, p.bv)


def explicit_tp_wo(out_heads: torch.Tensor, wo: torch.Tensor,
                   topo) -> torch.Tensor:
    """Out-projection contraction over sharded heads with an owned psum in
    the activation dtype."""
    axis = topo.model_axis
    dpspec = _batch_spec_entry(topo, out_heads.shape[0])

    def region(o_l, w_l):
        r = einsum("rbshk,rhkd->rbsd", o_l, w_l)
        return compat.psum(r.to(o_l.dtype), axis)

    return compat.block_shard_map(
        region, topo.mesh,
        in_specs=(P(dpspec, None, axis, None), P(axis, None, None)),
        out_specs=P(dpspec, None, None),
    )(out_heads, wo)
