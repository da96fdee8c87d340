"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).

The audio frontend (log-mel + conv downsampling) is a stub, as in the
reference: callers pass precomputed frame embeddings (B, frames, d_model).
The encoder is bidirectional; the decoder has causal self-attention plus
cross-attention into the encoder output. Self-attention uses RoPE and
cross-attention no rotation, as the reference does.

``enc_blocks`` / ``dec_blocks`` hold one module per layer where the
reference stacks them for ``lax.scan``; the port loops over them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.layers import einsum, einsum_f32, param
from repro_torch.models.transformer import _greedy

Params = Dict[str, Any]


class EncBlock(nn.Module):
    def __init__(self, gen, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.norm1 = L.Norm(d, cfg.norm, dtype, device)
        self.attn = L.Attention(gen, cfg, dtype, device)
        self.norm2 = L.Norm(d, cfg.norm, dtype, device)
        self.mlp = L.MLP(gen, d, cfg.d_ff, dtype, device, cfg.gated_mlp)


class DecBlock(nn.Module):
    def __init__(self, gen, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.norm1 = L.Norm(d, cfg.norm, dtype, device)
        self.attn = L.Attention(gen, cfg, dtype, device)
        self.norm_c = L.Norm(d, cfg.norm, dtype, device)
        self.cross = L.Attention(gen, cfg, dtype, device)
        self.norm2 = L.Norm(d, cfg.norm, dtype, device)
        self.mlp = L.MLP(gen, d, cfg.d_ff, dtype, device, cfg.gated_mlp)


class EncDec(nn.Module):
    """``init_encdec``: embed, enc_blocks, dec_blocks, enc_norm, final_norm
    and an untied lm_head."""

    def __init__(self, gen: torch.Generator, cfg, device):
        super().__init__()
        self.cfg = cfg
        dtype = L.torch_dtype(cfg.dtype)
        Vp, d = cfg.padded_vocab, cfg.d_model
        self.embed = param(gen, (Vp, d), 0.02, dtype, device)
        self.enc_blocks = nn.ModuleList(
            EncBlock(gen, cfg, dtype, device) for _ in range(cfg.encoder_layers))
        self.dec_blocks = nn.ModuleList(
            DecBlock(gen, cfg, dtype, device) for _ in range(cfg.num_layers))
        self.enc_norm = L.Norm(d, cfg.norm, dtype, device)
        self.final_norm = L.Norm(d, cfg.norm, dtype, device)
        self.lm_head = param(gen, (d, Vp), 1.0 / math.sqrt(d), dtype, device)


def init_encdec(gen: torch.Generator, cfg, device="cuda") -> EncDec:
    return EncDec(gen, cfg, device)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def encoder_forward(model: EncDec, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames: (B, F, d) stub embeddings -> encoder states (B, F, d)."""
    B, F, _ = frames.shape
    x = frames
    positions = _positions(B, F, x.device)
    def layer(x, p):
        h = L.norm(p.norm1, x, cfg.norm)
        x = x + L.attention_block(p.attn, h, positions, cfg, causal=False)
        h = L.norm(p.norm2, x, cfg.norm)
        return x + L.mlp_block(p.mlp, h, cfg.act)

    for p in model.enc_blocks:
        x = L.remat(layer, x, p)
    return L.norm(model.enc_norm, x, cfg.norm)


def encdec_forward(
    model: EncDec, tokens: torch.Tensor, frames: torch.Tensor, cfg,
    *, collect_cache: bool = False,
):
    """tokens (B, S), frames (B, F, d) -> logits (B, S, Vp)."""
    enc = encoder_forward(model, frames, cfg)
    B, S = tokens.shape
    x = model.embed[tokens]
    positions = _positions(B, S, x.device)
    ks, vs = [], []

    def layer(x, p, enc):
        h = L.norm(p.norm1, x, cfg.norm)
        a = L.attention_block(
            p.attn, h, positions, cfg, causal=True, return_kv=collect_cache
        )
        kv = None
        if collect_cache:
            a, kv = a
        x = x + a
        h = L.norm(p.norm_c, x, cfg.norm)
        x = x + L.attention_block(p.cross, h, positions, cfg, causal=False, xkv=enc)
        h = L.norm(p.norm2, x, cfg.norm)
        return x + L.mlp_block(p.mlp, h, cfg.act), kv

    for p in model.dec_blocks:
        x, kv = L.remat(layer, x, p, enc)
        if collect_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    x = L.norm(model.final_norm, x, cfg.norm)
    logits = einsum("bsd,dv->bsv", x, model.lm_head)
    if collect_cache:
        xk, xv = make_cross_caches(model, enc, cfg)
        caches = {"k": torch.stack(ks, 0), "v": torch.stack(vs, 0),
                  "xk": xk, "xv": xv}
        return logits, caches
    return logits


def encdec_loss(model: EncDec, batch, cfg):
    """Cross-entropy over the labels (differentiable; every layer of both
    stacks rematerialised, as in the reference)."""
    logits = encdec_forward(model, batch["tokens"], batch["frames"], cfg)
    labels = batch["labels"]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    xent = torch.sum((lse - ll) * mask) / torch.clamp(mask.sum(), min=1.0)
    return xent, {"xent": xent}


def make_cross_caches(model: EncDec, enc: torch.Tensor, cfg):
    """Precompute per-decoder-layer cross K/V from encoder states (prefill):
    (L, B, F, Kh, D) each."""
    xks, xvs = [], []
    for p in model.dec_blocks:
        k = einsum("bsd,dhk->bshk", enc, p.cross.wk)
        v = einsum("bsd,dhk->bshk", enc, p.cross.wv)
        if p.cross.bk is not None:
            k = k + p.cross.bk
            v = v + p.cross.bv
        xks.append(k)
        xvs.append(v)
    return torch.stack(xks, 0), torch.stack(xvs, 0)


def _cross_attn_decode(p: L.Attention, x, xk, xv):
    """Single-token cross attention over fixed encoder K/V (no rope)."""
    B, F, Kh, D = xk.shape
    q = einsum("bsd,dhk->bshk", x, p.wq)
    if p.bq is not None:
        q = q + p.bq
    H = q.shape[2]
    G = H // Kh
    qh = (q * (1.0 / math.sqrt(D))).reshape(B, Kh, G, D)
    s = einsum_f32("bhgd,bshd->bhgs", qh, xk)
    w = torch.softmax(s, dim=-1)
    o = einsum_f32("bhgs,bshd->bhgd", w.to(xv.dtype), xv)
    o = o.reshape(B, 1, H, D).to(x.dtype)
    return einsum("bshk,hkd->bsd", o, p.wo)


def encdec_decode_step(
    model: EncDec,
    token: torch.Tensor,
    cache: Params,
    cache_len: int,
    cfg,
) -> Tuple[torch.Tensor, Params]:
    """One greedy decoder step. cache: {k, v, xk, xv} stacked over layers."""
    x = model.embed[token]
    kv_mode = L.decode_kv_mode(cfg)
    nks, nvs = [], []
    for li, p in enumerate(model.dec_blocks):
        h = L.norm(p.norm1, x, cfg.norm)
        a, kc, vc = L.cached_attention(
            p.attn, h, cache["k"][li], cache["v"][li], cache_len, cfg,
            kv_mode=kv_mode,
        )
        x = x + a
        h = L.norm(p.norm_c, x, cfg.norm)
        x = x + _cross_attn_decode(p.cross, h, cache["xk"][li], cache["xv"][li])
        h = L.norm(p.norm2, x, cfg.norm)
        x = x + L.mlp_block(p.mlp, h, cfg.act)
        nks.append(kc)
        nvs.append(vc)
    x = L.norm(model.final_norm, x, cfg.norm)
    logits = einsum("bsd,dv->bsv", x, model.lm_head)
    new_cache = {"k": torch.stack(nks, 0), "v": torch.stack(nvs, 0),
                 "xk": cache["xk"], "xv": cache["xv"]}
    return _greedy(logits), new_cache


def encdec_prefill(model: EncDec, tokens, frames, cfg):
    """Prefill (encoder + decoder prompt). Returns (last_logits, caches)."""
    logits, caches = encdec_forward(
        model, tokens, frames, cfg, collect_cache=True
    )
    return logits[:, -1:], caches
