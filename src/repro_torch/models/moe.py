"""Mixture-of-Experts FFN (port of ``repro.models.moe``, its dense path).

``_dense_moe`` is the reference's dropless path: every expert sees every
token, masked by the router's top-k combine weights. It is what the
reference runs without a mesh, and what the port runs.

The expert-parallel region (sort-based dispatch whose per-expert offsets
are the paper's exclusive prefix scan, then ``all_to_all`` both ways) needs
a mesh: ``moe_block`` raises under one (the next slice of the port).

``lax.top_k`` becomes ``torch.topk``. Their order among tied
probabilities may differ; the parity tests use inputs whose router
probabilities have no tie at the top-k boundary.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _ACT, MLP, einsum, param
from repro_torch.sharding import current_topology, require_local


class MoE(nn.Module):
    """``init_moe``: a float32 router (d, E), stacked experts w_in / w_gate
    (E, d, ff) and w_out (E, ff, d), and ``shared`` experts as one MLP of
    width ``moe_num_shared * ff``. Ungated configs carry no w_gate."""

    def __init__(self, gen: torch.Generator, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
        s_in = 1.0 / math.sqrt(d)
        s_out = 1.0 / math.sqrt(ff)
        self.router = param(gen, (d, E), s_in, torch.float32, device)
        self.w_in = param(gen, (E, d, ff), s_in, dtype, device)
        self.w_gate = (param(gen, (E, d, ff), s_in, dtype, device)
                       if cfg.gated_mlp else None)
        self.w_out = param(gen, (E, ff, d), s_out, dtype, device)
        self.shared = (MLP(gen, d, cfg.moe_num_shared * ff, dtype, device,
                           cfg.gated_mlp)
                       if cfg.moe_num_shared else None)


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype, device) -> MoE:
    return MoE(gen, cfg, dtype, device)


def _router(logits: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gates (n,k), experts (n,k), probs (n,E))."""
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts, probs


def _aux_losses(probs: torch.Tensor, experts: torch.Tensor, E: int,
                logits=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch-style load-balance loss + router z-loss (local means)."""
    n, k = experts.shape
    onehot = F.one_hot(experts, E).float()           # (n,k,E)
    frac_tokens = onehot.sum((0, 1)) / (n * k)
    frac_probs = probs.mean(0)
    lb = E * torch.sum(frac_tokens * frac_probs)
    zin = logits if logits is not None else torch.log(probs + 1e-20)
    z = torch.mean(torch.square(torch.logsumexp(zin, dim=-1)))
    return lb, z


def _expert_ffn(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """x: (E_loc, C', d) -> (E_loc, C', d)."""
    a = _ACT[act]
    h = einsum("ecd,edf->ecf", x, p.w_in)
    if p.w_gate is not None:
        h = a(einsum("ecd,edf->ecf", x, p.w_gate)) * h
    else:
        h = a(h)
    return einsum("ecf,efd->ecd", h, p.w_out)


def _shared_ffn(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    a = _ACT[act]
    h = einsum("bsd,df->bsf", x, p.w_in)
    if p.w_gate is not None:
        h = a(einsum("bsd,df->bsf", x, p.w_gate)) * h
    else:
        h = a(h)
    return einsum("bsf,fd->bsd", h, p.w_out)


def _dense_moe(p: MoE, x: torch.Tensor, cfg, act: str):
    """Dropless reference path: every expert sees every token (masked)."""
    B, S, d = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    xf = x.reshape(-1, d)
    logits = (xf.float() @ p.router).float()
    gates, experts, probs = _router(logits, k)
    lb, z = _aux_losses(probs, experts, E, logits)
    # combine weights (n, E)
    comb = torch.zeros((xf.shape[0], E), dtype=x.dtype, device=x.device)
    comb = comb.scatter_add(1, experts, gates.to(x.dtype))
    h = einsum("nd,edf->nef", xf, p.w_in)
    if p.w_gate is not None:
        h = _ACT[act](einsum("nd,edf->nef", xf, p.w_gate)) * h
    else:
        h = _ACT[act](h)
    y = einsum("nef,efd->ned", h, p.w_out)
    out = einsum("ned,ne->nd", y, comb).reshape(B, S, d)
    if p.shared is not None:
        out = out + _shared_ffn(p.shared, x, act)
    return out, {"load_balance": lb, "router_z": z}


def moe_block(p: MoE, x: torch.Tensor, cfg, *, act: str = "silu"):
    """Top-level MoE FFN: the dense path without a mesh; the expert-parallel
    region under one is not ported and raises."""
    if current_topology().mesh is not None:
        require_local("moe_block's expert-parallel region")
    return _dense_moe(p, x, cfg, act)
