"""Mixture-of-Experts FFN with expert-parallel (EP) dispatch (port of
``repro.models.moe``).

Under a mesh whose model axis divides the experts, ``moe_block`` runs the
reference's EP region inside :func:`repro_torch.compat.block_shard_map`,
experts sharded over the model axis. Dispatch is sort-based with static
capacity: router top-k -> counts -> the *exclusive prefix scan* for the
per-expert offsets (the paper's primitive: ``ops.prefix_scan``, K3 on a
CUDA tensor, one launch for every co-resident rank's counts) -> the slots
of an (E, C, d) buffer -> ``all_to_all`` -> expert FFN -> ``all_to_all``
back -> the weighted combine, a sum over the k picks taken in order.

``_dense_moe`` is the reference's dropless path: every expert sees every
token, masked by the router's top-k combine weights. It runs without a
mesh, on one rank, and when the experts do not divide the model axis.

``_routed_moe`` is the port's dropless routed path for one rank, which a
configuration selects with ``moe_routed`` (Granite 4.0-H): router top-k ->
per-expert counts -> the offsets by the exclusive prefix scan (K3) -> a
stable sort of the picks by expert and a gather into expert-contiguous rows
-> the gated expert FFN as grouped GEMMs over those offsets
(``torch._grouped_mm``, the group ends read on the device) -> the
gate-weighted combine, one reduction over each token's k picks. No pick is
dropped and no count is read on the host. Its spans: ``moe.block`` around
``moe.route`` (router to sort), ``moe.experts`` and ``moe.combine`` (with
the shared MLP); its series: the counter ``repro_moe_picks_total`` and the
gauge ``repro_moe_expert_picks_max``, the most picks one expert took in the
last call, read from the card at a scrape.

The aux losses of the EP region are globally exact: the sufficient
statistics are pmean'd over (dp..., model) first.

``lax.top_k`` becomes ``torch.topk``. Their order among tied
probabilities may differ; the parity tests use inputs whose router
probabilities have no tie at the top-k boundary. ``jnp.argsort`` is stable
and so is the port's.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import compat
from repro_torch.compat import P
from repro_torch.kernels.ops import prefix_scan
from repro_torch.models.layers import _ACT, MLP, einsum, param
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.sharding import current_topology


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


#: the last routed call's largest per-expert count, a 0-d tensor left on
#: its device until a scrape reads it
_last_picks_max = [None]


def _publish(registry: obs_metrics.MetricsRegistry) -> None:
    registry.callback_gauge(
        "repro_moe_expert_picks_max",
        "the most picks one expert took in the last routed MoE call", (),
        lambda: ({} if _last_picks_max[0] is None
                 else {(): float(_last_picks_max[0])}))


obs_metrics.add_process_series(_publish)


def _grouped_ffn(p, rows: torch.Tensor, ends: torch.Tensor, act: str) -> torch.Tensor:
    """The gated expert FFN over expert-contiguous ``rows`` (m, d): rows
    ``ends[e - 1]:ends[e]`` go through expert ``e``. Grouped GEMMs that read
    the group ends (int32) on the device."""
    h = (_ACT[act](torch._grouped_mm(rows, p.w_gate, offs=ends))
         * torch._grouped_mm(rows, p.w_in, offs=ends))
    return torch._grouped_mm(h, p.w_out, offs=ends)


def _routed_moe(p: MoE, x: torch.Tensor, cfg, act: str):
    """Dropless routed path on one rank: each token's k picks go through
    their experts alone (the module docstring)."""
    B, S, d = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    n = B * S
    dev = x.device
    with obs_tracing.span("moe.block", "moe"):
        with obs_tracing.span("moe.route", "moe"):
            xf = x.reshape(n, d)
            logits = (xf.float() @ p.router).float()
            gates, experts, probs = _router(logits, k)
            lb, z = _aux_losses(probs, experts, E, logits)
            flat_e = experts.reshape(-1)                   # (n k,), token-major
            counts = torch.zeros(E, dtype=torch.int32, device=dev).scatter_add_(
                0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
            # per-expert offsets: THE PAPER'S PRIMITIVE -- exclusive prefix scan,
            # each expert's first row, as the EP region takes its bucket bases;
            # the grouped GEMMs read each group's end, its base plus its count
            ends = prefix_scan(counts, op="add", exclusive=True) + counts
            order = torch.argsort(flat_e, stable=True)
            rows = xf[order // k]
        with obs_tracing.span("moe.experts", "moe"):
            y = _grouped_ffn(p, rows, ends, act)
        with obs_tracing.span("moe.combine", "moe"):
            y = y * gates.reshape(-1)[order].to(y.dtype)[:, None]
            got = torch.empty_like(y).index_copy_(0, order, y).reshape(n, k, d)
            # one reduction over the k picks, accumulated in float32 and
            # rounded once (a bf16 sum's accumulator is float32)
            out = got.sum(1).reshape(B, S, d)
            if p.shared is not None:
                out = out + _shared_ffn(p.shared, x, act)
        _last_picks_max[0] = counts.max()
        obs_metrics.get_registry().counter(
            "repro_moe_picks_total", "expert picks routed by the routed MoE"
        ).inc(n * k)
    return out, {"load_balance": lb, "router_z": z}


def _ep_region(x, router, w_in, w_gate, w_out, *, cfg, act, axis, dp_axes):
    """Per-rank EP dispatch over ``R`` rank rows. x: (R, B_loc, S_loc, d);
    router (R, d, E); experts sharded, (R, E_loc, ...)."""
    R, B, S, d = x.shape
    n = B * S
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    C = int(math.ceil(n * k / E * cfg.capacity_factor))
    # round capacity to a lane multiple, as the reference does
    C = max(8, -(-C // 8) * 8)
    dev = x.device

    xf = x.reshape(R, n, d)
    logits = (xf.float() @ router).float()
    gates, experts, probs = _router(logits, k)
    # globally-exact aux stats: pmean the sufficient statistics FIRST
    axes = tuple(dp_axes) + (axis,)
    onehot = F.one_hot(experts, E).float()            # (R, n, k, E)
    frac_tokens = compat.pmean(onehot.sum((1, 2)) / (n * k), axes)
    frac_probs = compat.pmean(probs.mean(1), axes)
    lb = E * torch.sum(frac_tokens * frac_probs, dim=-1)
    z = compat.pmean(
        torch.mean(torch.square(torch.logsumexp(logits, dim=-1)), dim=-1), axes
    )

    flat_e = experts.reshape(R, -1)                   # (R, nk)
    flat_g = gates.reshape(R, -1).to(x.dtype)
    nk = n * k
    counts = F.one_hot(flat_e, E).sum(1).to(torch.int32)   # (R, E)
    # per-expert offsets: THE PAPER'S PRIMITIVE -- exclusive prefix scan
    starts = prefix_scan(counts, op="add", exclusive=True)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    pos_sorted = (torch.arange(nk, dtype=torch.int32, device=dev)
                  - torch.gather(starts, 1, torch.gather(flat_e, 1, order)))
    pos = torch.zeros((R, nk), dtype=torch.int32, device=dev).scatter(
        1, order, pos_sorted)

    tok = torch.arange(n, device=dev).repeat_interleave(k)
    slot = torch.where(pos < C, flat_e * C + pos, E * C)   # OOB -> dropped
    rows = torch.arange(R, device=dev)[:, None]
    # one spare row past the buffer takes every dropped token
    buf = torch.zeros((R, E * C + 1, d), dtype=x.dtype, device=dev)
    buf[rows, slot] = xf[:, tok]
    # all_to_all: expert-group i goes to rank i; my experts' tokens arrive
    # concatenated along capacity: (E, C, d) -> (E_loc, ep*C, d)
    buf = buf[:, :E * C].reshape(R, E, C, d)
    buf = compat.all_to_all(buf, axis, split_axis=1, concat_axis=2)
    E_loc = buf.shape[1]

    def fold(w):
        return None if w is None else w.reshape((R * E_loc,) + w.shape[2:])

    out = _expert_ffn(
        SimpleNamespace(w_in=fold(w_in), w_gate=fold(w_gate), w_out=fold(w_out)),
        buf.reshape((R * E_loc,) + buf.shape[2:]), act)

    # reverse: (E_loc, ep*C, d) -> (E, C, d)
    out = out.reshape((R, E_loc) + out.shape[1:])
    out = compat.all_to_all(out, axis, split_axis=2, concat_axis=1)
    out = torch.cat([out.reshape(R, E * C, d),
                     torch.zeros((R, 1, d), dtype=out.dtype, device=dev)], 1)
    got = out[rows, slot] * flat_g[..., None]         # (R, nk, d)
    # the reference's scatter-add over tok = repeat(arange(n), k): each
    # token's k picks, added in order
    got = got.reshape(R, n, k, d)
    y = torch.zeros((R, n, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + got[:, :, j]
    return y.reshape(R, B, S, d), lb, z


def token_spec(topo, B: int, S: int) -> P:
    """How the EP region splits (B, S, d) tokens: batch over dp; sequence
    over the model axis (SP) when it divides, else the model axis folded
    into the batch (decode), else batch over dp only, else replicated."""
    dp = topo.batch_axes
    dpspec = dp[0] if len(dp) == 1 else dp
    ep, dp_size = topo.model_size, topo.dp_size
    if S % ep == 0 and B % dp_size == 0:
        return P(dpspec, topo.model_axis, None)
    if B % (dp_size * ep) == 0:
        return P(tuple(dp) + (topo.model_axis,), None, None)
    if B % dp_size == 0:
        return P(dpspec, None, None)
    return P(None, None, None)


def moe_block(p: MoE, x: torch.Tensor, cfg, *, act: str = "silu"):
    """Top-level MoE FFN. Chooses EP (a block_shard_map region) or, on one
    rank, the routed path where the configuration asks for it, else the
    dense fallback."""
    topo = current_topology()
    E = cfg.moe_num_experts
    ep = topo.model_size
    if topo.mesh is None or ep == 1 or E % ep != 0:
        if getattr(cfg, "moe_routed", False):
            return _routed_moe(p, x, cfg, act)
        return _dense_moe(p, x, cfg, act)

    axis = topo.model_axis
    dp = topo.batch_axes
    x_spec = token_spec(topo, *x.shape[:2])

    def region(x_l, router, w_in, w_gate, w_out):
        return _ep_region(x_l, router, w_in, w_gate, w_out, cfg=cfg, act=act,
                          axis=axis, dp_axes=dp)

    w_spec = P(axis, None, None)
    y, lb, z = compat.block_shard_map(
        region, topo.mesh,
        in_specs=(x_spec, P(None, None), w_spec, w_spec, w_spec),
        out_specs=(x_spec, P(), P()),
    )(x, p.router, p.w_in, p.w_gate, p.w_out)
    if p.shared is not None:
        y = y + _shared_ffn(p.shared, x, act)
    return y, {"load_balance": lb, "router_z": z}
