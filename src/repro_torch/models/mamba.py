"""Mamba2 (SSD) mixer with the sequence-parallel inter-chunk scan (port of
``repro.models.mamba``).

The chunked SSD of arXiv:2405.21060, as the reference computes it:

* intra-chunk work is the matmul ("attention-like") form over (Q x Q)
  chunk score matrices;
* the within-chunk cumulative log-decays go through the port's
  ``kernels.ops.prefix_scan``: K3 (``kernels/csrc/prefix_scan.cu``) on a
  CUDA tensor, its plain version on a CPU tensor. One launch a Mamba layer
  a forward or prefill; a decode step launches none;
* the inter-chunk state propagation ``h' = A*h + B`` is the reference's
  ``lax.associative_scan`` over the chunk axis, here a loop over the chunks
  with the same operator and operand order ``comb(l, r)``;
* the chunk output ``y = y_intra + y_inter`` of a call that :func:`k6_takes`
  (bf16 / fp16 on the card, chunks of a multiple of 64 rows up to 256,
  head size 64, state 128, no autograd graph recorded) is one K6 launch
  (``kernels/csrc/ssd_chunk.cu``) over the chunk's bf16 scores, which keeps
  the (B, c, Q, Q, H) float32 decay and weight tensors out of device
  memory; every other call (training, float32, the CPU, other widths)
  computes it as the reference writes it, through K6's plain version
  (``kernels.ref.ref_ssd_chunk_intra`` and ``_inter``). Each call is one ``ssd.block``
  span, each K6 call one ``k6.call``.

Projections are stored per segment (z, x, BC, dt), as in the reference.

Modes, as in the reference:

* ``seq_parallel=True`` under a mesh (mamba2-130m): the sequence is sharded
  over the model axis inside :func:`repro_torch.compat.block_shard_map`.
  The conv halo is one neighbour ``ppermute`` (rank 0's zero fill is the
  causal padding), and the inter-chunk state crosses shards through the
  paper's scan collective, ``dist_exscan`` with the SSD operator over
  ``SpmdBackend``. Each shard's chunked SSD runs its segment scan on K3:
  the region folds its rank rows into the batch, so co-resident shards
  share one launch a layer;
* otherwise the full sequence per rank; under a mesh the reference shards
  heads (jamba's TP mode) with placement constraints only, which the port
  computes as the local mixer (``sharding.shard`` is the identity).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import compat, perf_flags
from repro_torch.compat import P
from repro_torch.core import SSD, dist_exscan
from repro_torch.core.trees import tree_map
from repro_torch.kernels import ssd_chunk as K6
from repro_torch.kernels.ops import prefix_scan, ssd_chunk_out
from repro_torch.kernels.ref import ref_ssd_chunk_inter, ref_ssd_chunk_intra
from repro_torch.models.layers import const, einsum, param, remat
from repro_torch.obs import tracing as obs_tracing
from repro_torch.sharding import current_topology, shard

_CONV_WIDTH = 4


class MambaMixer(nn.Module):
    """``init_mamba``: the per-segment projections, the depthwise conv of
    the x and BC segments, ``A_log`` / ``D`` / ``dt_bias`` in float32, the
    gated norm's scale and the out projection."""

    def __init__(self, gen: torch.Generator, cfg, dtype: torch.dtype, device):
        super().__init__()
        d = cfg.d_model
        di = cfg.ssm_d_inner
        N = cfg.ssm_state
        H = cfg.ssm_num_heads
        s = 1.0 / math.sqrt(d)
        self.w_z = param(gen, (d, di), s, dtype, device)
        self.w_x = param(gen, (d, di), s, dtype, device)
        self.w_bc = param(gen, (d, 2 * N), s, dtype, device)
        self.w_dt = param(gen, (d, H), s, dtype, device)
        self.conv_w_x = param(gen, (_CONV_WIDTH, di), 0.5, dtype, device)
        self.conv_b_x = const(torch.zeros(di), dtype, device)
        self.conv_w_bc = param(gen, (_CONV_WIDTH, 2 * N), 0.5, dtype, device)
        self.conv_b_bc = const(torch.zeros(2 * N), dtype, device)
        f32 = torch.float32
        self.A_log = const(torch.log(torch.linspace(1.0, 16.0, H)), f32, device)
        self.D = const(torch.ones(H), f32, device)
        self.dt_bias = const(torch.full((H,), math.log(math.e - 1)), f32, device)
        self.norm_scale = const(torch.zeros(di), dtype, device)
        self.w_out = param(gen, (di, d), 1.0 / math.sqrt(di), dtype, device)


def init_mamba(gen: torch.Generator, cfg, dtype: torch.dtype, device) -> MambaMixer:
    return MambaMixer(gen, cfg, dtype, device)


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            halo: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv width 4 + silu. halo: (B, 3, C) left context."""
    B, S, C = x.shape
    if halo is None:
        halo = torch.zeros((B, _CONV_WIDTH - 1, C), dtype=x.dtype, device=x.device)
    ext = torch.cat([halo, x], dim=1)
    out = torch.zeros_like(x)
    for wi in range(_CONV_WIDTH):
        out = out + ext[:, wi:wi + S] * w[wi]
    return F.silu(out + b)


def _gated_rmsnorm(scale: torch.Tensor, y: torch.Tensor,
                   z: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(y.dtype)


def _norm_eps(cfg) -> float:
    """The gated norm's eps: the configuration's ``norm_eps`` where it
    sets one."""
    return getattr(cfg, "norm_eps", 1e-6)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _segment_scan(dAc: torch.Tensor) -> torch.Tensor:
    """Within-chunk cumulative log decay of (B, nc, Q, H) increments,
    through K3 along Q: (B, nc, Q, H) float32. ``ops.prefix_scan`` reshapes
    the moved axes to (B*nc*H, Q), a copy, and the kernel's wrapper makes
    its input contiguous: K3 is never handed a strided view."""
    seg = prefix_scan(torch.movedim(dAc, 2, 3).float())   # (B,nc,H,Q)
    return torch.movedim(seg, 3, 2)                        # (B,nc,Q,H)


def _chunk_scan(A_c: torch.Tensor, S_c: torch.Tensor):
    """Inclusive scan over the chunk axis (dim 1) under
    ``comb((al, sl), (ar, sr)) = (ar * al, ar * sl + sr)``: the reference's
    ``lax.associative_scan(comb, (A_c, S_c), axis=1)`` as a loop."""
    A_inc, S_inc = [A_c[:, 0]], [S_c[:, 0]]
    for c in range(1, A_c.shape[1]):
        al, sl = A_inc[-1], S_inc[-1]
        ar, sr = A_c[:, c], S_c[:, c]
        A_inc.append(ar * al)
        S_inc.append(ar[..., None, None] * sl + sr)
    return torch.stack(A_inc, 1), torch.stack(S_inc, 1)


def k6_takes(device_type: str, dtype: Optional[torch.dtype], chunk: int,
             head_dim: int, state: int, records_grad: bool) -> bool:
    """Whether :func:`_ssd_chunked` computes a call's chunk output on K6:
    operands on the card, no autograd graph recorded (K6 has no backward),
    and a type (``dtype`` None where ``xs``, ``Bc`` and ``Cc`` differ),
    chunk, head size and state that K6 is built for (``K6.takes``)."""
    return (device_type == "cuda" and not records_grad
            and K6.takes(dtype, chunk, head_dim, state))


def _ssd_chunked(
    xs: torch.Tensor,     # (B, S, H, P) conv'd inputs
    Bc: torch.Tensor,     # (B, S, N)
    Cc: torch.Tensor,     # (B, S, N)
    dA: torch.Tensor,     # (B, S, H) log-decay increments (<= 0)
    dt: torch.Tensor,     # (B, S, H) softplus'd step sizes
    chunk: int,
    state_in: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Chunked SSD. Returns (y, (A_tot, S_tot), extras), as the reference.

    The sequence must be a whole number of chunks of ``min(chunk, S)``; the
    reference asserts so, the port raises ``ValueError``. One ``ssd.block``
    span; where :func:`k6_takes`, the chunk output is one K6 call."""
    with obs_tracing.span("ssd.block", "ssd"):
        return _ssd_chunked_body(xs, Bc, Cc, dA, dt, chunk, state_in)


def _ssd_chunked_body(xs, Bc, Cc, dA, dt, chunk, state_in):
    B, S, H, Pd = xs.shape
    N = Bc.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    if S % Q != 0:
        raise ValueError((S, Q))
    dtype = xs.dtype if Bc.dtype == Cc.dtype == xs.dtype else None
    operands = (xs, Bc, Cc, dA, dt) + tuple(state_in or ())
    records_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in operands)
    on_k6 = k6_takes(xs.device.type, dtype, Q, Pd, N, records_grad)

    xb = (xs * dt[..., None]).to(xs.dtype)           # dt-scaled inputs
    xbc_ = xb.reshape(B, nc, Q, H, Pd)
    Bcc = Bc.reshape(B, nc, Q, N)
    Ccc = Cc.reshape(B, nc, Q, N)
    dAc = dA.reshape(B, nc, Q, H)

    # within-chunk cumulative log decay: K3 on the card
    seg = _segment_scan(dAc)

    def intra(Ccc, Bcc, seg, xbc_):
        scores = einsum("bcin,bcjn->bcij", Ccc, Bcc)
        return ref_ssd_chunk_intra(scores, torch.movedim(seg, 2, 3), xbc_)

    if not on_k6:
        # the (B, c, Q, Q, H) decay matrix is recomputed in the backward
        y_intra = remat(intra, Ccc, Bcc, seg, xbc_)

    # chunk summary states: S_c = sum_j decay_to_end_j * xb_j (x) B_j
    decay_end = torch.exp(seg[:, :, -1:, :] - seg)   # (B,c,Q,H)
    S_c = einsum("bcjhp,bcjn->bchpn", xbc_ * decay_end[..., None], Bcc)
    A_c = torch.exp(seg[:, :, -1, :])                # (B,c,H)

    A_inc, S_inc = _chunk_scan(A_c, S_c)
    A_exc = torch.cat([torch.ones_like(A_inc[:, :1]), A_inc[:, :-1]], dim=1)
    S_exc = torch.cat([torch.zeros_like(S_inc[:, :1]), S_inc[:, :-1]], dim=1)
    if state_in is not None:
        a_in, s_in = state_in                        # (B,H), (B,H,P,N)
        S_exc = A_exc[..., None, None] * s_in[:, None] + S_exc
        A_exc = A_exc * a_in[:, None]

    if on_k6:
        # the scores as the eager path's einsum rounds them, then K6 over
        # K3's (B, c, H, Q) segments: y in one launch
        scores = einsum("bcin,bcjn->bcij", Ccc, Bcc)
        y = ssd_chunk_out(scores, torch.movedim(seg, 2, 3), xbc_, Ccc,
                          S_exc).reshape(B, S, H, Pd)
    else:
        y_inter = ref_ssd_chunk_inter(Ccc, S_exc, torch.movedim(seg, 2, 3))
        y = (y_intra + y_inter).reshape(B, S, H, Pd)
    A_tot, S_tot = A_inc[:, -1], S_inc[:, -1]        # totals
    if state_in is not None:
        S_tot = A_inc[:, -1][..., None, None] * state_in[1] + S_tot
        A_tot = A_tot * state_in[0]
    extras = (Ccc, seg, A_exc)
    return y, (A_tot, S_tot), extras


def _project(p: MambaMixer, x: torch.Tensor, cfg,
             halo_x: Optional[torch.Tensor], tp: bool):
    """proj + conv. Returns (z, xs, Bc, Cc, dtp, dA, tails). ``halo_x``
    (B, 3, d) is the left context a sequence shard receives; None is the
    causal zero padding."""
    B, S, _ = x.shape
    N, H = cfg.ssm_state, cfg.ssm_num_heads
    Pd = cfg.ssm_head_dim
    z = einsum("bsd,de->bse", x, p.w_z)
    x_in = einsum("bsd,de->bse", x, p.w_x)
    bc = einsum("bsd,de->bse", x, p.w_bc)
    dt = einsum("bsd,de->bse", x, p.w_dt)
    if tp:
        z = shard(z, "batch", None, "model")
        x_in = shard(x_in, "batch", None, "model")
        dt = shard(dt, "batch", None, "heads")

    halo_xin = halo_bc = None
    if halo_x is not None:
        halo_xin = einsum("bsd,de->bse", halo_x, p.w_x)
        halo_bc = einsum("bsd,de->bse", halo_x, p.w_bc)
    tails = (x_in[:, -(_CONV_WIDTH - 1):], bc[:, -(_CONV_WIDTH - 1):])
    x_in = _conv1d(x_in, p.conv_w_x, p.conv_b_x, halo_xin)
    bc = _conv1d(bc, p.conv_w_bc, p.conv_b_bc, halo_bc)
    xs = x_in.reshape(B, S, H, Pd)
    Bc, Cc = bc[..., :N], bc[..., N:]
    dtp = _softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    dA = dtp * A
    return z, xs, Bc, Cc, dtp, dA, tails


def _mixer_core(p: MambaMixer, x: torch.Tensor, cfg, halo_x, state_in,
                seq_axis: Optional[str], tp: bool):
    """The reference's mixer body. With ``seq_axis`` it runs inside a
    :func:`~repro_torch.compat.block_shard_map` region whose ``R`` rank rows
    are folded into ``x``'s batch (``R * B`` rows): the collectives see
    them unfolded, as ``(R, B, ...)``."""
    B, S, _ = x.shape
    di = cfg.ssm_d_inner
    H, Pd = cfg.ssm_num_heads, cfg.ssm_head_dim
    chunk = perf_flags.FLAGS.ssm_chunk or cfg.ssm_chunk
    z, xs, Bc, Cc, dtp, dA, tails = _project(p, x, cfg, halo_x, tp)

    if seq_axis is not None:
        y, (A_tot, S_tot), (Ccc, seg, A_exc) = _ssd_chunked(
            xs, Bc, Cc, dA, dtp, chunk
        )
        R = compat.region_rows(seq_axis)

        def ranked(a):
            return a.reshape((R, B // R) + a.shape[1:])

        # cross-shard incoming state via the offloaded scan collective
        payload = (ranked(A_tot[..., None, None]), ranked(S_tot))
        if perf_flags.FLAGS.scan_payload_bf16:
            payload = tree_map(lambda t: t.bfloat16(), payload)
        a_in, s_in = dist_exscan(
            payload, SSD, seq_axis,
            algorithm=perf_flags.FLAGS.scan_algorithm,
        )
        a_in = a_in[..., 0, 0].reshape(A_tot.shape).to(A_tot.dtype)   # (B,H)
        s_in = s_in.reshape(S_tot.shape).to(S_tot.dtype)
        y_add = einsum(
            "bcin,bch,bhpn->bcihp", Ccc, A_exc, s_in
        ) * torch.exp(seg)[..., None]
        y = y + y_add.reshape(B, S, H, Pd)
        S_tot = A_tot[..., None, None] * s_in + S_tot
        A_tot = A_tot * a_in
    else:
        y, (A_tot, S_tot), _ = _ssd_chunked(
            xs, Bc, Cc, dA, dtp, chunk, state_in=state_in
        )

    y = y + p.D[None, None, :, None].to(y.dtype) * xs.to(y.dtype)
    y = y.reshape(B, S, di)
    y = _gated_rmsnorm(p.norm_scale, y.to(x.dtype), z, _norm_eps(cfg))
    out = einsum("bse,ed->bsd", y, p.w_out).to(x.dtype)
    if tp:
        out = shard(out, "batch", None, None)
    cache = {
        "ssm": S_tot.float(),
        "conv_x": tails[0],
        "conv_bc": tails[1],
    }
    if seq_axis is not None:
        # the decode cache is global: take the LAST sequence shard's values
        psize = compat.axis_size(seq_axis)

        def from_last(a):
            a = ranked(a)
            last = compat.axis_index_rows(seq_axis, a.ndim) == psize - 1
            kept = compat.psum(torch.where(last, a, torch.zeros_like(a)),
                               seq_axis)
            return kept.reshape((B,) + a.shape[2:])

        cache = tree_map(from_last, cache)
    return out, cache


def mamba_mixer(
    p: MambaMixer,
    x: torch.Tensor,
    cfg,
    *,
    seq_parallel: bool = False,
    state_in: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence SSD mixer (train / prefill).

    Returns (y, cache) where cache = {ssm, conv_x, conv_bc} is decode-ready
    (the final SSD state and the conv-input tails)."""
    topo = current_topology()
    B, S, _ = x.shape
    sp_ok = (
        seq_parallel
        and topo.mesh is not None
        and topo.model_size > 1
        and S % topo.model_size == 0
        and (S // topo.model_size) >= _CONV_WIDTH
    )
    if not sp_ok:
        tp = topo.mesh is not None and not seq_parallel
        return _mixer_core(p, x, cfg, None, state_in, None, tp)

    axis = topo.model_axis
    dp = topo.batch_axes
    dpspec = dp[0] if len(dp) == 1 else dp
    x_spec = P(dpspec, axis, None)

    def region(x_l):
        # conv halo: last 3 raw tokens from the left sequence shard (rank 0
        # receives ppermute zero-fill == causal zero padding)
        R, Bl, Sl, d = x_l.shape
        psize = compat.axis_size(axis)
        tail = x_l[:, :, -(_CONV_WIDTH - 1):, :]
        halo_x = compat.ppermute(
            tail, axis, [(i, i + 1) for i in range(psize - 1)])
        out, cache = _mixer_core(
            p, x_l.reshape(R * Bl, Sl, d), cfg,
            halo_x.reshape(R * Bl, _CONV_WIDTH - 1, d), None, axis, False)
        return (out.reshape(R, Bl, Sl, d),
                tree_map(lambda a: a.reshape((R, Bl) + a.shape[1:]), cache))

    cache_specs = {
        "ssm": P(dpspec, None, None, None),
        "conv_x": P(dpspec, None, None),
        "conv_bc": P(dpspec, None, None),
    }
    mapped = compat.block_shard_map(
        region, topo.mesh, in_specs=(x_spec,), out_specs=(x_spec, cache_specs),
    )
    return mapped(x)


def init_mamba_state(cfg, batch: int, dtype=torch.float32, device=None):
    """Zero decode state {ssm, conv_x, conv_bc} on ``device``: the card
    unless the caller names another; without a card the default raises."""
    from repro_torch.models.model import model_device

    device = model_device(device)
    H, Pd, N = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, H, Pd, N), dtype=dtype, device=device),
        "conv_x": torch.zeros((batch, _CONV_WIDTH - 1, cfg.ssm_d_inner),
                              dtype=dtype, device=device),
        "conv_bc": torch.zeros((batch, _CONV_WIDTH - 1, 2 * N), dtype=dtype,
                               device=device),
    }


def mamba_decode(
    p: MambaMixer, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token SSD step. x: (B, 1, d); state: {ssm, conv_x, conv_bc}.
    Returns new state tensors; ``state`` is left as it was."""
    B = x.shape[0]
    di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads
    Pd = cfg.ssm_head_dim
    z = einsum("bsd,de->bse", x, p.w_z)
    x_in = einsum("bsd,de->bse", x, p.w_x)
    bc = einsum("bsd,de->bse", x, p.w_bc)
    dt = einsum("bsd,de->bse", x, p.w_dt)

    # concatenation promotes, as jnp's does: a float32 state makes the
    # conv of a bf16 model run in float32
    ext_x = torch.cat([state["conv_x"], x_in], dim=1)    # (B, W, di)
    ext_bc = torch.cat([state["conv_bc"], bc], dim=1)
    cx = F.silu(einsum("bwc,wc->bc", ext_x, p.conv_w_x) + p.conv_b_x)
    cbc = F.silu(einsum("bwc,wc->bc", ext_bc, p.conv_w_bc) + p.conv_b_bc)

    xs = cx.reshape(B, H, Pd)
    Bc, Cc = cbc[..., :N], cbc[..., N:]
    dtp = _softplus(dt[:, 0].float() + p.dt_bias)    # (B,H)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dtp * A)                        # (B,H)
    h = state["ssm"]
    h = (
        decay[..., None, None] * h
        + (dtp[..., None] * xs.float())[..., None]
        * Bc.float()[:, None, None, :]
    )
    y = torch.einsum("bhpn,bn->bhp", h, Cc.float())
    y = y + p.D[None, :, None] * xs.float()
    y = y.reshape(B, 1, di).to(x.dtype)
    y = _gated_rmsnorm(p.norm_scale, y, z, _norm_eps(cfg))
    out = einsum("bse,ed->bsd", y, p.w_out).to(x.dtype)
    return out, {"ssm": h, "conv_x": ext_x[:, 1:], "conv_bc": ext_bc[:, 1:]}
