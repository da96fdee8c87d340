"""A plain float32 Mamba2 language model (arXiv:2405.21060), its weights made
from a seed, and its loss and gradient computed in blocks of rows.

The configuration's file names the widths. The weights are named and laid
out as the program's module holds them, so that the same tensors load into
both: per layer ``blocks.<i>.norm1.scale`` and ``blocks.<i>.mamba.*`` (the
in projection stored per segment: z, x, B and C together, dt; a depthwise
causal conv of width ``d_conv`` over x and over B, C; ``A_log``, ``D`` and
``dt_bias`` in float32; the gated norm's scale; the out projection), then
``final_norm.scale`` and ``embed``, tied to the LM head.

The forward follows the paper: RMSNorm (applied as ``1 + scale``, eps 1e-6)
before each mixer, the residual around it; in the mixer the projections,
conv + SiLU, ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the SSD
with one group of B and C shared by the heads, the ``D`` skip, the gated
RMSNorm ``norm(y * silu(z))`` and the out projection; a final RMSNorm and
logits over the padded vocabulary. The SSD is the paper's own chunked
algorithm (its "minimal" listing: segment sums, diagonal blocks, chunk
states, the state passing across chunks, off-diagonal blocks), written
here again, not the program's.

Departures from the published model, shared with the program: the conv
input tails a prefill returns are the projections before the conv; the
norm scales are stored as offsets from one; the vocabulary is padded to a
multiple of 128 (logits and the loss's log-sum-exp run over the padding).

``precision="fp8"`` rounds both operands of every matrix product to
float8 e4m3 (one scale a tensor, from its largest magnitude) before
multiplying in float32: the control, the step below the bfloat16 the
configuration states.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


def widths(c: Dict) -> Dict[str, int]:
    d = int(c["d_model"])
    di = int(c["expand"]) * d
    return {
        "d": d, "di": di, "N": int(c["d_state"]), "P": int(c["headdim"]),
        "H": di // int(c["headdim"]), "Q": int(c["chunk_size"]),
        "W": int(c["d_conv"]), "L": int(c["n_layer"]),
        "V": int(c["vocab_size"]),
        "Vp": -(-int(c["vocab_size"]) // int(c["pad_vocab_size_multiple"]))
        * int(c["pad_vocab_size_multiple"]),
    }


def param_table(c: Dict) -> List[Tuple[str, Tuple[int, ...], str, str, float, float]]:
    """``(name, shape, dtype, law, a, b)`` of every weight, drawn as the
    published implementation (``mamba_ssm``) initialises them: the
    embedding normal with std 0.02; the in projections and the conv as
    PyTorch's ``Linear`` and ``Conv1d`` do, uniform within ``1 /
    sqrt(fan_in)``; the out projection so, then divided by ``sqrt(n_layer)``
    (its rescaled pre-norm residual); ``A = -U[1, 16]``; ``dt`` log-uniform
    in [0.001, 0.1] through the inverse softplus into ``dt_bias``; ``D`` and
    the norms' weights one (stored here as offsets of zero)."""
    w = widths(c)
    d, di, N, H, W, L = w["d"], w["di"], w["N"], w["H"], w["W"], w["L"]
    act = c["dtype"]
    lin, conv, out = d ** -0.5, W ** -0.5, di ** -0.5 / math.sqrt(L)
    rows = [("embed", (w["Vp"], d), act, "normal", 0.0, 0.02),
            ("final_norm.scale", (d,), act, "const", 0.0, 0.0)]
    for i in range(L):
        b = f"blocks.{i}."
        m = b + "mamba."
        rows += [
            (b + "norm1.scale", (d,), act, "const", 0.0, 0.0),
            (m + "w_z", (d, di), act, "uniform", -lin, lin),
            (m + "w_x", (d, di), act, "uniform", -lin, lin),
            (m + "w_bc", (d, 2 * N), act, "uniform", -lin, lin),
            (m + "w_dt", (d, H), act, "uniform", -lin, lin),
            (m + "conv_w_x", (W, di), act, "uniform", -conv, conv),
            (m + "conv_b_x", (di,), act, "uniform", -conv, conv),
            (m + "conv_w_bc", (W, 2 * N), act, "uniform", -conv, conv),
            (m + "conv_b_bc", (2 * N,), act, "uniform", -conv, conv),
            (m + "A_log", (H,), "float32", "log_uniform", 1.0, 16.0),
            (m + "D", (H,), "float32", "const", 1.0, 1.0),
            (m + "dt_bias", (H,), "float32", "dt_bias", 0.001, 0.1),
            (m + "norm_scale", (di,), act, "const", 0.0, 0.0),
            (m + "w_out", (di, d), act, "uniform", -out, out),
        ]
    return rows


def _draw(u: torch.Tensor, law: str, a: float, b: float) -> torch.Tensor:
    """Uniform [0, 1) draws ``u`` under the named law."""
    if law == "uniform":
        return a + (b - a) * u
    if law == "normal":
        return a + b * math.sqrt(2.0) * torch.erfinv((2.0 * u - 1.0).clamp(-1 + 1e-7, 1 - 1e-7))
    if law == "log_uniform":       # A_log = log(U[a, b])
        return torch.log(a + (b - a) * u)
    if law == "dt_bias":           # softplus^-1 of dt, log-uniform in [a, b]
        dt = torch.exp(math.log(a) + (math.log(b) - math.log(a)) * u).clamp(min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    if law == "const":
        return torch.full_like(u, a)
    raise ValueError(law)


def make_weights(c: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight from ``seed``: one uniform draw on ``device`` for all of
    them, cut into leaves, each under its law and cast to its type."""
    table = param_table(c)
    total = sum(math.prod(row[1]) for row in table)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, dt, law, a, b in table:
        n = math.prod(shape)
        out[name] = _draw(flat[at:at + n].view(shape), law, a, b).to(getattr(torch, dt))
        at += n
    return out


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32)
    # the rounding is a constant to autograd (straight through)
    return t + (q * scale - t).detach()


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t + (t.to(torch.bfloat16).float() - t).detach()


def _mm(spec: str, a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    elif precision == "bf16":
        a, b = _bf16(a), _bf16(b)
    return torch.einsum(spec, a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: ``out[t] = b + sum_k w[k] x[t - W + 1 + k]``."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    S = x.shape[1]
    return b + sum(w[k] * xp[:, k:k + S] for k in range(W))


def segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = sum_{j < k <= i} x[..., k]`` for i >= j, else -inf
    (the paper's stable segment sum)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~low, 0.0)
    out = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), 0)
    return out.masked_fill(~keep, -math.inf)


def ssd(X: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        Q: int, precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's chunked SSD. ``X`` (b, l, h, p) already scaled by dt, ``A``
    (b, l, h) the log decays ``dt * A``, ``B``, ``C`` (b, l, n). Returns
    ``Y`` (b, l, h, p) and the final state (b, h, p, n)."""
    b, l, h, p = X.shape
    n = B.shape[-1]
    Q = min(Q, l)
    c = l // Q
    X = X.reshape(b, c, Q, h, p)
    B = B.reshape(b, c, Q, n)
    C = C.reshape(b, c, Q, n)
    A = A.reshape(b, c, Q, h).permute(0, 3, 1, 2)           # (b, h, c, Q)
    A_cum = torch.cumsum(A, dim=-1)
    # diagonal blocks
    Lmat = torch.exp(segsum(A))                              # (b, h, c, Q, Q)
    scores = _mm("bcln,bcsn->bcls", C, B, precision)         # (b, c, Q, Q)
    Wt = scores[:, None] * Lmat                              # (b, h, c, Q, Q)
    Y_diag = _mm("bhcls,bcshp->bclhp", Wt, X, precision)
    # each chunk's state
    decay = torch.exp(A_cum[..., -1:] - A_cum)               # (b, h, c, Q)
    Xd = X * decay.permute(0, 2, 3, 1)[..., None]
    states = _mm("bclhp,bcln->bchpn", Xd, B, precision)
    # state passing across chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))  # (b, h, c+1, c+1)
    new = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)
    states, final = new[:, :-1], new[:, -1]
    # off-diagonal blocks
    out_decay = torch.exp(A_cum)                             # (b, h, c, Q)
    Y_off = _mm("bcln,bchpn->bclhp", C, states, precision)
    Y_off = Y_off * out_decay.permute(0, 2, 3, 1)[..., None]
    return (Y_diag + Y_off).reshape(b, l, h, p), final


def mixer(p: Dict[str, torch.Tensor], pre: str, u: torch.Tensor, c: Dict,
          precision: str):
    """One Mamba2 mixer over ``u`` (b, l, d), float32. Returns the output
    and its decode state (final SSM state, the conv inputs' last tails)."""
    w = widths(c)
    b, l, _ = u.shape
    H, P, N, W = w["H"], w["P"], w["N"], w["W"]
    z = _mm("bld,de->ble", u, p[pre + "w_z"], precision)
    xin = _mm("bld,de->ble", u, p[pre + "w_x"], precision)
    bc = _mm("bld,de->ble", u, p[pre + "w_bc"], precision)
    dt = _mm("bld,de->ble", u, p[pre + "w_dt"], precision)
    tails = (xin[:, -(W - 1):], bc[:, -(W - 1):])
    xc = F.silu(causal_conv(xin, p[pre + "conv_w_x"], p[pre + "conv_b_x"]))
    bcc = F.silu(causal_conv(bc, p[pre + "conv_w_bc"], p[pre + "conv_b_bc"]))
    Bm, Cm = bcc[..., :N], bcc[..., N:]
    dt = F.softplus(dt + p[pre + "dt_bias"])                 # (b, l, H)
    A = -torch.exp(p[pre + "A_log"])                         # (H,)
    xs = xc.reshape(b, l, H, P)
    Y, final = ssd(xs * dt[..., None], dt * A, Bm, Cm, w["Q"], precision)
    y = Y + p[pre + "D"][:, None] * xs
    y = y.reshape(b, l, H * P) * F.silu(z)
    y = rmsnorm(y, p[pre + "norm_scale"])
    out = _mm("ble,ed->bld", y, p[pre + "w_out"], precision)
    return out, (final, tails[0], tails[1])


def hidden(p: Dict[str, torch.Tensor], tokens: torch.Tensor, c: Dict,
           precision: str = "f32", remat: bool = False,
           states: Optional[list] = None) -> torch.Tensor:
    """The residual stream after the last layer, (b, l, d); with ``states``
    a list, each layer's decode state is appended to it."""
    h = p["embed"][tokens]
    for i in range(widths(c)["L"]):
        pre = f"blocks.{i}."

        def block(h, pre=pre):
            out, st = mixer(p, pre + "mamba.", rmsnorm(h, p[pre + "norm1.scale"]), c, precision)
            return h + out, st

        if remat:
            h, _ = checkpoint(block, h, use_reentrant=False)
        else:
            h, st = block(h)
            if states is not None:
                states.append(st)
        if precision == "bf16":
            h = _bf16(h)
    return rmsnorm(h, p["final_norm.scale"])


def logits(p: Dict[str, torch.Tensor], h: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    return _mm("bld,vd->blv", h, p["embed"], precision)


def xent_sum(p, tokens, labels, c, precision="f32", remat=True) -> torch.Tensor:
    """Summed next-token cross-entropy of a block of rows."""
    lg = logits(p, hidden(p, tokens, c, precision, remat=remat), precision)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return (lse - ll).sum()


def loss_and_grads(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   labels: torch.Tensor, c: Dict, rows: int = 2,
                   precision: str = "f32") -> Tuple[float, Dict[str, torch.Tensor]]:
    """Mean cross-entropy over every token of the batch and its gradient
    with respect to every float32 leaf of ``p``, ``rows`` rows at a time,
    each layer recomputed in the backward."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    names = list(leaves)
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    count = tokens.numel()
    total = 0.0
    for r in range(0, tokens.shape[0], rows):
        with torch.enable_grad():
            part = xent_sum(leaves, tokens[r:r + rows], labels[r:r + rows], c,
                            precision) / count
            got = torch.autograd.grad(part, [leaves[k] for k in names])
        for k, g in zip(names, got):
            grads[k] += g
        total += float(part.detach())
    return total, grads


@torch.no_grad()
def prefill(p: Dict[str, torch.Tensor], tokens: torch.Tensor, c: Dict,
            rows: int = 1, precision: str = "f32"):
    """Last-position logits (b, Vp) and each layer's decode state, stacked:
    ``ssm`` (L, b, H, P, N), ``conv_x`` (L, b, W-1, di), ``conv_bc``
    (L, b, W-1, 2N); ``rows`` rows at a time."""
    outs, ssm, cx, cbc = [], [], [], []
    for r in range(0, tokens.shape[0], rows):
        states: list = []
        h = hidden(p, tokens[r:r + rows], c, precision, states=states)
        outs.append(logits(p, h[:, -1:], precision)[:, 0])
        ssm.append(torch.stack([s[0] for s in states]))
        cx.append(torch.stack([s[1] for s in states]))
        cbc.append(torch.stack([s[2] for s in states]))
    return (torch.cat(outs), {"ssm": torch.cat(ssm, 1), "conv_x": torch.cat(cx, 1),
                              "conv_bc": torch.cat(cbc, 1)})
