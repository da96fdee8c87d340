"""A plain float32 Granite-4.0-H stack (HF ``GraniteMoeHybrid``), its weights
made from a seed, its forward computed in blocks of rows, and its FLOP count.

The configuration's file is HF's ``config.json`` (keys as published); the
first ``num_hidden_layers`` entries of ``layer_types`` are run. The weights
are named and laid out as the program's module holds them, so that the same
tensors load into both: ``embed`` (tied to the LM head), ``final_norm.scale``
and per layer ``periods.<p>.sub_<i>.`` (``i`` the index in the period of
``len(layer_types) / #attention`` layers) ``norm1.scale``, the mixer
(``mamba.*`` as in ``reference/mamba2.py``, or ``attn.wq`` (d, heads, hd),
``attn.wk`` / ``attn.wv`` (d, kv heads, hd), ``attn.wo`` (heads, hd, d)),
``norm2.scale`` and the MoE: ``moe.router`` (d, E) in float32, the experts
``moe.w_in`` / ``moe.w_gate`` (E, d, ff) and ``moe.w_out`` (E, ff, d), and
the shared MLP ``moe.shared.{w_in,w_gate}`` (d, fs) and ``moe.shared.w_out``.

The forward follows HF's ``GraniteMoeHybridDecoderLayer``::

    h = 12 * embed[tokens]
    h = h + 0.22 * mixer(rmsnorm(h))
    h = h + 0.22 * (moe(rmsnorm(h)) + shared(rmsnorm(h)))
    logits = rmsnorm(h) @ embed^T / 16

with every RMSNorm at eps 1e-5 (``rms_norm_eps``), the gated one inside the
Mamba2 mixer too. The Mamba2 mixer is ``reference/mamba2.py``'s (its
projections, conv, the paper's chunked SSD, the ``D`` skip), with the
gated norm at this eps, over any sequence length (the SSD's last chunk
padded with steps that change nothing). The attention is causal GQA
without a position embedding, scores scaled by ``attention_multiplier``,
computed in blocks of queries so that no (S, S) score matrix exists at
once. The router takes the
top ``num_experts_per_tok`` of the logits and softmaxes over them (HF's
``GraniteMoeHybridTopKGating``); each expert is a gated SiLU MLP
(``silu(x w_gate) * (x w_in) w_out``), run over the tokens routed to it,
expert by expert, and weighted by its gate.

Departures from the published model, shared with the program: the norm
weights are stored as offsets from one; the conv input tails a prefill
returns are the projections before the conv.

``precision="fp8"`` rounds both operands of every matrix product to float8
e4m3 (``reference/mamba2.py``'s ``_mm``): the control, the step below the
bfloat16 the configuration states.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.mamba2 import _bf16, _draw, _mm, causal_conv, ssd


def widths(c: Dict) -> Dict[str, int]:
    d = int(c["hidden_size"])
    heads = int(c["num_attention_heads"])
    return {
        "d": d, "di": int(c["mamba_expand"]) * d, "N": int(c["mamba_d_state"]),
        "P": int(c["mamba_d_head"]), "H": int(c["mamba_n_heads"]),
        "Q": int(c["mamba_chunk_size"]), "W": int(c["mamba_d_conv"]),
        "G": int(c["mamba_n_groups"]), "L": int(c["num_hidden_layers"]),
        "V": int(c["vocab_size"]), "Vp": -(-int(c["vocab_size"]) // 128) * 128,
        "nh": heads, "kh": int(c["num_key_value_heads"]), "hd": d // heads,
        "E": int(c["num_local_experts"]), "k": int(c["num_experts_per_tok"]),
        "ff": int(c["intermediate_size"]), "fs": int(c["shared_intermediate_size"]),
    }


def layer_types(c: Dict) -> List[str]:
    return list(c["layer_types"][:int(c["num_hidden_layers"])])


def period(c: Dict) -> int:
    """The layers of one period of the published layout."""
    types = c["layer_types"]
    return len(types) // types.count("attention")


def layer_prefix(c: Dict, i: int) -> str:
    return f"periods.{i // period(c)}.sub_{i % period(c)}."


def param_table(c: Dict) -> List[Tuple[str, Tuple[int, ...], str, str, float, float]]:
    """``(name, shape, dtype, law, a, b)`` of every weight: the embedding
    normal with std 0.02; every projection (the router, the experts, the
    shared MLP, attention, the Mamba2 projections) uniform within ``1 /
    sqrt(fan_in)``, as PyTorch's ``Linear`` draws it, and the depthwise conv
    as ``Conv1d`` does; the Mamba2 ``A = -U[1, 16]``, ``dt`` log-uniform in
    [0.001, 0.1] through the inverse softplus into ``dt_bias``, ``D`` one,
    as ``mamba_ssm`` draws them; the norms' weights one (offsets of zero)."""
    w = widths(c)
    d, di, N, H, W = w["d"], w["di"], w["N"], w["H"], w["W"]
    nh, kh, hd, E, ff, fs = w["nh"], w["kh"], w["hd"], w["E"], w["ff"], w["fs"]
    act = c["dtype"]
    lin, conv = d ** -0.5, W ** -0.5
    rows = [("embed", (w["Vp"], d), act, "normal", 0.0, 0.02),
            ("final_norm.scale", (d,), act, "const", 0.0, 0.0)]
    for i, kind in enumerate(layer_types(c)):
        b = layer_prefix(c, i)
        rows.append((b + "norm1.scale", (d,), act, "const", 0.0, 0.0))
        if kind == "mamba":
            m = b + "mamba."
            rows += [
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
                (m + "w_out", (di, d), act, "uniform", -di ** -0.5, di ** -0.5),
            ]
        else:
            a = b + "attn."
            o = (nh * hd) ** -0.5
            rows += [
                (a + "wq", (d, nh, hd), act, "uniform", -lin, lin),
                (a + "wk", (d, kh, hd), act, "uniform", -lin, lin),
                (a + "wv", (d, kh, hd), act, "uniform", -lin, lin),
                (a + "wo", (nh, hd, d), act, "uniform", -o, o),
            ]
        e = b + "moe."
        rows += [
            (b + "norm2.scale", (d,), act, "const", 0.0, 0.0),
            (e + "router", (d, E), "float32", "uniform", -lin, lin),
            (e + "w_in", (E, d, ff), act, "uniform", -lin, lin),
            (e + "w_gate", (E, d, ff), act, "uniform", -lin, lin),
            (e + "w_out", (E, ff, d), act, "uniform", -ff ** -0.5, ff ** -0.5),
            (e + "shared.w_in", (d, fs), act, "uniform", -lin, lin),
            (e + "shared.w_out", (fs, d), act, "uniform", -fs ** -0.5, fs ** -0.5),
            (e + "shared.w_gate", (d, fs), act, "uniform", -lin, lin),
        ]
    return rows


def make_weights(c: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight from ``seed``: uniform draws on ``device`` from one
    generator, a leaf at a time in the table's order, each under its law
    and cast to its type."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out = {}
    for name, shape, dt, law, a, b in param_table(c):
        u = torch.rand(shape, generator=gen, device=device)
        out[name] = _draw(u, law, a, b).to(getattr(torch, dt))
    return out


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def mixer(p: Dict[str, torch.Tensor], pre: str, u: torch.Tensor, c: Dict,
          precision: str):
    """One Mamba2 mixer over ``u`` (b, l, d). Returns the output and its
    decode state (final SSM state, the conv inputs' last tails)."""
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
    dt = F.softplus(dt + p[pre + "dt_bias"])
    A = -torch.exp(p[pre + "A_log"])
    xs = xc.reshape(b, l, H, P)
    # a sequence of no whole number of chunks is padded at its end with
    # steps that add nothing and decay nothing: the outputs before them and
    # the final state are those of the sequence itself
    Q = min(w["Q"], l)
    steps = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, -l % Q))
             for t in (xs * dt[..., None], dt * A, Bm, Cm)]
    Y, final = ssd(*steps, Q, precision)
    y = (Y[:, :l] + p[pre + "D"][:, None] * xs).reshape(b, l, H * P) * F.silu(z)
    y = rmsnorm(y, p[pre + "norm_scale"], float(c["rms_norm_eps"]))
    return _mm("ble,ed->bld", y, p[pre + "w_out"], precision), (final, *tails)


def attention(p: Dict[str, torch.Tensor], pre: str, u: torch.Tensor, c: Dict,
              precision: str, q_block: int = 1024):
    """Causal GQA without a position embedding, ``q_block`` queries at a
    time. Returns the output and the layer's K and V (b, l, kv heads, hd)."""
    w = widths(c)
    b, l, _ = u.shape
    kh, hd = w["kh"], w["hd"]
    g = w["nh"] // kh
    q = _mm("bld,dhk->blhk", u, p[pre + "wq"], precision)
    k = _mm("bld,dhk->blhk", u, p[pre + "wk"], precision)
    v = _mm("bld,dhk->blhk", u, p[pre + "wv"], precision)
    scale = float(c["attention_multiplier"])
    out = torch.empty_like(q)
    for s in range(0, l, q_block):
        e = min(l, s + q_block)
        qb = q[:, s:e].reshape(b, e - s, kh, g, hd)
        scores = _mm("bqhgd,bkhd->bhgqk", qb, k[:, :e], precision) * scale
        later = (torch.arange(e, device=u.device)[None, :]
                 > torch.arange(s, e, device=u.device)[:, None])
        probs = torch.softmax(scores.masked_fill(later, -math.inf), dim=-1)
        out[:, s:e] = _mm("bhgqk,bkhd->bqhgd", probs, v[:, :e], precision).reshape(
            b, e - s, kh * g, hd)
    return _mm("blhk,hkd->bld", out, p[pre + "wo"], precision), (k, v)


def moe(p: Dict[str, torch.Tensor], pre: str, u: torch.Tensor, c: Dict,
        precision: str) -> torch.Tensor:
    """The routed experts, expert by expert over their tokens, plus the
    shared MLP."""
    w = widths(c)
    b, l, d = u.shape
    x = u.reshape(b * l, d)
    logits = _mm("nd,de->ne", x, p[pre + "router"], precision)
    top, experts = torch.topk(logits, w["k"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(x)
    for e in range(w["E"]):
        tok, slot = (experts == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = (F.silu(_mm("nd,df->nf", xe, p[pre + "w_gate"][e], precision))
             * _mm("nd,df->nf", xe, p[pre + "w_in"][e], precision))
        ye = _mm("nf,fd->nd", h, p[pre + "w_out"][e], precision)
        out.index_add_(0, tok, ye * gates[tok, slot, None])
    s = pre + "shared."
    h = (F.silu(_mm("nd,df->nf", x, p[s + "w_gate"], precision))
         * _mm("nd,df->nf", x, p[s + "w_in"], precision))
    return (out + _mm("nf,fd->nd", h, p[s + "w_out"], precision)).reshape(b, l, d)


def hidden(p: Dict[str, torch.Tensor], tokens: torch.Tensor, c: Dict,
           precision: str = "f32", states: list = None) -> torch.Tensor:
    """The normed residual stream after the last layer, (b, l, d); with
    ``states`` a list, each layer's decode state is appended to it:
    ``("mamba", (ssm, conv_x, conv_bc))`` or ``("attention", (k, v))``."""
    eps, res = float(c["rms_norm_eps"]), float(c["residual_multiplier"])
    h = p["embed"][tokens] * float(c["embedding_multiplier"])
    for i, kind in enumerate(layer_types(c)):
        pre = layer_prefix(c, i)
        u = rmsnorm(h, p[pre + "norm1.scale"], eps)
        if kind == "mamba":
            out, st = mixer(p, pre + "mamba.", u, c, precision)
        else:
            out, st = attention(p, pre + "attn.", u, c, precision)
        h = h + res * out
        h = h + res * moe(p, pre + "moe.", rmsnorm(h, p[pre + "norm2.scale"], eps), c,
                          precision)
        if states is not None:
            states.append((kind, st))
        if precision == "bf16":
            h = _bf16(h)
    return rmsnorm(h, p["final_norm.scale"], eps)


def logits(p: Dict[str, torch.Tensor], h: torch.Tensor, c: Dict,
           precision: str = "f32") -> torch.Tensor:
    return _mm("bld,vd->blv", h, p["embed"], precision) / float(c["logits_scaling"])


@torch.no_grad()
def prefill(p: Dict[str, torch.Tensor], tokens: torch.Tensor, c: Dict,
            rows: int = 1, precision: str = "f32"):
    """Last-position logits (b, Vp) and each layer's decode state, stacked
    over the layers of its kind: ``ssm`` (Lm, b, H, P, N), ``conv_x``
    (Lm, b, W-1, di), ``conv_bc`` (Lm, b, W-1, 2N), ``k`` and ``v`` (La, b,
    l, kv heads, hd); ``rows`` rows at a time."""
    outs = []
    parts: Dict[str, list] = {n: [] for n in ("ssm", "conv_x", "conv_bc", "k", "v")}
    for r in range(0, tokens.shape[0], rows):
        states: list = []
        h = hidden(p, tokens[r:r + rows], c, precision, states=states)
        outs.append(logits(p, h[:, -1:], c, precision)[:, 0])
        mamba = [st for kind, st in states if kind == "mamba"]
        attn = [st for kind, st in states if kind == "attention"]
        for j, name in enumerate(("ssm", "conv_x", "conv_bc")):
            parts[name].append(torch.stack([st[j] for st in mamba]))
        for j, name in enumerate(("k", "v")):
            parts[name].append(torch.stack([st[j] for st in attn]))
    return torch.cat(outs), {n: torch.cat(v, 1) for n, v in parts.items()}


# ---------------------------------------------------------------------------
# the FLOP count
# ---------------------------------------------------------------------------


def layer_flops(c: Dict, seq: int) -> Dict[str, float]:
    """One row of ``seq`` tokens through one layer of each kind: a
    multiply-add is two operations, counted from the widths alone.

    * ``mamba``: the in projections ``2 d (2 di + 2 N + H)`` and the out
      projection ``2 di d`` a token, the depthwise conv ``2 W (di + 2 N)``;
      a chunk of ``Q`` tokens: the causal half of ``C B^T`` (``Q (Q + 1) /
      2`` pairs, ``2 N`` each) and of the weighted sum into the outputs
      (``2 H P`` a pair), the chunk's state ``2 Q H P N``, the outputs from
      the state entering the chunk ``2 Q H P N``, the state passing ``2 H P
      N`` (``reference/flops.py``'s count of a Mamba2 layer);
    * ``attention``: the projections ``2 d (heads + 2 kv heads) hd + 2
      heads hd d`` a token, and the causal half of the scores and of the
      weighted sum, ``4 heads hd`` a (query, key) pair, ``l (l + 1) / 2``
      pairs;
    * ``routed``: the top-k experts a token, ``6 d ff`` each;
    * ``moe``: ``routed``, the router ``2 d E`` and the shared MLP ``6 d
      fs`` a token."""
    w = widths(c)
    d, di, N, H, P, W = w["d"], w["di"], w["N"], w["H"], w["P"], w["W"]
    Q = min(w["Q"], seq)
    pairs = Q * (Q + 1) // 2
    per_chunk = pairs * (2 * N + 2 * H * P) + 4 * Q * H * P * N + 2 * H * P * N
    mamba = (seq * (2 * d * (2 * di + 2 * N + H) + 2 * W * (di + 2 * N) + 2 * di * d)
             + (seq // Q) * per_chunk)
    nh, kh, hd = w["nh"], w["kh"], w["hd"]
    attn = (seq * (2 * d * (nh + 2 * kh) * hd + 2 * nh * hd * d)
            + 4 * nh * hd * seq * (seq + 1) // 2)
    routed = seq * w["k"] * 6 * d * w["ff"]
    moe_all = routed + seq * (2 * d * w["E"] + 6 * d * w["fs"])
    return {"mamba": float(mamba), "attention": float(attn), "routed": float(routed),
            "moe": float(moe_all)}


def forward_flops(c: Dict, batch: int, seq: int, head_positions: int) -> float:
    """One forward over ``batch`` rows of ``seq`` tokens, the LM head (``2 d
    V`` over the real vocabulary) at ``head_positions`` positions a row."""
    f = layer_flops(c, seq)
    layers = sum(f[kind] + f["moe"] for kind in layer_types(c))
    w = widths(c)
    return float(batch * (layers + 2 * w["d"] * w["V"] * head_positions))


def routed_expert_flops(c: Dict, batch: int, seq: int) -> float:
    """The routed experts' share of one forward: ``B S k 6 d ff`` a layer."""
    return float(batch * layer_flops(c, seq)["routed"] * int(c["num_hidden_layers"]))
