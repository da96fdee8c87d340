"""Decoder-only LM assembly: dense / MoE / SSM / hybrid / VLM families (port
of ``repro.models.transformer``).

The reference stacks each family's layers into one pytree and runs them with
``lax.scan``; the port keeps one module per layer in an ``nn.ModuleList``
(``blocks``) and loops over it in Python. Heterogeneous patterns:

* gemma3's 5:1 local:global attention — ``_layer_flags`` gives each layer's
  is-global flag and ``_window_for`` its sliding-window width;
* jamba's 1-attention-per-8 + MoE-every-2 — ``periods`` is a list of
  ``ModuleDict``s whose ``sub_<i>`` entries are the period's sublayers
  (:func:`hybrid_layout`); a configuration with ``layer_types`` (Granite
  4.0-H) puts its one attention layer at any index of the period and an
  FFN block after every mixer.

Configurations with HF Granite's multipliers (``embedding_multiplier``,
``residual_multiplier``, ``logits_scaling``) and ``norm_eps`` apply them;
where a configuration has none, or one of 1, no op is added.

Module and parameter names are the reference's pytree keys, layer index
inserted: the reference's ``params["blocks"]["attn"]["wq"][3]`` is the port's
``blocks.3.attn.wq`` (:func:`repro_torch.interop.model_params_from_numpy`).
Caches are the reference's nested dicts, stacked over layers in the same
layout, so a cache from ``lm_prefill`` feeds ``lm_decode_step`` as in the
reference.

Every layer is rematerialised for training, as the reference's
``_remat`` does: :func:`repro_torch.models.layers.remat`
(``torch.utils.checkpoint``) while grad is enabled, nothing under
``torch.inference_mode()``. ``remat_policy=save_block_outputs`` keeps each
block's output (the reference's ``_name_out``): the port checkpoints each
block on its own instead of the layer whole, so the backward recomputes one
block at a time and never re-runs another block's collectives.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import perf_flags
from repro_torch.core.trees import tree_map
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models.layers import einsum, param

Params = Dict[str, Any]


def _save_blocks() -> bool:
    return perf_flags.FLAGS.remat_policy == "save_block_outputs"


def _remat(fn, *args):
    """``_remat(fn)(*args)``: the layer checkpointed whole, or, under
    ``save_block_outputs``, run as is with each block checkpointed by
    :func:`_block_out`."""
    if _save_blocks():
        return fn(*args)
    return L.remat(fn, *args)


def _block_out(fn, *args):
    """One block (norm + mixer or FFN) whose output the reference names
    ``block_out``: checkpointed on its own under ``save_block_outputs``
    (its output is kept, its inside recomputed), else run as is."""
    if _save_blocks():
        return L.remat(fn, *args)
    return fn(*args)


def _norm(p: L.Norm, x: torch.Tensor, cfg) -> torch.Tensor:
    """The configuration's norm, at its ``norm_eps`` where it sets one."""
    return L.norm(p, x, cfg.norm, getattr(cfg, "norm_eps", None))


def _scaled(x: torch.Tensor, cfg, name: str) -> torch.Tensor:
    """``x`` times the configuration's multiplier ``name``; no op where it
    has none or it is 1."""
    mult = getattr(cfg, name, 1.0)
    return x if mult == 1.0 else x * mult


def _residual(x: torch.Tensor, out: torch.Tensor, cfg) -> torch.Tensor:
    """``x + residual_multiplier * out``."""
    return x + _scaled(out, cfg, "residual_multiplier")


def hybrid_layout(cfg) -> Tuple[Tuple[str, bool], ...]:
    """``(kind, use_moe)`` of each sublayer of a hybrid period: from the
    configuration's ``layer_types`` where it has them (every period alike,
    one attention layer in each, an FFN block after every mixer), else the
    reference's attention at index 0 and an MoE at every ``i % moe_every
    == 1``."""
    period = cfg.attn_every or 8
    moe = cfg.moe_num_experts > 0
    types = tuple(getattr(cfg, "layer_types", ())[:cfg.num_layers])
    if not types:
        return tuple(("attn" if i == 0 else "mamba", moe and i % cfg.moe_every == 1)
                     for i in range(period))
    first = types[:period]
    if (len(types) != cfg.num_layers or cfg.num_layers % period
            or types != first * (cfg.num_layers // period)
            or first.count("attention") != 1
            or set(first) != {"attention", "mamba"}):
        raise ValueError(
            f"layer_types must repeat one period of {period} layers holding one "
            f"attention layer, over {cfg.num_layers} layers: {types}")
    return tuple(("attn" if t == "attention" else "mamba", moe) for t in first)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """``_init_block``: norm1 + attention or Mamba mixer, then (norm2 + MoE
    or dense MLP) unless the config has no FFN (mamba2)."""

    def __init__(self, gen: torch.Generator, cfg, kind: str, use_moe: bool,
                 dtype: torch.dtype, device):
        super().__init__()
        self.norm1 = L.Norm(cfg.d_model, cfg.norm, dtype, device)
        self.attn = self.mamba = self.norm2 = self.moe = self.mlp = None
        if kind == "attn":
            self.attn = L.Attention(gen, cfg, dtype, device)
        else:
            self.mamba = M.MambaMixer(gen, cfg, dtype, device)
        if use_moe:
            self.norm2 = L.Norm(cfg.d_model, cfg.norm, dtype, device)
            self.moe = MOE.MoE(gen, cfg, dtype, device)
        elif cfg.d_ff > 0:
            self.norm2 = L.Norm(cfg.d_model, cfg.norm, dtype, device)
            self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, dtype, device,
                             cfg.gated_mlp)


class LM(nn.Module):
    """The decoder-only LM: ``embed`` (padded vocab, d), ``final_norm``, an
    untied ``lm_head`` (d, padded vocab), and ``blocks`` (one per layer) or,
    for the hybrid family, ``periods``."""

    def __init__(self, gen: torch.Generator, cfg, device):
        super().__init__()
        self.cfg = cfg
        dtype = L.torch_dtype(cfg.dtype)
        Vp, d = cfg.padded_vocab, cfg.d_model
        self.embed = param(gen, (Vp, d), 0.02, dtype, device)
        self.final_norm = L.Norm(d, cfg.norm, dtype, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else param(gen, (d, Vp), 1.0 / math.sqrt(d), dtype, device))
        self.blocks = self.periods = None
        if cfg.family == "hybrid":
            layout = hybrid_layout(cfg)
            self.periods = nn.ModuleList()
            for _ in range(cfg.num_layers // len(layout)):
                sub = nn.ModuleDict()
                for i, (kind, use_moe) in enumerate(layout):
                    sub[f"sub_{i}"] = Block(gen, cfg, kind, use_moe, dtype, device)
                self.periods.append(sub)
            return
        kind = "mamba" if cfg.family == "ssm" else "attn"
        use_moe = cfg.moe_num_experts > 0 and cfg.family in ("moe",)
        self.blocks = nn.ModuleList(
            Block(gen, cfg, kind, use_moe, dtype, device)
            for _ in range(cfg.num_layers)
        )


def init_lm(gen: torch.Generator, cfg, device="cuda") -> LM:
    return LM(gen, cfg, device)


def _layer_flags(cfg) -> torch.Tensor:
    """Per-layer is_global flags (gemma3's r local : 1 global pattern)."""
    if cfg.local_global_ratio:
        r = cfg.local_global_ratio
        return torch.tensor(
            [1 if (i % (r + 1)) == r else 0 for i in range(cfg.num_layers)],
            dtype=torch.int32,
        )
    return torch.zeros((cfg.num_layers,), dtype=torch.int32)


def _window_for(cfg, is_global) -> int:
    if cfg.local_global_ratio:
        return 0 if int(is_global) > 0 else cfg.sliding_window
    return cfg.sliding_window


def _sub_keys(period: nn.ModuleDict):
    return sorted(period.keys(), key=lambda s: int(s.split("_")[1]))


def _stack(trees):
    """Stack same-structured cache trees along a new leading axis."""
    return tree_map(lambda *a: torch.stack(a, 0), *trees)


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# blocks (forward)
# ---------------------------------------------------------------------------


def _ffn(p: Block, x: torch.Tensor, cfg):
    if p.moe is not None:
        y, aux = MOE.moe_block(p.moe, x, cfg, act=cfg.act)
        return y, aux["load_balance"], aux["router_z"]
    return L.mlp_block(p.mlp, x, cfg.act), _zero(x.device), _zero(x.device)


def _maybe_ffn(p: Block, x: torch.Tensor, cfg):
    """Norm + FFN residual, skipped entirely for FFN-less blocks (mamba2)."""
    if p.moe is None and p.mlp is None:
        return x, _zero(x.device), _zero(x.device)
    f, lb, z = _block_out(
        lambda x: _ffn(p, _norm(p.norm2, x, cfg), cfg), x)
    return _residual(x, f, cfg), lb, z


def _attn_block_fwd(p, x, positions, cfg, window, positions3=None,
                    causal=True, collect=False):
    a = _block_out(lambda x: L.attention_block(
        p.attn, _norm(p.norm1, x, cfg), positions, cfg,
        causal=causal, window=window, positions3=positions3,
        return_kv=collect,
    ), x)
    kv = None
    if collect:
        a, kv = a
    x = _residual(x, a, cfg)
    x, lb, z = _maybe_ffn(p, x, cfg)
    return x, lb, z, kv


def _mamba_block_fwd(p, x, cfg, seq_parallel):
    a, cache = _block_out(lambda x: M.mamba_mixer(
        p.mamba, _norm(p.norm1, x, cfg), cfg,
        seq_parallel=seq_parallel), x)
    x = _residual(x, a, cfg)
    x, lb, z = _maybe_ffn(p, x, cfg)
    return x, lb, z, cache


def _logits(model: LM, x: torch.Tensor, cfg) -> torch.Tensor:
    x = _norm(model.final_norm, x, cfg)
    head = model.lm_head if model.lm_head is not None else model.embed.T
    # logits / logits_scaling, applied to the (B, S, d) input of the head
    # rather than to the (B, S, V) logits
    scaling = getattr(cfg, "logits_scaling", 1.0)
    if scaling != 1.0:
        x = x / scaling
    return einsum("bsd,dv->bsv", x, head)


# ---------------------------------------------------------------------------
# full forward (train / prefill)
# ---------------------------------------------------------------------------


def lm_forward(
    model: LM,
    tokens: torch.Tensor,
    cfg,
    *,
    vision_embeds: Optional[torch.Tensor] = None,
    positions3: Optional[torch.Tensor] = None,
    collect_cache: bool = False,
):
    """tokens (B, S) -> logits (B, S, Vp). Returns (logits, aux), and the
    stacked caches with ``collect_cache``."""
    B, S = tokens.shape
    x = _scaled(model.embed[tokens], cfg, "embedding_multiplier")
    if vision_embeds is not None:
        nv = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    lb_sum = _zero(x.device)
    z_sum = _zero(x.device)

    seq_par = cfg.family == "ssm"  # mamba2: sequence-parallel SSD on a mesh

    caches = None
    if cfg.family == "hybrid":
        layout = hybrid_layout(cfg)
        per_period = []
        for pp in model.periods:
            def period_fwd(x, pp=pp):
                lbs, zs = _zero(x.device), _zero(x.device)
                kv = None
                mcaches = []
                for (kind, _), sk in zip(layout, _sub_keys(pp)):
                    p = pp[sk]
                    if kind == "attn":
                        x, lb, z, kv = _attn_block_fwd(
                            p, x, positions, cfg, cfg.sliding_window,
                            collect=collect_cache,
                        )
                    else:
                        x, lb, z, mc = _mamba_block_fwd(p, x, cfg, False)
                        mcaches.append(mc)
                    lbs, zs = lbs + lb, zs + z
                cache = None
                if collect_cache:
                    cache = {"k": kv[0], "v": kv[1], "mamba": _stack(mcaches)}
                return x, lbs, zs, cache

            x, lb, z, cache = _remat(period_fwd, x)
            lb_sum, z_sum = lb_sum + lb, z_sum + z
            per_period.append(cache)
        if collect_cache:
            caches = _stack(per_period)
    else:
        flags = _layer_flags(cfg)
        per_layer = []
        for p, flag in zip(model.blocks, flags.tolist()):
            if cfg.family == "ssm":
                def layer_fwd(x, p=p):
                    x, lb, z, mc = _mamba_block_fwd(p, x, cfg, seq_par)
                    return x, lb, z, ({"mamba": mc} if collect_cache else None)
            else:
                def layer_fwd(x, p=p, window=_window_for(cfg, flag)):
                    x, lb, z, kv = _attn_block_fwd(
                        p, x, positions, cfg, window, positions3=positions3,
                        collect=collect_cache,
                    )
                    return x, lb, z, ({"k": kv[0], "v": kv[1]}
                                      if collect_cache else None)

            x, lb, z, cache = _remat(layer_fwd, x)
            lb_sum, z_sum = lb_sum + lb, z_sum + z
            per_layer.append(cache)
        if collect_cache:
            caches = _stack(per_layer)

    logits = _logits(model, x, cfg)
    aux = {"load_balance": lb_sum, "router_z": z_sum}
    if collect_cache:
        return logits, aux, caches
    return logits, aux


def lm_loss(model: LM, batch, cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: {tokens (B,S), labels (B,S), [vision_embeds, positions3]}.
    Differentiable: the training path takes its gradient with respect to
    the module's parameters (every layer rematerialised)."""
    logits, aux = lm_forward(
        model,
        batch["tokens"],
        cfg,
        vision_embeds=batch.get("vision_embeds"),
        positions3=batch.get("positions3"),
    )
    labels = batch["labels"]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    xent = torch.sum((lse - ll) * mask) / torch.clamp(mask.sum(), min=1.0)
    loss = xent + 0.01 * aux["load_balance"] + 0.001 * aux["router_z"]
    metrics = {"xent": xent, **aux}
    return loss, metrics


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------


def init_decode_cache(cfg, batch: int, seq_len: int, topo=None,
                      device="cuda") -> Params:
    """KV / SSM caches for one-token decode against a seq_len context."""
    dt = L.torch_dtype(cfg.dtype)
    hd = cfg.resolved_head_dim

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family == "ssm":
        state = M.init_mamba_state(cfg, batch, device=device)
        return {"mamba": tree_map(
            lambda a: zeros(cfg.num_layers, *a.shape, dtype=a.dtype), state)}
    if cfg.family == "hybrid":
        period = len(hybrid_layout(cfg))
        n_p = cfg.num_layers // period
        state = M.init_mamba_state(cfg, batch, device=device)
        return {
            "k": zeros(n_p, batch, seq_len, cfg.num_kv_heads, hd),
            "v": zeros(n_p, batch, seq_len, cfg.num_kv_heads, hd),
            "mamba": tree_map(
                lambda a: zeros(n_p, period - 1, *a.shape, dtype=a.dtype), state),
        }
    Lnum = cfg.num_layers
    cache = {
        "k": zeros(Lnum, batch, seq_len, cfg.num_kv_heads, hd),
        "v": zeros(Lnum, batch, seq_len, cfg.num_kv_heads, hd),
    }
    if cfg.encoder_layers:
        cache["xk"] = zeros(Lnum, batch, cfg.encoder_frames, cfg.num_kv_heads, hd)
        cache["xv"] = zeros(Lnum, batch, cfg.encoder_frames, cfg.num_kv_heads, hd)
    return cache


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax of the last position over the padded vocabulary (first
    maximum, as ``jnp.argmax``): (B, 1) int32."""
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def lm_decode_step(
    model: LM,
    token: torch.Tensor,       # (B, 1) int32
    cache: Params,
    cache_len: int,            # current context length
    cfg,
) -> Tuple[torch.Tensor, Params]:
    """One greedy decode step. Returns (next_token (B,1), new_cache); the
    cache handed in is left as it was."""
    kv_mode = L.decode_kv_mode(cfg)
    cache_len = int(cache_len)
    x = _scaled(model.embed[token], cfg, "embedding_multiplier")

    if cfg.family == "ssm":
        states = []
        for li, p in enumerate(model.blocks):
            st = tree_map(lambda a, li=li: a[li], cache["mamba"])
            h = _norm(p.norm1, x, cfg)
            a, st = M.mamba_decode(p.mamba, h, st, cfg)
            x = _residual(x, a, cfg)
            x, _, _ = _maybe_ffn(p, x, cfg)
            states.append(st)
        new_cache = {"mamba": _stack(states)}
    elif cfg.family == "hybrid":
        layout = hybrid_layout(cfg)
        nks, nvs, nms = [], [], []
        for pi, pp in enumerate(model.periods):
            kc, vc = cache["k"][pi], cache["v"][pi]
            mstates = tree_map(lambda a, pi=pi: a[pi], cache["mamba"])
            new_m = []
            for (kind, _), sk in zip(layout, _sub_keys(pp)):
                p = pp[sk]
                h = _norm(p.norm1, x, cfg)
                if kind == "attn":
                    a, kc, vc = L.cached_attention(
                        p.attn, h, kc, vc, cache_len, cfg, kv_mode=kv_mode
                    )
                else:
                    j = len(new_m)
                    st = tree_map(lambda a, j=j: a[j], mstates)
                    a, st = M.mamba_decode(p.mamba, h, st, cfg)
                    new_m.append(st)
                x = _residual(x, a, cfg)
                x, _, _ = _maybe_ffn(p, x, cfg)
            nks.append(kc)
            nvs.append(vc)
            nms.append(_stack(new_m))
        new_cache = {"k": torch.stack(nks, 0), "v": torch.stack(nvs, 0),
                     "mamba": _stack(nms)}
    else:
        flags = _layer_flags(cfg)
        nks, nvs = [], []
        for li, (p, flag) in enumerate(zip(model.blocks, flags.tolist())):
            h = _norm(p.norm1, x, cfg)
            window = _window_for(cfg, flag)
            a, kc, vc = L.cached_attention(
                p.attn, h, cache["k"][li], cache["v"][li], cache_len, cfg,
                window=window, kv_mode=kv_mode,
            )
            x = _residual(x, a, cfg)
            x, _, _ = _maybe_ffn(p, x, cfg)
            nks.append(kc)
            nvs.append(vc)
        new_cache = {"k": torch.stack(nks, 0), "v": torch.stack(nvs, 0)}

    logits = _logits(model, x, cfg)
    return _greedy(logits), new_cache


def lm_prefill(
    model: LM,
    tokens: torch.Tensor,
    cfg,
    *,
    vision_embeds: Optional[torch.Tensor] = None,
    positions3: Optional[torch.Tensor] = None,
):
    """Prefill: full forward collecting decode-ready caches.

    Returns (last_logits (B,1,Vp), caches). Cache layout matches
    init_decode_cache so the serving engine can continue decoding.
    """
    logits, _aux, caches = lm_forward(
        model, tokens, cfg,
        vision_embeds=vision_embeds, positions3=positions3,
        collect_cache=True,
    )
    return logits[:, -1:], caches
