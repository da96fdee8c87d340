"""Granite-4.0-H-Small [hf: ibm-granite/granite-4.0-h-small] — Mamba2 + NoPE
GQA 9:1, a 72-expert top-10 MoE with a shared expert after every mixer.

A port-only configuration: its settings that :class:`ModelConfig` has no
field for (the layer layout, HF ``GraniteMoeHybrid``'s four multipliers and
the norms' eps) live in the subclass :class:`GraniteHybridConfig`, so the
port's ``ModelConfig`` stays field for field the reference's. The layer
equations (HF ``GraniteMoeHybridDecoderLayer``)::

    x0 = 12 * embed[tokens]
    h  = x + 0.22 * mixer(norm(x))                 mixer: Mamba2 or attention
    y  = h + 0.22 * (moe(norm(h)) + shared(norm(h)))
    logits = norm(x_L) @ embed^T / 16

The attention layers use no position embedding (``rope_theta=0``) and the
score scale ``attention_multiplier`` (1/128) in place of ``1/sqrt(128)``.
The router takes the top 10 of 72 logits and softmaxes over them: the
port's ``_router`` (softmax over all, top-k, renormalise). Each expert is a
gated SiLU MLP of width 768; the shared MLP is ``moe_num_shared = 2``
experts wide, 1536, as published. The MoE runs the dropless routed path
(``moe_routed``) on one rank.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

from repro_torch.configs.base import ModelConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4


@dataclasses.dataclass(frozen=True)
class GraniteHybridConfig(ModelConfig):
    """A hybrid whose layout is ``layer_types`` (one entry a layer, each
    period of ``attn_every`` layers alike, one attention layer in it) with
    an FFN block after every mixer, and HF Granite's multipliers."""

    layer_types: Tuple[str, ...] = ()
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    #: the attention's score scale (None: 1/sqrt(head_dim))
    attention_multiplier: Optional[float] = None
    logits_scaling: float = 1.0
    norm_eps: float = 1e-6
    #: the dropless routed MoE (``models.moe._routed_moe``) off a mesh; a
    #: configuration without it takes the dense path
    moe_routed: ClassVar[bool] = True

    # -- the parameters of this layout, as the port's modules hold them --

    def _layer_params(self) -> Tuple[int, int, int]:
        """(Mamba mixer, attention, FFN block) parameters of one layer."""
        d, ff, E = self.d_model, self.d_ff, self.moe_num_experts
        di, N, H = self.ssm_d_inner, self.ssm_state, self.ssm_num_heads
        hd, W = self.resolved_head_dim, 4
        mamba = (d * (2 * di + 2 * N + H) + W * (di + 2 * N) + di + 2 * N
                 + 3 * H + di + di * d)
        attn = d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d
        expert = 3 * d * ff
        ffn = d * E + E * expert + self.moe_num_shared * expert
        return mamba, attn, ffn

    def param_count(self) -> int:
        mamba, attn, ffn = self._layer_params()
        d = self.d_model
        types = self.layer_types[:self.num_layers]
        n_attn = sum(t == "attention" for t in types)
        total = self.padded_vocab * d + d
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        total += n_attn * attn + (self.num_layers - n_attn) * mamba
        return total + self.num_layers * (ffn + 2 * d)

    def active_param_count(self) -> int:
        inert = (self.moe_num_experts - self.moe_top_k) * 3 * self.d_model * self.d_ff
        return self.param_count() - self.num_layers * inert

    def reduced(self) -> "GraniteHybridConfig":
        """One period at the family's tiny widths, for the CPU tests."""
        return dataclasses.replace(
            super().reduced(), num_layers=len(_PERIOD), layer_types=_PERIOD,
            attn_every=len(_PERIOD), num_kv_heads=2, moe_num_shared=2, d_ff=32)


CONFIG = GraniteHybridConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=768,
    vocab_size=100352,
    head_dim=128,
    moe_num_experts=72,
    moe_top_k=10,
    moe_num_shared=2,
    moe_every=1,
    attn_every=len(_PERIOD),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    rope_theta=0.0,
    tie_embeddings=True,
    layer_types=_PERIOD * 4,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    norm_eps=1e-5,
)
