"""Config system: model architecture + input-shape + run configs (port of
``repro.configs.base``).

Every assigned architecture is a ``ModelConfig`` in its own module
(``repro_torch/configs/<id>.py``); the registry maps ``--arch`` ids to
configs and owns the official input-shape set. ``reduced()`` derives the
family-preserving tiny config used by the per-arch CPU tests. The
dataclasses, their fields, properties and ``reduced()`` are copies of the
reference's, so a configuration means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_every: int = 1             # apply MoE every k-th FFN (jamba: 2)
    capacity_factor: float = 1.25
    # --- attention pattern ---
    sliding_window: int = 0        # >0: local-attention window size
    local_global_ratio: int = 0    # gemma3: 5 local per 1 global
    qkv_bias: bool = False         # qwen2/2.5
    # --- ssm / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0            # jamba: 1 attention layer per 8 (period)
    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    encoder_frames: int = 1500     # whisper stub: precomputed frame embeddings
    # --- vlm ---
    mrope: bool = False
    vision_patches: int = 1024     # stub: precomputed patch embeddings
    # --- misc ---
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.num_heads == 0:
            return 0
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 128 multiple so the vocab dim shards cleanly."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / windowed attention)."""
        return self.family in ("ssm", "hybrid") or self.local_global_ratio > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), used by roofline."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        q = d * self.num_heads * hd + (0 if not self.qkv_bias else self.num_heads * hd)
        kv = 2 * (d * self.num_kv_heads * hd + (0 if not self.qkv_bias else self.num_kv_heads * hd))
        o = self.num_heads * hd * d
        attn = q + kv + o
        nmat = 3 if self.gated_mlp else 2
        dense_mlp = nmat * d * ff  # gated (w_in, w_gate, w_out) or plain (w_in, w_out)
        moe_mlp = 0
        if self.moe_num_experts:
            expert = nmat * d * ff
            moe_mlp = self.moe_num_experts * expert + d * self.moe_num_experts
            moe_mlp += self.moe_num_shared * expert
        ssm = 0
        if self.ssm_state:
            di, N, H = self.ssm_d_inner, self.ssm_state, self.ssm_num_heads
            ssm = d * (2 * di + 2 * N + H) + di * d + di + 2 * H  # in/out proj, B,C, dt, A, D

        def block_cost(has_attn: bool, has_moe: bool, has_ssm: bool) -> int:
            c = 2 * d  # norms
            if has_attn:
                c += attn
            if has_ssm:
                c += ssm
            c += moe_mlp if has_moe else dense_mlp
            return c

        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        L = self.num_layers
        if self.family == "ssm":
            total += L * (ssm + 2 * d) + d
            return total
        if self.family == "hybrid":
            period = self.attn_every or 8
            n_attn = L // period
            n_ssm = L - n_attn
            n_moe = L // max(self.moe_every, 1) if self.moe_num_experts else 0
            total += n_attn * (attn + 2 * d) + n_ssm * (ssm + 2 * d)
            total += n_moe * moe_mlp + (L - n_moe) * dense_mlp
            return total + d
        if self.encoder_layers:
            total += self.encoder_layers * (attn + dense_mlp + 2 * d)
            total += L * (2 * attn + dense_mlp + 3 * d)  # self+cross attn
            return total + 2 * d
        if self.moe_num_experts:
            total += L * (attn + moe_mlp + 2 * d)
            return total + d
        total += L * block_cost(True, False, False)
        return total + d

    def active_param_count(self) -> int:
        """Active-per-token params (MoE top-k) for MODEL_FLOPS = 6*N_active*D."""
        if not self.moe_num_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        expert = (3 if self.gated_mlp else 2) * d * ff
        inert = (self.moe_num_experts - self.moe_top_k) * expert
        n_moe_layers = (
            self.num_layers // max(self.moe_every, 1)
            if self.family != "hybrid"
            else self.num_layers // max(self.moe_every, 1)
        )
        return self.param_count() - n_moe_layers * inert

    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            num_layers=max(2, min(4, self.num_layers)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads // max(1, self.num_heads // 4))),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            moe_num_experts=8 if self.moe_num_experts else 0,
            moe_top_k=min(2, self.moe_top_k) if self.moe_top_k else 0,
            moe_num_shared=min(1, self.moe_num_shared),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            sliding_window=32 if self.sliding_window else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_frames=24 if self.encoder_layers else 1500,
            vision_patches=16,
            attn_every=4 if self.attn_every else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "deepseek_moe_16b",
    "olmoe_1b_7b",
    "whisper_large_v3",
    "smollm_360m",
    "granite_20b",
    "qwen25_14b",
    "gemma3_27b",
    "jamba_v01_52b",
    "qwen2_vl_7b",
    "mamba2_130m",
)

# canonical --arch spellings (hyphens) map to module names
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update(
    {
        "deepseek-moe-16b": "deepseek_moe_16b",
        "olmoe-1b-7b": "olmoe_1b_7b",
        "whisper-large-v3": "whisper_large_v3",
        "smollm-360m": "smollm_360m",
        "granite-20b": "granite_20b",
        "qwen2.5-14b": "qwen25_14b",
        "gemma3-27b": "gemma3_27b",
        "jamba-v0.1-52b": "jamba_v01_52b",
        "qwen2-vl-7b": "qwen2_vl_7b",
        "mamba2-130m": "mamba2_130m",
    }
)


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """The official (arch x shape) cells. long_500k only for sub-quadratic."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return tuple(names)


def all_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            yield arch, shape
