"""Jamba-v0.1-52B [arXiv:2403.19887; hf] — Mamba+attention 1:7, MoE 16e top-2.

Period of 8 layers: 1 attention + 7 Mamba; MoE replaces the dense FFN on
every 2nd layer (16 MoE layers total).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    moe_num_experts=16,
    moe_top_k=2,
    moe_every=2,
    attn_every=8,          # 1 attention layer per period of 8
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
)
