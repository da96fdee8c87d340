"""Gemma3-27B [hf:google/gemma-3; unverified] — 5:1 local:global sliding window, 128k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    sliding_window=1024,
    local_global_ratio=5,   # 5 local layers per 1 global
    rope_theta=1e6,
    act="gelu",
)
