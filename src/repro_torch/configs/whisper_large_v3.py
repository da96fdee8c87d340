"""Whisper large-v3 [arXiv:2212.04356; unverified] — enc-dec; conv frontend stubbed.

The modality frontend (log-mel + conv downsampling) is a STUB: input_specs()
provides precomputed frame embeddings (B, 1500, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,           # decoder layers
    encoder_layers=32,
    encoder_frames=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    act="gelu",
    norm="layernorm",
    gated_mlp=False,
)
