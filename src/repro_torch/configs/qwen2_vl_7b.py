"""Qwen2-VL-7B [arXiv:2409.12191; hf] — M-RoPE; vision frontend stubbed.

The dynamic-resolution ViT frontend is a STUB: input_specs() provides
precomputed patch embeddings prepended to the token sequence; M-RoPE position
ids (temporal/height/width) arrive as inputs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    mrope=True,
    vision_patches=1024,
    rope_theta=1e6,
)
