"""OLMoE-1B-7B [arXiv:2409.02060; hf] — 64 experts, top-8, no shared experts."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    moe_num_experts=64,
    moe_top_k=8,
    rope_theta=1e4,
)
