"""olmoe-1b-7b — 64-expert top-8 MoE [arXiv:2409.02060].

16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304, MoE 64e top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    attention="full",
    num_experts=64,
    experts_per_token=8,
    rope_theta=10_000.0,
)


def reduced(**kw):
    return CONFIG.reduced(**kw)
