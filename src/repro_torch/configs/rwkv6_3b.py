"""rwkv6-3b — Finch: attention-free, data-dependent decay [arXiv:2404.05892].

32L d_model=2560 d_ff=8960 vocab=65536. Linear-state cache (state_only):
its DYVERSE quota is batch slots only — state does not grow with context.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv6",
    num_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65536,
    attention="none",
    rwkv_head_size=64,
    rwkv_lora_decay=64,
    rwkv_lora_mix=32,
    norm="layernorm",
    act="silu",
    state_only=True,
)


def reduced(**kw):
    return CONFIG.reduced(**kw)
