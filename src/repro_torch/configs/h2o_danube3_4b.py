"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]. 24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.

SWA bounds the KV cache to ``window`` ⇒ runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    attention="swa",
    window=4096,
    rope_theta=10_000.0,
)


def reduced(**kw):
    return CONFIG.reduced(**kw)
