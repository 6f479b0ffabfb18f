"""zamba2-2.7b — hybrid Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
A single SHARED attention+MLP block is applied every ``attn_every`` SSM
blocks (weights shared across applications; each application has its own
KV cache). Bounded state ⇒ runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    attention="full",
    attn_every=6,                # 9 shared-block applications over 54 SSM blocks
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    state_only=False,            # small attn caches exist (one per application)
)


def reduced(**kw):
    return CONFIG.reduced(**kw)
