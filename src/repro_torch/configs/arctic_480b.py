"""arctic-480b — 128-expert top-2 MoE + dense residual
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 with
a dense FFN residual branch in parallel (Arctic's dense-MoE hybrid).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    attention="full",
    num_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
    rope_theta=10_000.0,
)


def reduced(**kw):
    return CONFIG.reduced(**kw)
