"""llava-next-34b — VLM backbone, anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. The vision tower
+ anyres tiling frontend is a STUB: ``input_specs()`` provides merged
(patch ++ text) embeddings of shape (B, S, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    attention="full",
    frontend="vision",
    rope_theta=1_000_000.0,
)


def reduced(**kw):
    return CONFIG.reduced(**kw)
