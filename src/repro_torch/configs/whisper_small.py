"""whisper-small — encoder-decoder ASR backbone [arXiv:2212.04356].

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865. The conv frontend is a
STUB: ``input_specs()`` provides precomputed frame embeddings
(B, seq//encoder_seq_ratio, d_model). Full attention ⇒ long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,               # decoder layers
    num_encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    attention="full",
    is_encoder_decoder=True,
    encoder_seq_ratio=4,         # conv-frontend downsampling of the frame axis
    frontend="audio",
    norm="layernorm",
    act="gelu",
)


def reduced(**kw):
    return CONFIG.reduced(**kw)
