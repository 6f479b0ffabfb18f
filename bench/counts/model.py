"""Model FLOPs a serving step's tokens need (dense or MoE decoder).

Attention is counted at the actual lengths, MoE at the active experts
only, and the output head once per produced token (prefill needs the
last position's logits, decode each row's)."""


def _layer_linear_flops(cfg: dict) -> int:
    """FLOPs of one token through one layer's products, attention scores
    excluded."""
    D, H, KH, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    F = cfg["intermediate_size"]
    proj = 2 * D * (H * hd + 2 * KH * hd) + 2 * H * hd * D
    E = cfg.get("num_experts", 0)
    if E:
        ffn = 2 * D * E + 6 * cfg["num_experts_per_tok"] * D * F
    else:
        ffn = 6 * D * F
    return proj + ffn


def prefill_flops(cfg: dict, S: int) -> int:
    L, H, hd = (cfg["num_hidden_layers"], cfg["num_attention_heads"],
                cfg["head_dim"])
    attn = 4 * hd * H * (S * (S + 1) // 2)
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return L * (S * _layer_linear_flops(cfg) + attn) + head


def decode_flops(cfg: dict, lengths) -> int:
    """One decode step of the rows whose cache lengths (the new token
    included) are ``lengths``."""
    L, H, hd = (cfg["num_hidden_layers"], cfg["num_attention_heads"],
                cfg["head_dim"])
    n = len(lengths)
    attn = 4 * hd * H * sum(lengths)
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return L * (n * _layer_linear_flops(cfg) + attn) + n * head
