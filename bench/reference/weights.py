"""The benchmark's weights: made on the device from a seed, in bf16,
in the benchmark's own layout (every leaf stacked over layers), a few
large draws a model. Both the program and the reference are given them.

Scales: matrices N(0, 1/fan_in), the router and the embeddings N(0,
0.02²), norm gains 1 + N(0, 0.1²) (the gain is stored as the offset from
1, as the program stores it)."""
from __future__ import annotations

import torch


def padded_vocab(cfg: dict) -> int:
    m = cfg["vocab_pad_to"]
    return (cfg["vocab_size"] + m - 1) // m * m


def leaves(cfg: dict) -> list[tuple[str, tuple, float]]:
    """(name, shape, scale) of every leaf, in the order they are drawn."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, KH, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    F, V = cfg["intermediate_size"], padded_vocab(cfg)
    out = [("embed", (V, D), 0.02)]
    if not cfg["tie_word_embeddings"]:
        out.append(("unembed", (D, V), 0.02))
    out += [("ln_f", (D,), 0.1), ("ln1", (L, D), 0.1), ("ln2", (L, D), 0.1),
            ("wq", (L, D, H * hd), D ** -0.5),
            ("wk", (L, D, KH * hd), D ** -0.5),
            ("wv", (L, D, KH * hd), D ** -0.5),
            ("wo", (L, H * hd, D), (H * hd) ** -0.5)]
    E = cfg.get("num_experts", 0)
    if E:
        out += [("router", (L, D, E), 0.02),
                ("w_gate", (L, E, D, F), D ** -0.5),
                ("w_up", (L, E, D, F), D ** -0.5),
                ("w_down", (L, E, F, D), F ** -0.5)]
    else:
        out += [("w_gate", (L, D, F), D ** -0.5),
                ("w_up", (L, D, F), D ** -0.5),
                ("w_down", (L, F, D), F ** -0.5)]
    return out


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf drawn from ``seed`` on ``device`` in bf16: the same seed
    on the same device gives the same weights."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = {}
    for name, shape, scale in leaves(cfg):
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.bfloat16)
        w[name] = t.mul_(scale)
    return w
