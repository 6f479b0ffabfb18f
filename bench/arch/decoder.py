"""The dense and MoE decoder (olmoe-1b-7b, granite-8b): every layer is
attention, then a GLU or a GLU-MoE. Its weight layout and plain
reference are :mod:`bench.reference.decoder`."""
from __future__ import annotations

from bench.arch import put
from bench.counts.model import decode_flops, prefill_flops  # noqa: F401


def program_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig
    moe = bool(cfg.get("num_experts", 0))
    return ModelConfig(
        name=cfg["name"], family="moe" if moe else "dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        rope_theta=cfg["rope_theta"],
        num_experts=cfg.get("num_experts", 0),
        experts_per_token=cfg.get("num_experts_per_tok", 0),
        tie_embeddings=cfg["tie_word_embeddings"],
        vocab_pad_to=cfg["vocab_pad_to"], dtype=cfg["torch_dtype"])


def hand_in(params, w: dict, cfg: dict) -> None:
    """Copy the benchmark's weights into the program's, leaf by leaf."""
    put(params.tok.embed, w["embed"])
    if not cfg["tie_word_embeddings"]:
        put(params.tok.unembed, w["unembed"])
    put(params.ln_f.scale, w["ln_f"])
    moe = bool(cfg.get("num_experts", 0))
    for i, blk in enumerate(params.layers):
        put(blk.ln1.scale, w["ln1"][i])
        put(blk.ln2.scale, w["ln2"][i])
        for n in ("wq", "wk", "wv", "wo"):
            put(getattr(blk.attn, n), w[n][i])
        ffn = blk.moe if moe else blk.mlp
        for n in (("router",) if moe else ()) + ("w_gate", "w_up", "w_down"):
            put(getattr(ffn, n), w[n][i])


def attention_layers(cfg: dict) -> int:
    """Every layer runs K4 in a prefill and K5 in a decode step."""
    return cfg["num_hidden_layers"]
