"""The port's hybrid family (zamba2's stack as the port runs it): G
groups, each one application of ONE shared attention block, then
``attn_every`` Mamba-2 layers. Its weight layout and plain reference are
``bench/reference/hybrid.py``. K4 and K5 run in the shared block's G
applications only."""
from __future__ import annotations

from bench.arch import put


def program_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="hybrid",
        num_layers=cfg["num_hidden_layers"], attn_every=cfg["attn_every"],
        d_model=cfg["hidden_size"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        rope_theta=cfg["rope_theta"], ssm_state=cfg["mamba_d_state"],
        ssm_head_dim=cfg["mamba_headdim"], ssm_expand=cfg["mamba_expand"],
        conv_width=cfg["mamba_d_conv"],
        tie_embeddings=cfg["tie_word_embeddings"],
        vocab_pad_to=cfg["vocab_pad_to"], dtype=cfg["torch_dtype"])


#: a Mamba-2 layer's leaves, named as the program names its weights
MAMBA = ("in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
         "norm_scale", "out_proj")


def hand_in(params, w: dict, cfg: dict) -> None:
    """Copy the benchmark's weights into the program's, leaf by leaf."""
    put(params.tok.embed, w["embed"])
    if not cfg["tie_word_embeddings"]:
        put(params.tok.unembed, w["unembed"])
    put(params.ln_f.scale, w["ln_f"])
    shared = params.blocks.shared
    put(shared.fuse, w["s_fuse"])
    put(shared.ln1.scale, w["s_ln1"])
    put(shared.ln2.scale, w["s_ln2"])
    for n in ("wq", "wk", "wv", "wo"):
        put(getattr(shared.attn, n), w[n])
    for n in ("w_gate", "w_up", "w_down"):
        put(getattr(shared.mlp, n), w[n])
    K = cfg["attn_every"]
    for g, group in enumerate(params.blocks.mamba):
        for m, layer in enumerate(group):
            put(layer.ln.scale, w["m_ln"][g * K + m])
            for n in MAMBA:
                put(getattr(layer.mamba, n), w[n][g * K + m])


def attention_layers(cfg: dict) -> int:
    """The shared block's applications, one a group."""
    return cfg["num_hidden_layers"] // cfg["attn_every"]


def _shared_flops(cfg: dict) -> int:
    """One token through one application of the shared block's products
    (the 2D → D fuse, the projections, the GLU), scores excluded."""
    D, H, KH, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    return (2 * 2 * D * D + 2 * D * (H * hd + 2 * KH * hd)
            + 2 * H * hd * D + 6 * D * cfg["intermediate_size"])


def _mamba_flops(cfg: dict) -> int:
    """One token through one Mamba-2 layer: in and out projections, the
    depthwise conv, and the state's update and read (a multiply-add for
    each of its heads × head_dim × state entries, twice)."""
    D, N = cfg["hidden_size"], cfg["mamba_d_state"]
    di = cfg["mamba_expand"] * D
    heads = di // cfg["mamba_headdim"]
    return (2 * D * (2 * di + 2 * N + heads) + 2 * di * D
            + 2 * cfg["mamba_d_conv"] * (di + 2 * N) + 4 * di * N)


def prefill_flops(cfg: dict, S: int) -> int:
    H, hd = cfg["num_attention_heads"], cfg["head_dim"]
    attn = 4 * hd * H * (S * (S + 1) // 2)
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return (attention_layers(cfg) * (S * _shared_flops(cfg) + attn)
            + cfg["num_hidden_layers"] * S * _mamba_flops(cfg) + head)


def decode_flops(cfg: dict, lengths) -> int:
    """One decode step of the rows whose cache lengths (the new token
    included) are ``lengths``."""
    H, hd = cfg["num_attention_heads"], cfg["head_dim"]
    n = len(lengths)
    attn = 4 * hd * H * sum(lengths)
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return (attention_layers(cfg) * (n * _shared_flops(cfg) + attn)
            + cfg["num_hidden_layers"] * n * _mamba_flops(cfg) + n * head)
