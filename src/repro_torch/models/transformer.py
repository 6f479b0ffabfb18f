"""The dense decoder backbone: blocks, the prefill stack and the
one-token decode step.

Layers are an ``nn.ModuleList`` walked by a Python loop (the reference
scans stacked params; its ``remat`` and ``scan_layers`` knobs are for
training and compile size, and have no counterpart in this inference
path). The MoE FFN, cross attention and the other families' stacks come
with their models.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.kvcache import write_slot
from repro_torch.models.layers import GLUMLP, Norm, apply_norm, cdtype, glu_mlp


class Block(nn.Module):
    """One dense decoder block's weights (the reference's
    ``block_params``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(f"{cfg.family} blocks: slice 3")
        self.ln1 = Norm(cfg, device)
        self.attn = attn.Attention(cfg, gen, device)
        self.ln2 = Norm(cfg, device)
        self.mlp = GLUMLP(cfg, gen, device)


def _ffn(p: Block, x, cfg: ModelConfig):
    return glu_mlp(p.mlp, x, cfg)


def block_fwd(p: Block, x, cfg: ModelConfig, positions, *, causal=True):
    """One decoder block (prefill). Returns (x, (k, v))."""
    a, (k, v) = attn.attention(p.attn, apply_norm(p.ln1, x, cfg), cfg,
                               positions, causal=causal)
    x = x + a
    x = x + _ffn(p, apply_norm(p.ln2, x, cfg), cfg)
    return x, (k, v)


def decoder_stack(layers: nn.ModuleList, x, cfg: ModelConfig, positions, *,
                  causal=True, collect_cache=False):
    """All layers in order. Returns (x, (k, v) stacked over layers as
    (L, B, S, KH, hd), or None)."""
    ks, vs = [], []
    for p in layers:
        x, (k, v) = block_fwd(p, x, cfg, positions, causal=causal)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, kv


def decode_step_stack(layers: nn.ModuleList, x, cfg: ModelConfig, cache,
                      pos):
    """One-token decode through all layers.

    x (B,1,D); cache {"k","v"}: (L,B,S,KH,hd), written in place at each
    row's slot; pos (B,) int — index of the new token. Returns
    (x, cache)."""
    window = cfg.window if cfg.attention == "swa" else 0
    slot = pos % window if window else pos
    cache_len = torch.clamp(pos + 1, max=window) if window else pos + 1
    dt = cdtype(cfg)
    B = x.shape[0]
    for i, p in enumerate(layers):
        kc, vc = cache["k"][i], cache["v"][i]
        hh = apply_norm(p.ln1, x, cfg)
        q, k, v = attn.qkv_proj(p.attn, hh, cfg, positions=pos[:, None])
        write_slot((kc, vc), k, v, slot)
        o = attn.decode_attention(q, kc, vc, cache_len, window=window)
        x = x + o.reshape(B, 1, cfg.q_dim) @ p.attn.wo.to(dt)
        x = x + _ffn(p, apply_norm(p.ln2, x, cfg), cfg)
    return x, cache
