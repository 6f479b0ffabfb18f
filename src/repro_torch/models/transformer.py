"""Backbones: the dense/MoE decoder (also the encoder-decoder's two
stacks, whose decoder blocks add cross attention), the RWKV-6 stack and
the hybrid Mamba-2 + shared-attention stack (zamba2), each with its
prefill stack and its one-token decode step.

Layers are an ``nn.ModuleList`` walked by a Python loop (the reference
scans stacked params; its ``remat`` and ``scan_layers`` knobs are for
training and compile size, and have no counterpart in this inference
path). Decode steps update their caches in place (the reference
returns new ones). The MoE load-balance loss is dropped in these
inference stacks (:func:`repro_torch.models.moe.moe_ffn` returns it).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.kvcache import write_slot
from repro_torch.models.layers import (GLUMLP, Norm, apply_norm, cdtype,
                                       dense_init, glu_mlp)


class Block(nn.Module):
    """One decoder block's weights (the reference's ``block_params``):
    self attention, then with ``cross`` a cross-attention sub-block
    (``ln_cross``, ``cross``), then the FFN — ``moe`` for the MoE
    family, else ``mlp``. The dense, MoE and encoder-decoder layers and
    the hybrid family's shared block."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device,
                 cross: bool = False):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.attn = attn.Attention(cfg, gen, device)
        self.ln2 = Norm(cfg, device)
        if cross:
            self.ln_cross = Norm(cfg, device)
            self.cross = attn.Attention(cfg, gen, device)
        if cfg.family == "moe":
            self.moe = moe_mod.MoE(cfg, gen, device)
        else:
            self.mlp = GLUMLP(cfg, gen, device)


def _ffn(p: Block, x, cfg: ModelConfig):
    if cfg.family == "moe":
        return moe_mod.moe_ffn(p.moe, x, cfg)[0]
    return glu_mlp(p.mlp, x, cfg)


def cross_kv(p_cross: attn.Attention, enc_out, cfg: ModelConfig):
    """The encoder output's cross K/V, each (B, Se, KH, hd) (no RoPE)."""
    dt = cdtype(cfg)
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.num_kv_heads, cfg.head_dim)
    return ((enc_out @ p_cross.wk.to(dt)).reshape(shape),
            (enc_out @ p_cross.wv.to(dt)).reshape(shape))


def block_fwd(p: Block, x, cfg: ModelConfig, positions, *, causal=True,
              enc_out=None):
    """One decoder block (prefill); with ``enc_out`` (B, Se, D) its
    queries also attend, non-causally, over the encoder's keys. Returns
    (x, (k, v))."""
    a, (k, v) = attn.attention(p.attn, apply_norm(p.ln1, x, cfg), cfg,
                               positions, causal=causal)
    x = x + a
    if enc_out is not None:
        h = apply_norm(p.ln_cross, x, cfg)
        q, _, _ = attn.qkv_proj(p.cross, h, cfg, positions=None)
        ck, cv = cross_kv(p.cross, enc_out, cfg)
        o = attn.cross_attention(q, ck, cv, cfg)
        B, S = x.shape[:2]
        x = x + o.reshape(B, S, cfg.q_dim) @ p.cross.wo.to(cdtype(cfg))
    x = x + _ffn(p, apply_norm(p.ln2, x, cfg), cfg)
    return x, (k, v)


def decoder_stack(layers: nn.ModuleList, x, cfg: ModelConfig, positions, *,
                  causal=True, enc_out=None, collect_cache=False):
    """All layers in order (``enc_out``: see :func:`block_fwd`). Returns
    (x, (k, v) stacked over layers as (L, B, S, KH, hd), or None)."""
    ks, vs = [], []
    for p in layers:
        x, (k, v) = block_fwd(p, x, cfg, positions, causal=causal,
                              enc_out=enc_out)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, kv


def decode_step_stack(layers: nn.ModuleList, x, cfg: ModelConfig, cache,
                      pos):
    """One-token decode through all layers.

    x (B,1,D); cache {"k","v"}: (L,B,S,KH,hd), written in place at each
    row's slot; pos (B,) int — index of the new token. An
    encoder-decoder's cache also holds the cross K/V {"ck","cv"}:
    (L,B,Se,KH,hd), which each layer's cross attention reads whole —
    all Se slots, the zero padding past the prefill's encoder length
    included, as the reference does. Returns (x, cache)."""
    window = cfg.window if cfg.attention == "swa" else 0
    slot = pos % window if window else pos
    cache_len = torch.clamp(pos + 1, max=window) if window else pos + 1
    dt = cdtype(cfg)
    B = x.shape[0]
    cross = "ck" in cache
    if cross:       # made on the card: a host copy would stall each layer
        cross_len = torch.full((B,), cache["ck"].shape[2], dtype=torch.int32,
                               device=x.device)
    for i, p in enumerate(layers):
        kc, vc = cache["k"][i], cache["v"][i]
        hh = apply_norm(p.ln1, x, cfg)
        q, k, v = attn.qkv_proj(p.attn, hh, cfg, positions=pos[:, None])
        write_slot((kc, vc), k, v, slot)
        o = attn.decode_attention(q, kc, vc, cache_len, window=window)
        x = x + o.reshape(B, 1, cfg.q_dim) @ p.attn.wo.to(dt)
        if cross:
            hc = apply_norm(p.ln_cross, x, cfg)
            qc, _, _ = attn.qkv_proj(p.cross, hc, cfg, positions=None)
            oc = attn.decode_attention(qc, cache["ck"][i], cache["cv"][i],
                                       cross_len)
            x = x + oc.reshape(B, 1, cfg.q_dim) @ p.cross.wo.to(dt)
        x = x + _ffn(p, apply_norm(p.ln2, x, cfg), cfg)
    return x, cache


# ------------------------------------------------------------ rwkv6
class RwkvBlock(nn.Module):
    """The reference's ``rwkv_block_params``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.att = rwkv.TimeMix(cfg, gen, device)
        self.ln2 = Norm(cfg, device)
        self.ffn = rwkv.ChannelMix(cfg, gen, device)


def rwkv_stack(layers: nn.ModuleList, x, cfg: ModelConfig, state=None,
               collect_state=False):
    """All layers in order. state: {"att_x", "att_s", "ffn_x"} stacked
    over layers, or None (zeros). Returns (x, the final states stacked
    the same way, or None)."""
    outs = {"att_x": [], "att_s": [], "ffn_x": []}
    for i, p in enumerate(layers):
        st_a = None if state is None else (state["att_x"][i],
                                          state["att_s"][i])
        a, (ax, as_) = rwkv.time_mix(p.att, apply_norm(p.ln1, x, cfg), cfg,
                                     state=st_a)
        x = x + a
        f, fx = rwkv.channel_mix(p.ffn, apply_norm(p.ln2, x, cfg), cfg,
                                 state=None if state is None
                                 else state["ffn_x"][i])
        x = x + f
        if collect_state:
            for k, t in (("att_x", ax), ("att_s", as_), ("ffn_x", fx)):
                outs[k].append(t)
    states = ({k: torch.stack(v) for k, v in outs.items()}
              if collect_state else None)
    return x, states


def rwkv_decode_step(layers: nn.ModuleList, x, cfg: ModelConfig, state):
    """x (B,D); state {"att_x", "att_s", "ffn_x"} stacked per layer,
    written in place (cast to each cache's dtype). Returns (x, state)."""
    for i, p in enumerate(layers):
        a, (ax, as_) = rwkv.time_mix_step(
            p.att, apply_norm(p.ln1, x, cfg), cfg,
            (state["att_x"][i], state["att_s"][i]))
        x = x + a
        f, fx = rwkv.channel_mix_step(p.ffn, apply_norm(p.ln2, x, cfg), cfg,
                                      state["ffn_x"][i])
        x = x + f
        state["att_x"][i] = ax
        state["att_s"][i] = as_
        state["ffn_x"][i] = fx
    return x, state


# ------------------------------------------------------------ hybrid (zamba2)
class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.ln = Norm(cfg, device)
        self.mamba = m2.Mamba2(cfg, gen, device)


class HybridBlocks(nn.Module):
    """The reference's ``hybrid_params``: G groups, each one application
    of the ONE shared attention block (with ``fuse``, 2D → D) followed by
    ``attn_every`` (norm, Mamba-2) layers."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        if cfg.num_layers % cfg.attn_every:
            raise ValueError(f"num_layers {cfg.num_layers} is not a "
                             f"multiple of attn_every {cfg.attn_every}")
        G = cfg.num_layers // cfg.attn_every
        self.shared = Block(cfg, gen, device)
        self.shared.fuse = dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                      cdtype(cfg), device)
        self.mamba = nn.ModuleList(
            nn.ModuleList(MambaLayer(cfg, gen, device)
                          for _ in range(cfg.attn_every))
            for _ in range(G))


def _shared_block(shared: Block, x, x0, cfg: ModelConfig, positions):
    fused = torch.cat([x, x0], dim=-1) @ shared.fuse.to(cdtype(cfg))
    y, (k, v) = block_fwd(shared, fused, cfg, positions)
    return x + y, (k, v)


def hybrid_stack(blocks: HybridBlocks, x, cfg: ModelConfig, positions,
                 collect=False):
    """Returns (x, {"attn_k", "attn_v": (G,B,S,KH,hd), "conv":
    (G,K,B,W-1,C), "ssm": (G,K,B,H,P,N)} or None)."""
    x0 = x
    outs = {"attn_k": [], "attn_v": [], "conv": [], "ssm": []}
    for group in blocks.mamba:
        x, (k, v) = _shared_block(blocks.shared, x, x0, cfg, positions)
        convs, ssms = [], []
        for pm in group:
            y, (cs, ss) = m2.mamba2_block(pm.mamba, apply_norm(pm.ln, x, cfg),
                                          cfg)
            x = x + y
            convs.append(cs)
            ssms.append(ss)
        if collect:
            for key, t in (("attn_k", k), ("attn_v", v),
                           ("conv", torch.stack(convs)),
                           ("ssm", torch.stack(ssms))):
                outs[key].append(t)
    sts = {k: torch.stack(v) for k, v in outs.items()} if collect else None
    return x, sts


def hybrid_decode_step(blocks: HybridBlocks, x, cfg: ModelConfig, cache,
                       pos):
    """x (B,1,D); cache per group: attn k/v (G,B,S,KH,hd), conv
    (G,K,B,W-1,C), ssm (G,K,B,H,P,N), all written in place; pos (B,) —
    the new token's index. Returns (x, cache)."""
    x0 = x
    dt = cdtype(cfg)
    B = x.shape[0]
    shared = blocks.shared
    for g, group in enumerate(blocks.mamba):
        kc, vc = cache["attn_k"][g], cache["attn_v"][g]
        fused = torch.cat([x, x0], dim=-1) @ shared.fuse.to(dt)
        hh = apply_norm(shared.ln1, fused, cfg)
        q, k, v = attn.qkv_proj(shared.attn, hh, cfg, positions=pos[:, None])
        write_slot((kc, vc), k, v, pos)
        o = attn.decode_attention(q, kc, vc, pos + 1)
        y = fused + o.reshape(B, 1, cfg.q_dim) @ shared.attn.wo.to(dt)
        f = _ffn(shared, apply_norm(shared.ln2, y, cfg), cfg)
        x = x + (y + f)
        for m, pm in enumerate(group):
            y2, (cs, ss) = m2.mamba2_step(
                pm.mamba, apply_norm(pm.ln, x[:, 0], cfg), cfg,
                (cache["conv"][g, m], cache["ssm"][g, m]))
            x = x + y2[:, None]
            cache["conv"][g, m] = cs
            cache["ssm"][g, m] = ss
    return x, cache
