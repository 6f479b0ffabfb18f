"""Backbones: the dense/MoE decoder (also the encoder-decoder's two
stacks, whose decoder blocks add cross attention), the RWKV-6 stack and
the hybrid Mamba-2 + shared-attention stack (zamba2), each with its
prefill/train stack and its one-token decode step.

Layers are an ``nn.ModuleList`` walked by a Python loop (the reference
scans stacked params; ``scan_layers`` only sizes its compiled program
and has no counterpart here). The stacks are the training forward too:
under autograd each block runs through :func:`remat`, the counterpart
of the reference's ``_remat`` (``cfg.remat`` "none", "full" or
"selective"), and :func:`decoder_stack` returns the MoE load-balance
loss summed over layers, as the reference's does. Decode steps update
their caches in place (the reference returns new ones); the stacks
write no state in place.
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.kvcache import write_slot
from repro_torch.models.layers import (GLUMLP, Norm, apply_norm, cdtype,
                                       dense_init, glu_mlp, merge_heads,
                                       split_heads)
from repro_torch.parallel.sharding import constrain


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


#: the products "selective" remat keeps: those without batch dimensions
#: (``x @ W`` lowers to ``mm``), as ``dots_with_no_batch_dims_saveable``
#: keeps them in the reference; batched products (``bmm``: the attention
#: scores, the MoE experts, RWKV-6's mix LoRA) are recomputed, as there
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat`` while autograd records: "none" keeps
    every activation; "full" keeps only ``fn``'s inputs and recomputes
    the rest in the backward pass; "selective" also keeps the outputs of
    the unbatched products (:data:`_SAVED_DOTS`). Recomputation gives
    the same numbers, so remat changes memory and time, not results."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat not in ("full", "selective"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    kw = {} if cfg.remat == "full" else {"context_fn": partial(
        create_selective_checkpoint_contexts, _dots_saveable)}
    return partial(checkpoint, fn, use_reentrant=False, **kw)


def _ffn(p: Block, x, cfg: ModelConfig):
    """Returns (y, aux): the MoE load-balance loss, or None."""
    if cfg.family == "moe":
        return moe_mod.moe_ffn(p.moe, x, cfg)
    return glu_mlp(p.mlp, x, cfg), None


def cross_kv(p_cross: attn.Attention, enc_out, cfg: ModelConfig):
    """The encoder output's cross K/V, each (B, Se, KH, hd) (no RoPE)."""
    dt = cdtype(cfg)
    KH, hd = cfg.num_kv_heads, cfg.head_dim
    return (split_heads(enc_out @ p_cross.wk.to(dt), KH, hd),
            split_heads(enc_out @ p_cross.wv.to(dt), KH, hd))


def block_fwd(p: Block, x, cfg: ModelConfig, positions, *, causal=True,
              enc_out=None):
    """One decoder block (train/prefill); with ``enc_out`` (B, Se, D) its
    queries also attend, non-causally, over the encoder's keys. Returns
    (x, (k, v), aux)."""
    # on a mesh the residual stream stays sharded over the batch (and,
    # with Megatron-SP, the sequence over "model"), as the reference's
    # blocks constrain it; a no-op on plain tensors
    sp = "model" if cfg.seq_parallel else None
    x = constrain(x, "batch", sp, None)
    a, (k, v) = attn.attention(p.attn, apply_norm(p.ln1, x, cfg), cfg,
                               positions, causal=causal)
    if cfg.bf16_reduce:
        a = constrain(a, "batch", sp, None)
    x = x + a
    if enc_out is not None:
        h = apply_norm(p.ln_cross, x, cfg)
        q, _, _ = attn.qkv_proj(p.cross, h, cfg, positions=None)
        ck, cv = cross_kv(p.cross, enc_out, cfg)
        o = attn.cross_attention(q, ck, cv, cfg)
        x = x + merge_heads(o) @ p.cross.wo.to(cdtype(cfg))
    f, aux = _ffn(p, apply_norm(p.ln2, x, cfg), cfg)
    if cfg.bf16_reduce:
        f = constrain(f, "batch", sp, None)
    return x + f, (k, v), aux


def decoder_stack(layers: nn.ModuleList, x, cfg: ModelConfig, positions, *,
                  causal=True, enc_out=None, collect_cache=False):
    """All layers in order (``enc_out``: see :func:`block_fwd`). Returns
    (x, (k, v) stacked over layers as (L, B, S, KH, hd), or None, the
    load-balance loss summed over layers)."""
    body = remat(partial(block_fwd, cfg=cfg, positions=positions,
                         causal=causal, enc_out=enc_out), cfg)
    ks, vs = [], []
    aux = x.new_zeros((), dtype=torch.float32)
    for p in layers:
        x, (k, v), aux_l = body(p, x)
        if aux_l is not None:
            aux = aux + aux_l
        if collect_cache:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, kv, aux


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
    # the mesh layouts of the dense decode (the reference passes them on
    # the dense and MoE decoders' self attention only)
    layout = {} if cross else {"partials": cfg.decode_partials,
                               "grouped": cfg.decode_grouped}
    if cross:       # made on the card: a host copy would stall each layer
        cross_len = torch.full((B,), cache["ck"].shape[2], dtype=torch.int32,
                               device=x.device)
    for i, p in enumerate(layers):
        kc, vc = cache["k"][i], cache["v"][i]
        hh = apply_norm(p.ln1, x, cfg)
        q, k, v = attn.qkv_proj(p.attn, hh, cfg, positions=pos[:, None])
        write_slot((kc, vc), k, v, slot)
        o = attn.decode_attention(q, kc, vc, cache_len, window=window,
                                  **layout)
        x = x + o.reshape(B, 1, cfg.q_dim) @ p.attn.wo.to(dt)
        if cross:
            hc = apply_norm(p.ln_cross, x, cfg)
            qc, _, _ = attn.qkv_proj(p.cross, hc, cfg, positions=None)
            oc = attn.decode_attention(qc, cache["ck"][i], cache["cv"][i],
                                       cross_len)
            x = x + oc.reshape(B, 1, cfg.q_dim) @ p.cross.wo.to(dt)
        x = x + _ffn(p, apply_norm(p.ln2, x, cfg), cfg)[0]
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


def _rwkv_layer(p: RwkvBlock, x, st_a, st_f, cfg: ModelConfig):
    """One RWKV-6 layer from its states (or None): (x, ((att_x, att_s),
    ffn_x))."""
    a, st_a = rwkv.time_mix(p.att, apply_norm(p.ln1, x, cfg), cfg,
                            state=st_a)
    x = x + a
    f, st_f = rwkv.channel_mix(p.ffn, apply_norm(p.ln2, x, cfg), cfg,
                               state=st_f)
    return x + f, (st_a, st_f)


def rwkv_stack(layers: nn.ModuleList, x, cfg: ModelConfig, state=None,
               collect_state=False):
    """All layers in order. state: {"att_x", "att_s", "ffn_x"} stacked
    over layers, or None (zeros). Returns (x, the final states stacked
    the same way, or None)."""
    body = remat(partial(_rwkv_layer, cfg=cfg), cfg)
    outs = {"att_x": [], "att_s": [], "ffn_x": []}
    for i, p in enumerate(layers):
        st_a, st_f = (None, None) if state is None else (
            (state["att_x"][i], state["att_s"][i]), state["ffn_x"][i])
        x, ((ax, as_), fx) = body(p, x, st_a, st_f)
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
    y, (k, v), _ = block_fwd(shared, fused, cfg, positions)
    return x + y, (k, v)


def _hybrid_group(group: nn.ModuleList, x, shared: Block, x0,
                  cfg: ModelConfig, positions):
    """One group: the shared block, then its Mamba-2 layers. Returns (x,
    (k, v, conv states (K,B,W-1,C), SSM states (K,B,H,P,N)))."""
    x, (k, v) = _shared_block(shared, x, x0, cfg, positions)
    convs, ssms = [], []
    for pm in group:
        y, (cs, ss) = m2.mamba2_block(pm.mamba, apply_norm(pm.ln, x, cfg),
                                      cfg)
        x = x + y
        convs.append(cs)
        ssms.append(ss)
    return x, (k, v, torch.stack(convs), torch.stack(ssms))


def hybrid_stack(blocks: HybridBlocks, x, cfg: ModelConfig, positions,
                 collect=False):
    """Returns (x, {"attn_k", "attn_v": (G,B,S,KH,hd), "conv":
    (G,K,B,W-1,C), "ssm": (G,K,B,H,P,N)} or None)."""
    body = remat(partial(_hybrid_group, shared=blocks.shared, x0=x,
                         cfg=cfg, positions=positions), cfg)
    outs = {"attn_k": [], "attn_v": [], "conv": [], "ssm": []}
    for group in blocks.mamba:
        x, sts = body(group, x)
        if collect:
            for key, t in zip(outs, sts):
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
        f = _ffn(shared, apply_norm(shared.ln2, y, cfg), cfg)[0]
        x = x + (y + f)
        for m, pm in enumerate(group):
            y2, (cs, ss) = m2.mamba2_step(
                pm.mamba, apply_norm(pm.ln, x[:, 0], cfg), cfg,
                (cache["conv"][g, m], cache["ssm"][g, m]))
            x = x + y2[:, None]
            cache["conv"][g, m] = cs
            cache["ssm"][g, m] = ss
    return x, cache
