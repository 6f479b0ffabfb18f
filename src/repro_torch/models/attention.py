"""Attention: GQA, chunked online-softmax prefill, exact banded
sliding-window attention, and decode attention over dense caches.

Routes, by the device of the tensors (the port's rule, as in
:mod:`repro_torch.kernels.fleet`) and by whether autograd records:

* prefill, :func:`attention` — on CUDA the flash kernel K4
  (:func:`repro_torch.kernels.attention.flash_attention`), with the
  window when the config is ``swa``; on the CPU, and wherever autograd
  records (training: K4 is forward-only), :func:`swa_attention` or
  :func:`chunked_attention`, the reference's own non-Pallas path;
* cross attention (the encoder-decoder's), :func:`cross_attention` —
  non-causal, the decoder's S queries over the encoder's Se keys: on
  CUDA K4 with ``causal=False``; on the CPU and under autograd the
  reference's :func:`chunked_attention`;
* decode, :func:`decode_attention` — always the paged kernel K5 over the
  dense cache seen as a page pool with the identity page table (slot b
  owns pages b·Smax/page … (b+1)·Smax/page − 1, ``lengths = cache_len``);
  on the CPU its wrapper runs the plain gather-and-softmax version.

``cfg.use_pallas`` keeps its field but has no card counterpart: the
kernels are the port's only device path. Of the reference's sharding
``constrain`` calls the port keeps the one on the queries (heads over
"model", batch over the data axes); the others pin the layout of its
scan's carries, which the port's loop does not have. Its
``partials``/``grouped`` decode layouts are single-card no-ops here;
they compute the same function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import attention as kern
from repro_torch.models.layers import (apply_rope, cdtype, dense_init,
                                       recording, rope_angles)
from repro_torch.parallel.sharding import constrain

NEG_INF = -1e30


class Attention(nn.Module):
    """The projections ``wq``, ``wk``, ``wv``, ``wo`` (the reference's
    ``attn_params``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = cdtype(cfg)
        self.wq = dense_init(gen, cfg.d_model, cfg.q_dim, dt, device)
        self.wk = dense_init(gen, cfg.d_model, cfg.kv_dim, dt, device)
        self.wv = dense_init(gen, cfg.d_model, cfg.kv_dim, dt, device)
        self.wo = dense_init(gen, cfg.q_dim, cfg.d_model, dt, device)


def qkv_proj(p: Attention, x, cfg: ModelConfig, positions=None):
    """x (B,S,D) → q (B,S,H,hd), k/v (B,S,KH,hd) with RoPE applied."""
    dt = cdtype(cfg)
    B, S, _ = x.shape
    q = (x @ p.wq.to(dt)).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ p.wk.to(dt)).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p.wv.to(dt)).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.rope_theta > 0 and positions is not None:
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = constrain(q, "batch", None, "model", None)
    return q, k, v


def repeat_kv(k, num_heads: int):
    """(B,S,KH,D) → (B,S,H,D) broadcast across the group dim."""
    B, S, KH, D = k.shape
    G = num_heads // KH
    if G == 1:
        return k
    return k[:, :, :, None].expand(B, S, KH, G, D).reshape(B, S, num_heads, D)


def chunked_attention(q, k, v, *, causal: bool = True, chunk: int = 1024,
                      bf16_probs: bool = False):
    """Online-softmax attention over KV chunks. q (B,Sq,H,D), k/v
    (B,Sk,KH,D). Returns (B,Sq,H,D). Live buffers O(B·H·Sq·chunk)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k = repeat_kv(k, H)
    v = repeat_kv(v, H)
    chunk = min(chunk, Sk)
    scale = D ** -0.5
    qf = q.float() * scale
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        k_pos = c0 + torch.arange(kb.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float())
        if causal:
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = p.to(torch.bfloat16) if bf16_probs else p
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", pv, vb.to(pv.dtype)).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)              # (B,Sq,H,D)


def swa_attention(q, k, v, *, window: int):
    """Exact sliding-window attention (token t sees [t-window+1, t]) via
    banded blocks: each w-sized query block attends to itself + the
    previous block. Compute O(S·2w)."""
    B, S, H, D = q.shape
    w = window
    if S <= w:  # degenerate: plain causal attention
        return chunked_attention(q, k, v, causal=True, chunk=min(w, 1024))
    if S % w:  # pad tail; padded keys sit after all real queries → masked
        pad = w - S % w
        pw = (0, 0, 0, 0, 0, pad)
        out = swa_attention(F.pad(q, pw), F.pad(k, pw), F.pad(v, pw),
                            window=w)
        return out[:, :S]
    k = repeat_kv(k, H)
    v = repeat_kv(v, H)
    nb = S // w
    qb = q.reshape(B, nb, w, H, D).float() * D ** -0.5
    kb = k.reshape(B, nb, w, H, D)
    vb = v.reshape(B, nb, w, H, D)
    # previous block (block 0's previous is zeros, masked out)
    k_prev = F.pad(kb[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0))
    v_prev = F.pad(vb[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0))
    kc = torch.cat([k_prev, kb], dim=2)          # (B,nb,2w,H,D)
    vc = torch.cat([v_prev, vb], dim=2)
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qb, kc.float())
    # q global pos = n*w + i ; k global pos = (n-1)*w + j  (j in [0,2w))
    i = torch.arange(w, device=q.device)[:, None]
    j = torch.arange(2 * w, device=q.device)[None, :]
    delta = (i + w) - j                          # q_pos - k_pos
    mask = (delta >= 0) & (delta < w)
    full_mask = mask[None].expand(nb, w, 2 * w).clone()
    full_mask[0] = mask & (j >= w)               # block 0 has no previous
    s = torch.where(full_mask[None, :, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", p, vc.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """Single-token decode through the paged kernel K5. q (B,1,H,D);
    caches (B,Smax,KH,D); cache_len (B,) or scalar — number of valid
    positions (the new token's K/V already written at cache_len-1). For
    SWA the cache is a ring buffer whose valid slots are
    [0, cache_len), so ``window`` changes nothing here."""
    B, Smax = k_cache.shape[:2]
    k_pool, page = kern.dense_cache_pages(k_cache)
    v_pool, _ = kern.dense_cache_pages(v_cache)
    table = kern.identity_page_table(B, Smax, page, k_cache.device)
    lengths = torch.as_tensor(cache_len, device=k_cache.device).to(
        torch.int32).reshape(-1).expand(B).contiguous()
    out = kern.paged_attention(q[:, 0].contiguous(), k_pool, v_pool, table,
                               lengths)
    return out[:, None]


def full_attention_reference(q, k, v, *, causal=True, window: int = 0):
    """O(S²) reference used only in tests (small shapes)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k = repeat_kv(k, H)
    v = repeat_kv(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * D ** -0.5, k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return out.transpose(1, 2).to(q.dtype)


def cross_attention(q, k, v, cfg: ModelConfig):
    """Non-causal attention of q (B, S, H, hd) over the encoder's k/v
    (B, Se, KH, hd). The reference's cross attention takes its default
    f32 probabilities, whatever ``attn_bf16_probs`` says."""
    if q.is_cuda and not recording(q, k, v):
        return kern.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2),
                                    causal=False).transpose(1, 2)
    return chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)


def attention(p: Attention, x, cfg: ModelConfig, positions, *, causal=True):
    """Full attention block for prefill. Returns (out, (k, v))."""
    q, k, v = qkv_proj(p, x, cfg, positions)
    window = cfg.window if cfg.attention == "swa" else 0
    if q.is_cuda and not recording(q, k, v):
        o = kern.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window).transpose(1, 2)
    elif window:
        o = swa_attention(q, k, v, window=window)
    else:
        o = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                              bf16_probs=cfg.attn_bf16_probs)
    B, S = q.shape[:2]
    out = o.reshape(B, S, cfg.q_dim) @ p.wo.to(cdtype(cfg))
    return out, (k, v)
