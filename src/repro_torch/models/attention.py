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
* decode, :func:`decode_attention` — the paged kernel K5 over the
  dense cache seen as a page pool with the identity page table (slot b
  owns pages b·Smax/page … (b+1)·Smax/page − 1, ``lengths = cache_len``);
  on the CPU its wrapper runs the plain gather-and-softmax version. On
  a mesh (DTensor caches) :func:`dense_decode_attention`, the
  reference's dense decode with its two sharded layouts.

``cfg.use_pallas`` keeps its field but has no card counterpart: the
kernels are the port's only device path. Of the reference's sharding
``constrain`` calls the port keeps the one on the queries (heads over
"model", batch over the data axes); the others pin the layout of its
scan's carries, which the port's loop does not have. On a mesh the
attention itself runs on each rank's shards (:func:`_on_shards`,
:func:`_dense_decode_on_shards`), as GSPMD partitions it. The
reference's ``partials``/``grouped`` decode layouts shape the dense
decode there; on one card K5 reads the cache at its native KH width,
one split per page range, whatever they say.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import attention as kern
from repro_torch.models.layers import (apply_rope, cdtype, dense_init,
                                       merge_heads, recording, rope_angles,
                                       split_heads)
from repro_torch.parallel.sharding import (constrain, is_dtensor,
                                           replicated_like, shard_offset)

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
    q = split_heads(x @ p.wq.to(dt), cfg.num_heads, cfg.head_dim)
    k = split_heads(x @ p.wk.to(dt), cfg.num_kv_heads, cfg.head_dim)
    v = split_heads(x @ p.wv.to(dt), cfg.num_kv_heads, cfg.head_dim)
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


def _on_shards(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (q (B,Sq,H,D), k/v (B,Sk,KH,D)); on DTensors,
    on each rank's shards. Attention is independent across the batch and
    the heads, over which alone the mesh splits q (its heads over "model"
    where that axis divides them, :func:`qkv_proj`), so each rank runs
    it as one card does, with no collective and none of the batched
    products DTensor would flatten across two sharded dims. k and v take
    q's batch placement, and its head split where the axis divides their
    heads; else they come whole and the rank takes the repeated heads its
    queries need. The output takes q's placements."""
    if not is_dtensor(q):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, pl = q.device_mesh, q.placements
    H, KH = q.shape[2], k.shape[2]
    kv_pl = [Replicate() if isinstance(p, Shard) and p.dim == 2
             and KH % mesh.shape[i] else p for i, p in enumerate(pl)]
    # whole keys serve a rank's share of the queries' heads: their
    # gradient there is a part, summed over the ranks that split them
    kv_grad = [Partial() if kp != p else kp for kp, p in zip(kv_pl, pl)]

    def local(t):
        if not is_dtensor(t):
            t = replicated_like(t, q)
        return t.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    ql, kl, vl = q.to_local(), local(k), local(v)
    if list(kv_pl) != list(pl):         # the keys whole, the queries split
        h = ql.shape[2]
        off = shard_offset(q, 2)
        kl = repeat_kv(kl, H)[:, :, off:off + h]
        vl = repeat_kv(vl, H)[:, :, off:off + h]
    return DTensor.from_local(fn(ql, kl, vl, **kw), mesh, pl,
                              run_check=False)


def chunked_attention(q, k, v, *, causal: bool = True, chunk: int = 1024,
                      bf16_probs: bool = False):
    """Online-softmax attention over KV chunks. q (B,Sq,H,D), k/v
    (B,Sk,KH,D). Returns (B,Sq,H,D). Live buffers O(B·H·Sq·chunk)."""
    if is_dtensor(q):
        return _on_shards(chunked_attention, q, k, v, causal=causal,
                          chunk=chunk, bf16_probs=bf16_probs)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k, v = repeat_kv(k, H), repeat_kv(v, H)
    chunk = min(chunk, Sk)
    scale = D ** -0.5
    qf = q.float() * scale
    q_pos = torch.arange(Sq, device=q.device)
    # the running (m, l, acc) start from the first chunk — what the
    # update from (-inf, 0, 0) gives, exactly — so on a mesh they take
    # the scores' placement rather than a replicated initial value's
    m = l = acc = None
    for c0 in range(0, Sk, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        k_pos = c0 + torch.arange(kb.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float())
        if causal:
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
        m_new = s.amax(dim=-1)
        if m is not None:
            m_new = torch.maximum(m, m_new)
        p = torch.exp(s - m_new[..., None])
        pv = p.to(torch.bfloat16) if bf16_probs else p
        pv = torch.einsum("bhqk,bkhd->bhqd", pv, vb.to(pv.dtype)).float()
        if m is None:
            l, acc = p.sum(dim=-1), pv
        else:
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)              # (B,Sq,H,D)


def swa_attention(q, k, v, *, window: int):
    """Exact sliding-window attention (token t sees [t-window+1, t]) via
    banded blocks: each w-sized query block attends to itself + the
    previous block. Compute O(S·2w)."""
    if is_dtensor(q):
        return _on_shards(swa_attention, q, k, v, window=window)
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
    k, v = repeat_kv(k, H), repeat_kv(v, H)
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


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     partials: bool = False, grouped: bool = False):
    """Single-token decode through the paged kernel K5. q (B,1,H,D);
    caches (B,Smax,KH,D); cache_len (B,) or scalar — number of valid
    positions (the new token's K/V already written at cache_len-1). For
    SWA the cache is a ring buffer whose valid slots are
    [0, cache_len), so ``window`` changes nothing here. On a mesh
    (DTensor caches) :func:`dense_decode_attention` with the
    ``partials``/``grouped`` layouts."""
    if is_dtensor(k_cache):
        return dense_decode_attention(q, k_cache, v_cache, cache_len,
                                      partials=partials, grouped=grouped)
    B, Smax = k_cache.shape[:2]
    k_pool, page = kern.dense_cache_pages(k_cache)
    v_pool, _ = kern.dense_cache_pages(v_cache)
    table = kern.identity_page_table(B, Smax, page, k_cache.device)
    lengths = torch.as_tensor(cache_len, device=k_cache.device).to(
        torch.int32).reshape(-1).expand(B).contiguous()
    out = kern.paged_attention(q[:, 0].contiguous(), k_pool, v_pool, table,
                               lengths)
    return out[:, None]


def _softmax(s, reduce=None):
    """jax.nn.softmax's form, exp(s − max) / sum, over the last dim;
    ``reduce(t, op)`` takes the max and the sum across the ranks that
    split that dim."""
    m = s.amax(dim=-1, keepdim=True)
    if reduce is not None:
        m = reduce(m, "max")
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    if reduce is not None:
        den = reduce(den, "sum")
    return e / den


def dense_decode_attention(q, k_cache, v_cache, cache_len, *,
                           partials: bool = False, grouped: bool = False):
    """The reference's dense single-token decode (its ``decode_attention``
    off the kernel), the route on a mesh. q (B,1,H,D); caches
    (B,Smax,KH,D), the valid slots [0, cache_len).

    ``grouped``: KH-grouped products that never materialise the
    (B,S,H,D) repeat — the cache is read once at its native KH width.
    ``partials`` (flash-decoding layout) shapes the mesh route,
    :func:`_dense_decode_on_shards`; on plain tensors it changes
    nothing."""
    if is_dtensor(k_cache):
        return _dense_decode_on_shards(q, k_cache, v_cache, cache_len,
                                       partials=partials, grouped=grouped)
    pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = pos[None, :] < torch.as_tensor(
        cache_len, device=q.device).reshape(-1, 1)
    return _dense_decode(q, k_cache, v_cache, valid, grouped)


def _dense_decode(q, k_cache, v_cache, valid, grouped: bool, reduce=None):
    """The dense decode over the slots ``valid`` (B, S) marks; with
    ``reduce`` (see :func:`_softmax`) the caches hold one rank's share of
    the sequence, and the softmax and the output are summed across the
    ranks."""
    B, Smax, KH, D = k_cache.shape
    H = q.shape[2]
    scale = D ** -0.5
    if grouped:
        G = H // KH
        qg = q.reshape(B, 1, KH, G, D).float() * scale
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float())
        s = torch.where(valid[:, None, None, None], s, NEG_INF)
        out = torch.einsum("bhgqk,bkhd->bhgqd", _softmax(s, reduce),
                           v_cache.float())
        if reduce is not None:
            out = reduce(out, "sum")
        out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, D)
        return out.to(q.dtype)
    k_cache = repeat_kv(k_cache, H)
    v_cache = repeat_kv(v_cache, H)
    qf = q.float() * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k_cache.float())
    s = torch.where(valid[:, None, None], s, NEG_INF)
    out = torch.einsum("bhqk,bkhd->bhqd", _softmax(s, reduce),
                       v_cache.float())
    if reduce is not None:
        out = reduce(out, "sum")
    return out.transpose(1, 2).to(q.dtype)


def _dense_decode_on_shards(q, k_cache, v_cache, cache_len, *,
                            partials: bool, grouped: bool):
    """The dense decode on DTensor caches, on each rank's shards. The
    queries take the cache's batch split and its head split (else they
    come whole). Where the mesh splits the cache's sequence, the layout
    decides: by default the whole sequence is gathered on every rank
    (the reference's GSPMD reshards the cache onto the heads layout each
    step); with ``partials`` (flash-decoding) each rank scores its own
    slots and only the softmax's max and sum and the (B, H, D) output
    are reduced across the ranks. The output takes the queries'
    placements."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, cpl = k_cache.device_mesh, k_cache.placements
    dims = [p.dim if isinstance(p, Shard) else None for p in cpl]
    q_pl = [Shard(0) if d == 0 else Shard(2) if d == 2 else Replicate()
            for d in dims]
    len_pl = [Shard(0) if d == 0 else Replicate() for d in dims]
    seq = [i for i, d in enumerate(dims) if d == 1]

    def local(t, placements):
        if not is_dtensor(t):
            t = replicated_like(t, k_cache)
        return t.redistribute(mesh, placements).to_local()
    lens = torch.as_tensor(cache_len, device=k_cache.device)
    if not is_dtensor(lens):
        lens = lens.reshape(-1).expand(k_cache.shape[0])
    ql, lens = local(q, q_pl), local(lens, len_pl)
    kl, vl, offset, reduce = (k_cache.to_local(), v_cache.to_local(), 0,
                              None)
    if seq and not partials:
        whole = [Replicate() if d == 1 else p for d, p in zip(dims, cpl)]
        kl, vl = local(k_cache, whole), local(v_cache, whole)
    elif seq:
        offset = shard_offset(k_cache, 1)

        def reduce(t, op):
            for i in seq:
                t = funcol.all_reduce(t, op, (mesh, i))
            return t
    pos = offset + torch.arange(kl.shape[1], device=kl.device)
    valid = pos[None, :] < lens.reshape(-1, 1)
    out = _dense_decode(ql, kl, vl, valid, grouped, reduce)
    return DTensor.from_local(out, mesh, q_pl, run_check=False)


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
    out = merge_heads(o) @ p.wo.to(cdtype(cfg))
    return out, (k, v)
