"""KV caches.

Two worlds, as in the JAX package:
  * dense per-layer caches (stacked over layers) used by the decode
    steps — contiguous (L, B, Smax, KH, hd) tensors, updated in place
    (the reference rebuilds them functionally);
  * a paged KV pool — device memory carved into fixed-size pages;
    tenants own page quotas that DYVERSE vertically scales at runtime.
The dense branch serves the dense and MoE decoders and the
encoder-decoder (with its cross K/V beside its self K/V); the RWKV-6
and hybrid families keep their fixed-size states beside it.
:func:`cache_specs` is the one place that knows each family's cache
layout: its shapes, dtypes, and which axis holds the batch and which
the sequence.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fleet import check_device
from repro_torch.parallel.sharding import is_dtensor, shard_offset


# ---------------------------------------------------------------- dense
def dense_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    """Stacked (L, B, S, KH, hd) k/v shapes."""
    L = cfg.num_layers
    S = min(max_len, cfg.window) if cfg.attention == "swa" else max_len
    return (L, batch, S, cfg.num_kv_heads, cfg.head_dim)


def init_dense_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device="cuda"):
    device = check_device(device)
    shape = dense_cache_shape(cfg, batch, max_len)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_slot(cache_layer, k_new, v_new, slot):
    """cache_layer: (k, v) each (B, S, KH, hd); k_new/v_new (B, 1, KH, hd);
    slot (B,) int — write the new token's K/V into its slot, in place
    (cast to the cache's dtype). On a mesh (DTensor caches) each rank
    writes its own shard (:func:`_write_shard`)."""
    k_cache, v_cache = cache_layer
    if is_dtensor(k_cache):
        _write_shard(k_cache, k_new[:, 0], slot)
        _write_shard(v_cache, v_new[:, 0], slot)
        return k_cache, v_cache
    b = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[b, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[b, slot] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def _write_shard(cache, new, slot) -> None:
    """Write ``new`` (B, KH, hd) at ``slot`` (B,) into this rank's shard of
    the DTensor ``cache`` (B, S, KH, hd), in place: DTensor has no
    in-place rule for the indexed write into a sharded cache. ``new``
    and ``slot`` take the cache's batch and head placements (a local
    slice where they were replicated); where the mesh shards the
    sequence, a rank writes only the rows whose slot falls in its range
    (the shards are even: a spec shards only the dims it divides)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    to_new = {0: Shard(0), 2: Shard(1)}
    new_pl, slot_pl = [], []
    for pl in cache.placements:
        d = pl.dim if isinstance(pl, Shard) else None
        new_pl.append(to_new.get(d, Replicate()))
        slot_pl.append(Shard(0) if d == 0 else Replicate())
    local = cache._local_tensor
    new = new.redistribute(mesh, new_pl).to_local().to(local.dtype)
    slot = slot.redistribute(mesh, slot_pl).to_local() if is_dtensor(slot) \
        else slot
    s_local = local.shape[1]
    idx = slot - shard_offset(cache, 1)
    inside = (idx >= 0) & (idx < s_local)
    idx = idx.clamp(0, s_local - 1)
    b = torch.arange(local.shape[0], device=local.device)
    local[b, idx] = torch.where(inside[:, None, None], new, local[b, idx])


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype
    batch_axis: int
    seq_axis: int | None = None     # None: a fixed-size state


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """{name: TensorSpec} of the decode caches of ``cfg``'s family for
    ``batch`` slots of ``max_len`` tokens: the dense and MoE k/v (L, B,
    S, KH, hd); the encoder-decoder's k/v (L, B, S, KH, hd) and cross
    k/v ``ck``/``cv`` (L, B, Se, KH, hd), Se = max(max_len //
    encoder_seq_ratio, 1); the RWKV-6 token-shift and wkv states (L, B,
    ...); the hybrid family's shared-attention k/v (G, B, S, KH, hd) and
    its conv and SSM states (G, attn_every, B, ...)."""
    if cfg.family in ("dense", "moe"):
        shape = dense_cache_shape(cfg, batch, max_len)
        return {"k": TensorSpec(shape, torch.bfloat16, 1, 2),
                "v": TensorSpec(shape, torch.bfloat16, 1, 2)}
    if cfg.family == "encdec":
        L, KH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        Se = max(max_len // cfg.encoder_seq_ratio, 1)
        kv = (L, batch, max_len, KH, hd)
        ckv = (L, batch, Se, KH, hd)
        return {"k": TensorSpec(kv, torch.bfloat16, 1, 2),
                "v": TensorSpec(kv, torch.bfloat16, 1, 2),
                "ck": TensorSpec(ckv, torch.bfloat16, 1, 2),
                "cv": TensorSpec(ckv, torch.bfloat16, 1, 2)}
    if cfg.family == "rwkv6":
        L, D = cfg.num_layers, cfg.d_model
        H, K = cfg.rwkv_heads, cfg.rwkv_head_size
        return {"att_x": TensorSpec((L, batch, D), torch.bfloat16, 1),
                "att_s": TensorSpec((L, batch, H, K, K), torch.float32, 1),
                "ffn_x": TensorSpec((L, batch, D), torch.bfloat16, 1)}
    if cfg.family == "hybrid":
        G, Kn = cfg.num_layers // cfg.attn_every, cfg.attn_every
        N = cfg.ssm_state
        kv = (G, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {
            "attn_k": TensorSpec(kv, torch.bfloat16, 1, 2),
            "attn_v": TensorSpec(kv, torch.bfloat16, 1, 2),
            "conv": TensorSpec((G, Kn, batch, cfg.conv_width - 1,
                                cfg.d_inner + 2 * N), torch.bfloat16, 2),
            "ssm": TensorSpec((G, Kn, batch, cfg.ssm_heads,
                               cfg.ssm_head_dim, N), torch.float32, 2),
        }
    raise ValueError(f"unknown family {cfg.family}")


def grow_cache(cfg: ModelConfig, cache, max_len: int):
    """Pad a prefill-produced cache along its sequence axes to the
    decode caches' length (:func:`cache_specs`) so decode steps have
    free slots; fixed-size states stay as they are, and so does the
    cross K/V, at the prefill's encoder length (the reference pads the
    self K/V only, and decode attends over every cross slot)."""
    out = dict(cache)
    for k, spec in cache_specs(cfg, 1, max_len).items():
        if spec.seq_axis is None or k in ("ck", "cv"):
            continue
        pad = spec.shape[spec.seq_axis] - cache[k].shape[spec.seq_axis]
        if pad > 0:
            pw = [0, 0] * (cache[k].dim() - 1 - spec.seq_axis) + [0, pad]
            out[k] = torch.nn.functional.pad(cache[k], pw)
    return out


# ---------------------------------------------------------------- paged
@dataclass
class PagedPoolConfig:
    num_pages: int            # total pages in the pool (the contended resource)
    page_size: int            # tokens per page
    num_kv_heads: int
    head_dim: int
    num_layers: int
    dtype: str = "bfloat16"

    @property
    def bytes_per_page(self) -> int:
        itemsize = torch.empty((), dtype=getattr(torch, self.dtype)
                               ).element_size()
        return (2 * self.num_layers * self.page_size * self.num_kv_heads
                * self.head_dim * itemsize)


class PagedKVPool:
    """A fixed pool of KV pages + free-list. Page ownership is tracked per
    tenant so DYVERSE can account/reclaim. The data plane is torch on
    ``device``; the free-list/ownership control plane is host-side —
    scaling decisions are control-plane-only, matching the paper's design
    point that vertical scaling must be cheap (no data movement on quota
    change)."""

    def __init__(self, cfg: PagedPoolConfig, device="cuda"):
        device = check_device(device)
        self.cfg = cfg
        shape = (cfg.num_layers, cfg.num_pages, cfg.page_size,
                 cfg.num_kv_heads, cfg.head_dim)
        dt = getattr(torch, cfg.dtype)
        self.k = torch.zeros(shape, dtype=dt, device=device)
        self.v = torch.zeros(shape, dtype=dt, device=device)
        self._free: list[int] = list(range(cfg.num_pages))
        self._owner: dict[int, str] = {}

    # ---- control plane
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_owned(self, tenant: str) -> int:
        return sum(1 for t in self._owner.values() if t == tenant)

    def alloc(self, tenant: str, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"pool exhausted: want {n}, free {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for pg in pages:
            self._owner[pg] = tenant
        return pages

    def free(self, pages: list[int]) -> None:
        for pg in pages:
            self._owner.pop(pg, None)
            self._free.append(pg)

    def release_tenant(self, tenant: str) -> int:
        pages = [pg for pg, t in self._owner.items() if t == tenant]
        self.free(pages)
        return len(pages)

    # ---- data plane
    def write(self, layer: int, page: int, offset: int, k_tok, v_tok) -> None:
        self.k[layer, page, offset] = k_tok
        self.v[layer, page, offset] = v_tok


def gather_pages(pool_k, pool_v, page_table):
    """pool_{k,v}: (L, P, page, KH, hd); page_table (B, max_pages) int
    (padded with 0; validity via length elsewhere). Returns contiguous
    (L, B, max_pages*page, KH, hd) copies — the plain-torch analogue of
    the paged kernel's gather."""
    L, P, page, KH, hd = pool_k.shape
    pt = page_table.long()
    k = pool_k[:, pt]          # (L, B, max_pages, page, KH, hd)
    v = pool_v[:, pt]
    B, mp = page_table.shape
    return (k.reshape(L, B, mp * page, KH, hd),
            v.reshape(L, B, mp * page, KH, hd))
