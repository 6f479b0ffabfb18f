"""KV caches.

Two worlds, as in the JAX package:
  * dense per-layer caches (stacked over layers) used by the decode
    steps — contiguous (L, B, Smax, KH, hd) tensors, updated in place
    (the reference rebuilds them functionally);
  * a paged KV pool — device memory carved into fixed-size pages;
    tenants own page quotas that DYVERSE vertically scales at runtime.
The dense branch serves the dense decoder; the other families' cache
layouts come with their models.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fleet import check_device


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
    (cast to the cache's dtype)."""
    k_cache, v_cache = cache_layer
    b = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[b, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[b, slot] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def grow_cache(cfg: ModelConfig, cache, max_len: int):
    """Pad a prefill-produced cache along its sequence axis to max_len so
    decode steps have free slots."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family} caches: slice 3")
    target = min(max_len, cfg.window) if cfg.attention == "swa" else max_len
    pad = target - cache["k"].shape[2]
    if pad > 0:
        pw = (0, 0, 0, 0, 0, pad)     # (hd, KH, S) from the last dim back
        cache = dict(cache, k=torch.nn.functional.pad(cache["k"], pw),
                     v=torch.nn.functional.pad(cache["v"], pw))
    return cache


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
