"""The serving path's attention kernels, each beside its plain torch
version.

Two CUDA kernels (sources in ``repro_torch/csrc/``, built and bound by
the machinery of :mod:`repro_torch.kernels.fleet`):

========== ================================= ============================
kernel     replaces (JAX package)            bound on an H100
========== ================================= ============================
K4 flash_  ``flash_attention._kernel`` /     operations: 4·D FLOPs per
attention  ``flash_attention``               visible (query, key) pair
           (Pallas, kernels/flash_           (prefill)
           attention.py)
K5 paged_  ``paged_attention._kernel`` /     bytes: each valid token's K
attention  ``paged_attention``               and V row read once (decode)
           (Pallas, kernels/paged_
           attention.py)
========== ================================= ============================

K4 takes one of two routes by dtype. bf16 runs on the tensor cores
(``wgmma``): a warpgroup owns 64 query rows, S = Q·Kᵀ and O += P·V are
warpgroup products from bf16 tiles that the tensor memory accelerator
streams into shared memory while earlier tiles compute, and P is
rounded to bf16 for the second product — the one rounding the f32
Pallas kernel does not have, well inside the bf16 tolerance. f32 stays
on the CUDA cores (``attention_tile.cuh``): the tensor cores would
compute in TF32, beyond the f32 tolerance.

K5 splits each sequence across CTAs (flash decoding): the grid is
(sequence · kv head · row group, split), a CTA carries exactly the
query rows that share its kv head, streams K and V in their own dtype,
and writes its partial softmax state when there are several splits;
the last CTA of each group to finish merges them
(:func:`paged_attention_merge_plain` is the merge's plain version).
The number of splits comes from the grid size and the table's capacity
(:func:`paged_splits`), each CTA's token range from its sequence's
length on the card (:func:`paged_split_bounds`).

Every wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises (no fallback). Each call
adds one to ``fleet.LAUNCHES``. The plain versions are the oracles on
the card and the CPU path of the tests: blockwise online softmax for
flash (``flash_attention_plain``), gather plus masked softmax for paged
(``paged_attention_plain``, the JAX package's ``paged_attention_ref``).

Layouts follow the JAX package: flash takes q (B, H, Sq, D) and k/v
(B, KH, Sk, D), paged takes q (B, H, D), pools (KH, P, page, D), an
int32 page table (B, max_pages) and int32 lengths (B,). Both kernels
read through element strides (the last dimension contiguous, rows
16-byte aligned), so the model's (B, S, H, D) activations and a dense
(B, Smax, KH, D) cache pass as views without a copy
(:func:`dense_cache_pages`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import fleet

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128)
#: H100 SXM peak rates (NVIDIA's data sheet): dense bf16 on the tensor
#: cores, and float32 outside them
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: streaming multiprocessors of an H100 SXM (the wrapper reads the card's)
SMS = 132
#: K5 splits a sequence in whole rounds of this many tokens (4 warps ×
#: 32-token tiles), into at most this many splits
PAGED_ROUND = 128
PAGED_MAX_SPLITS = 32


def _strides(*tensors, dims: int = 3) -> ctypes.Array:
    """The leading ``dims`` element strides of each tensor, as the int64
    array the kernels read."""
    vals = [int(s) for t in tensors for s in t.stride()[:dims]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors (one device); False for CPU tensors; raises
    on anything else. Unlike the fleet kernels these take strided views,
    so only the last dimension must be contiguous. K4-K7 are
    forward-only: while autograd records, a CUDA tensor that requires
    grad raises, since the kernel's output would carry no gradient back
    to it (the models take the plain versions then); under ``no_grad``
    (a prefill from trainable weights) nothing is recorded and the
    kernel runs."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the attention and recurrent kernels are forward-only: an "
            "input requires grad, and the kernel's output would not carry "
            "its gradient; use the plain version under autograd")
    return True


def _check_head_dim(D: int) -> None:
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}: the attention "
                         f"kernels are compiled for those only")


def _check_vector_rows(*tensors, what: str = "attention kernels") -> None:
    """The kernels stage rows (here K/V) with 16-byte loads: each row must
    start 16-byte aligned (base pointer and leading strides) and the last
    dimension must be contiguous."""
    for t in tensors:
        vec = 16 // t.element_size()
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s % vec for s in t.stride()[:-1])):
            raise ValueError(
                f"{what}: a tensor with strides {t.stride()} and address "
                f"{t.data_ptr():#x} has rows that are not 16-byte aligned "
                f"or not contiguous")


# ------------------------------------------------------- K4 flash attention
def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Blockwise online-softmax attention in f32, the arithmetic of the
    Pallas ``_kernel`` (lines 55-74) over its default 256-key blocks."""
    block_k = 256
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    dev = q.device
    qf = q.float().reshape(B, KH, G, Sq, D) * D ** -0.5
    q_pos = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, KH, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KH, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KH, G, Sq, D), dtype=torch.float32, device=dev)
    for k0 in range(0, min(Sk, Sq) if causal else Sk, block_k):
        kb = k[:, :, k0:k0 + block_k].float()
        vb = v[:, :, k0:k0 + block_k].float()
        k_pos = k0 + torch.arange(kb.shape[2], device=dev)[None, :]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb)
        mask = torch.ones((Sq, kb.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos <= q_pos
        if window > 0:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, Sq, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """K4: q (B, H, Sq, D); k/v (B, KH, Sk, D) with H % KH == 0 →
    (B, H, Sq, D) in q's dtype. Causal masking is ``key <= query`` from
    position 0 on both sides, as the Pallas kernel does; ``window > 0``
    further keeps keys with ``key > query - window``. On CUDA the result
    is a (B, H, Sq, D) view of a (B, Sq, H, D) tensor, the layout the
    model's output projection reads."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    if H % KH or k.shape != (B, KH, Sk, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not _on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check_head_dim(D)
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes f32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    _check_vector_rows(q, k, v, what="flash_attention")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = _strides(q, k, v, out)     # alive until the launch returns
    fleet._launch("flash_attention", _DTYPE_CODE[q.dtype], D, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KH, Sq,
                  Sk, ctypes.addressof(strides), int(causal), int(window),
                  float(D ** -0.5))
    return out


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the masks leave visible, per (b, h)."""
    q = torch.arange(Sq, dtype=torch.int64)
    hi = torch.clamp(q + 1, max=Sk) if causal else torch.full_like(q, Sk)
    lo = torch.clamp(q - window + 1, min=0) if window > 0 \
        else torch.zeros_like(q)
    return int(torch.clamp(hi - lo, min=0).sum())


def flash_attention_bound_ms(B, H, KH, Sq, Sk, D, *, causal=True, window=0,
                             itemsize=2) -> tuple[float, str]:
    """Least time for one call: q, k, v read and o written once against
    4·D FLOPs a visible pair at the tensor-core bf16 rate (f32 inputs:
    the f32 rate)."""
    bytes_ = itemsize * D * (2 * B * H * Sq + 2 * B * KH * Sk)
    flops = 4 * D * B * H * visible_pairs(Sq, Sk, causal, window)
    rate = BF16_FLOPS_PER_S if itemsize == 2 else F32_FLOPS_PER_S
    t_bytes, t_ops = bytes_ / fleet.HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------- K5 paged attention
def paged_attention_plain(q, k_pool, v_pool, page_table, lengths
                          ) -> torch.Tensor:
    """Gather the pages densely, then masked decode attention in f32
    (the JAX package's ``paged_attention_ref``)."""
    B, H, D = q.shape
    KH, _, page, _ = k_pool.shape
    G = H // KH
    mp = page_table.shape[1]
    pt = page_table.long()

    def gather(pool):
        return pool[:, pt].permute(1, 0, 2, 3, 4).reshape(
            B, KH, mp * page, D).float()

    qg = q.float().reshape(B, KH, G, D) * D ** -0.5
    s = torch.einsum("bhgd,bhkd->bhgk", qg, gather(k_pool))
    valid = (torch.arange(mp * page, device=q.device)[None]
             < lengths.to(q.device)[:, None])
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, gather(v_pool))
    return o.reshape(B, H, D).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """K5: q (B, H, D); pools (KH, P, page, D); page_table (B, max_pages)
    int32; lengths (B,) int32 → (B, H, D) in q's dtype. Tokens past
    ``max_pages·page`` do not exist, so a longer length is clipped."""
    B, H, D = q.shape
    KH, _, page, _ = k_pool.shape
    mp = page_table.shape[1]
    if (H % KH or k_pool.shape[-1] != D or v_pool.shape != k_pool.shape
            or page_table.shape[0] != B or lengths.shape != (B,)):
        raise ValueError(
            f"paged_attention: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, page_table "
            f"{tuple(page_table.shape)}, lengths {tuple(lengths.shape)}")
    if not _on_cuda(q, k_pool, v_pool, page_table, lengths):
        return paged_attention_plain(q, k_pool, v_pool, page_table, lengths)
    _check_head_dim(D)
    kinds = (q.dtype, k_pool.dtype)
    code = {(torch.float32, torch.float32): 0,
            (torch.bfloat16, torch.bfloat16): 1,
            (torch.float32, torch.bfloat16): 2}.get(kinds)
    if code is None or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"paged_attention: unsupported dtypes q {q.dtype}, "
                         f"pools {k_pool.dtype}/{v_pool.dtype}")
    if (page_table.dtype != torch.int32 or lengths.dtype != torch.int32
            or not page_table.is_contiguous() or not lengths.is_contiguous()):
        raise ValueError("paged_attention: page_table and lengths must be "
                         "contiguous int32")
    if not q.is_contiguous():
        raise ValueError("paged_attention: q must be contiguous")
    _check_vector_rows(k_pool, v_pool)
    return _paged_launch(code, q, k_pool, v_pool, page_table, lengths,
                         paged_splits(_paged_ctas(B, H, KH), mp * page,
                                      _sm_count(q.device)))


def _paged_launch(code, q, k_pool, v_pool, page_table, lengths, splits):
    """Launch K5 on checked CUDA inputs with ``splits`` splits of each
    sequence (the wrapper's plan; chip_smoke.py also times others)."""
    B, H, D = q.shape
    KH, _, page, _ = k_pool.shape
    mp = page_table.shape[1]
    out = torch.empty_like(q)
    part = counters = None
    if splits > 1:
        part = torch.empty(B * H * splits * (D + 2), dtype=torch.float32,
                           device=q.device)
        counters = _counters(q.device, _paged_ctas(B, H, KH))
    strides = _strides(k_pool, v_pool)   # alive until the launch returns
    fleet._launch("paged_attention", code, D, q.data_ptr(),
                  k_pool.data_ptr(), v_pool.data_ptr(),
                  page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                  B, H, KH, mp, page, ctypes.addressof(strides),
                  float(D ** -0.5), splits,
                  None if part is None else part.data_ptr(),
                  None if counters is None else counters.data_ptr())
    return out


_COUNTERS: dict = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """K5's per-CTA-group split counters on ``device``: int32 zeros that
    each launch leaves zero, kept across calls (one stream at a time)."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _paged_ctas(B: int, H: int, KH: int) -> int:
    """K5's CTAs a split: one per (sequence, kv head, row group)."""
    return B * KH * -(-(H // KH) // paged_rows(H // KH))


def paged_rows(G: int) -> int:
    """Query rows a K5 CTA carries for a group of G = H / KH rows: G
    itself for 1, 2, 4 or 8, else the next of those (8 beyond, in
    ceil(G / 8) groups)."""
    return next(r for r in (1, 2, 4, 8) if r >= min(G, 8))


def paged_splits(ctas: int, capacity: int, sms: int = SMS) -> int:
    """Splits of each sequence across CTAs: enough for about one CTA an
    SM over the ``ctas`` (sequence, kv head, row group) CTAs, and no more
    than the table's ``capacity`` (max_pages · page) has 128-token rounds,
    so a short table takes one split. More splits leave each warp one
    tile, whose load nothing overlaps, and more partial states to merge
    (chip_smoke.py's split sweep). The lengths play no part: they lie on
    the card, and reading them would stall the host each layer."""
    want = -(-sms // max(ctas, 1))
    return max(1, min(want, -(-capacity // PAGED_ROUND), PAGED_MAX_SPLITS))


def paged_split_bounds(length: int, capacity: int, splits: int
                       ) -> list[tuple[int, int]]:
    """The token ranges [begin, end) that K5's CTAs of one sequence take,
    as the kernel computes them from the length: whole 128-token rounds
    of min(length, capacity); the splits past the last are empty."""
    n = max(0, min(length, capacity))
    per = -(-n // splits)
    size = max(PAGED_ROUND, -(-per // PAGED_ROUND) * PAGED_ROUND)
    return [(min(n, s * size), min(n, (s + 1) * size)) for s in range(splits)]


def paged_attention_merge_plain(m, l, acc, dtype=torch.float32
                                ) -> torch.Tensor:
    """K5's merge of the splits' partial states: m and l (B, H, S), acc
    (B, H, S, D), all f32 and unnormalised → (B, H, D) in ``dtype``:
    o = Σ acc_s e^(m_s − m) / Σ l_s e^(m_s − m) with m = max m_s. An
    empty split (m = NEG_INF, l = 0, acc = 0) adds nothing."""
    f = torch.exp(m - m.amax(dim=-1, keepdim=True))
    ls = (l * f).sum(dim=-1)
    o = (acc * f[..., None]).sum(dim=-2)
    return (o / torch.clamp(ls, min=1e-30)[..., None]).to(dtype)


def dense_cache_pages(cache: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A dense per-slot cache (B, Smax, KH, D) as a page pool view
    (KH, B·Smax/page, page, D) — no copy — and the page size: the
    largest of 16, 8, 4, 2, 1 that divides Smax. Slot b owns pages
    b·Smax/page … (b+1)·Smax/page − 1 (:func:`identity_page_table`)."""
    B, Smax, KH, D = cache.shape
    page = next(p for p in (16, 8, 4, 2, 1) if Smax % p == 0)
    return cache.view(B * Smax // page, page, KH, D).permute(2, 0, 1, 3), page


def identity_page_table(B: int, Smax: int, page: int,
                        device) -> torch.Tensor:
    return torch.arange(B * Smax // page, dtype=torch.int32,
                        device=device).view(B, Smax // page)


def paged_attention_bound_ms(lengths, KH: int, H: int, D: int, mp: int,
                             page: int, itemsize: int = 2
                             ) -> tuple[float, str]:
    """Least time for one call with these lengths: every valid token's K
    and V row read once, q read and o written once, the table and
    lengths read once; 4·D FLOPs per (query head, valid token) at the
    tensor-core bf16 rate (f32 inputs: the f32 rate)."""
    tokens = int(torch.clamp(torch.as_tensor(lengths, dtype=torch.int64),
                             max=mp * page).clamp(min=0).sum())
    B = len(lengths)
    bytes_ = (2 * tokens * KH * D * itemsize + 2 * B * H * D * itemsize
              + 4 * B * (mp + 1))
    flops = 4 * D * H * tokens
    rate = BF16_FLOPS_PER_S if itemsize == 2 else F32_FLOPS_PER_S
    t_bytes, t_ops = bytes_ / fleet.HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")
