"""Int8 gradient compression (the JAX package's
``parallel/compression.py`` on torch, its single-card part).

Quantising blocks of ``BLOCK`` values to int8 with one f32 scale a block
halves the bytes a data-parallel gradient reduction moves against bf16.
:func:`maybe_compress_grads` is the train step's hook
(``grad_compression="int8"``): the quantise → dequantise round trip
models the wire precision on every leaf big enough to matter. Rounding
is half to even in both packages (``jnp.round``, ``torch.round``).
The reference's shard_map reduction over a mesh (``compressed_allreduce``,
``make_compressed_grad_fn``) comes with the port's sharding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def quantize_int8(x: torch.Tensor, block: int = BLOCK):
    """x (f32, any shape) → (q int8 (n_blocks, block), scales f32
    (n_blocks,), orig_shape); the flat values zero-padded to whole
    blocks."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % block))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0], tuple(x.shape)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape):
    blocks = q.float() * scale[:, None]
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape)


def compress_roundtrip(x: torch.Tensor) -> torch.Tensor:
    return dequantize_int8(*quantize_int8(x))


def maybe_compress_grads(grads: dict, threshold: int = 4096) -> dict:
    """Each leaf of at least ``threshold`` values through the int8 round
    trip (in f32, back in its own dtype); smaller leaves pass through
    untouched."""
    return {k: g if g.numel() < threshold
            else compress_roundtrip(g.float()).to(g.dtype)
            for k, g in grads.items()}
