"""Int8 gradient compression for the data-parallel reduction (the JAX
package's ``parallel/compression.py`` on torch).

Quantising blocks of ``BLOCK`` values to int8 with one f32 scale a block
halves the bytes a data-parallel gradient reduction moves against bf16.
:func:`maybe_compress_grads` is the train step's hook
(``grad_compression="int8"``): the quantise → dequantise round trip
models the wire precision on every leaf big enough to matter. Rounding
is half to even in both packages (``jnp.round``, ``torch.round``).
:func:`compressed_allreduce` is the reference's shard_map reduction
over a ``torch.distributed`` group: a reduce-scatter in int8 (through
``all_to_all_single``), a local dequantised sum, and an all-gather of
the requantised partial sums and their scales; the wire carries int8
where a ring all-reduce would carry bf16. :func:`make_compressed_grad_fn`
is per-rank gradients and that reduction over the data group(s).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
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


def compressed_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (every rank passes the
    same shape), reduced in int8: each rank's values, zero-padded to
    n × BLOCK and cut into n chunks, are quantised per block; chunk j
    goes to rank j (``all_to_all_single``, the int8 blocks and their
    scales), which sums its n dequantised copies in f32, requantises
    the sum and gathers every rank's (``all_gather``). Returns the f32
    sum of x's shape on every rank."""
    n = dist.get_world_size(group)
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % (n * BLOCK)))
    chunks = flat.reshape(n, -1)                       # (n, C)
    q, s, _ = quantize_int8(chunks)                    # int8 on the wire
    qr = q.reshape(n, -1, BLOCK)
    sr = s.reshape(n, -1)
    qx, sx = torch.empty_like(qr), torch.empty_like(sr)
    dist.all_to_all_single(qx, qr, group=group)
    dist.all_to_all_single(sx, sr, group=group)
    # local sum of my chunk across peers (dequantised)
    part = torch.sum(qx.float() * sx[..., None], dim=0)   # (C/B, B)
    # re-quantise the reduced chunk and all-gather int8 + scales
    pq, ps, _ = quantize_int8(part)
    gq = [torch.empty_like(pq) for _ in range(n)]
    gs = [torch.empty_like(ps) for _ in range(n)]
    dist.all_gather(gq, pq, group=group)
    dist.all_gather(gs, ps, group=group)
    full = (torch.stack(gq).float() * torch.stack(gs)[..., None]).reshape(-1)
    return full[: x.numel()].reshape(x.shape)


def make_compressed_grad_fn(loss_fn, mesh, data_axes=("data",)):
    """``grad_fn(params, batch) -> {name: grad}``: the gradients of
    ``loss_fn(params, batch)`` (a scalar) on this rank's batch shard,
    ``params`` a dict {name: tensor that requires grad}, then their mean
    over the data group(s) of ``mesh``, each reduced in turn by
    :func:`compressed_allreduce`."""
    groups = [mesh.device_mesh.get_group(a) for a in data_axes]
    n = 1
    for g in groups:
        n *= dist.get_world_size(g)
    scale = 1.0 / n

    def grad_fn(params: dict, batch):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        out = {}
        for k, g in zip(params, grads):
            for grp in groups:
                g = compressed_allreduce(g, grp)
            out[k] = g * scale
        return out

    return grad_fn
