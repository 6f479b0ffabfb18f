"""Pieces that the plain references of every architecture share
(:mod:`bench.reference.decoder`, and each further ``<arch>.py`` here):
float32 PyTorch, independent of the program (nothing of ``repro_torch``
is imported).

Every product of a reference goes through ``mm`` (default: float32 ``x
@ W``, :func:`plain_mm`), so that the control can put a lower precision
in its place (:func:`fp8_mm`). Weights arrive in the benchmark's layout
(:mod:`bench.reference.weights`) in any dtype and are taken to float32
a layer at a time."""
from __future__ import annotations

import torch

NEG_INF = float("-inf")


def plain_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def rms_norm(x, gain, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + gain)


def rope(x, theta: float):
    """x (S, heads, hd) at positions 0..S−1: the halves rotated."""
    S, _, hd = x.shape
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q, k, v, block: int = 1024):
    """q (S, H, hd), k/v (S, KH, hd), each query over keys 0..itself;
    queries in blocks so that the scores fit."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for s0 in range(0, S, block):
        qb = q[s0:s0 + block]
        s = torch.einsum("qhd,khd->hqk", qb, k) * hd ** -0.5
        qpos = s0 + torch.arange(qb.shape[0], device=q.device)
        s = s.masked_fill(kpos[None, None, :] > qpos[None, :, None], NEG_INF)
        out[s0:s0 + block] = torch.einsum("hqk,khd->qhd",
                                          torch.softmax(s, -1), v)
    return out


def glu(x, wg, wu, wd, mm):
    return mm(torch.nn.functional.silu(mm(x, wg)) * mm(x, wu), wd)


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's product: x per row and W per output column scaled
    into float8 e4m3, rounded there, and multiplied in float32."""
    def q(t, dim):
        s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0
        return (t / s).to(torch.float8_e4m3fn).float() * s
    return q(x, -1) @ q(w, 0)
