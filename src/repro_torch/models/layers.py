"""Shared neural-net layers: norms, RoPE, GLU MLPs, embeddings.

The JAX package's functional layers with weights held in ``nn.Module``
containers. The dtype rules are the reference's: compute runs in
``cfg.dtype`` (bf16) with norms, RoPE and logits in f32. A serving
model holds its matrices in ``cfg.dtype`` once loaded — the reference
casts its f32 params with ``.astype(dt)`` on every call, which gives the
same numbers — and norm weights in ``param_dtype``, all frozen. A
trainable model holds every weight in ``param_dtype`` (f32 masters
that require grad) and casts at each use, as the reference does. Init
draws from an explicit ``torch.Generator`` (the generator's device is
where the draws run).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import (dtensor_axis_size, is_dtensor,
                                           reduce_partial,
                                           reduce_partial_grad,
                                           replicate_model,
                                           replicate_model_grad)


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def recording(*tensors) -> bool:
    """True when autograd records an operation on one of ``tensors``.
    The kernels K4-K7 are forward-only (their outputs have no
    ``grad_fn``), so the model then takes the plain differentiable
    functions, as the reference trains on its plain jnp path."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ---------------------------------------------------------------- init
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device, scale: float | None = None) -> nn.Parameter:
    scale = (1.0 / in_dim) ** 0.5 if scale is None else scale
    return normal_init(gen, (in_dim, out_dim), scale, dtype, device)


def normal_init(gen: torch.Generator, shape: tuple, scale: float, dtype,
                device) -> nn.Parameter:
    """N(0, scale²) weights drawn on the generator's device; on ``meta``
    (shapes only, as ``jax.eval_shape`` gives them) nothing is drawn."""
    if torch.device(device).type == "meta":
        return frozen(torch.empty(shape, dtype=dtype, device="meta"))
    w = torch.randn(shape, generator=gen, device=gen.device)
    return frozen((w * scale).to(device=device, dtype=dtype))


def const_init(value: float, shape: tuple, dtype, device) -> nn.Parameter:
    return frozen(torch.full(shape, value, dtype=dtype, device=device))


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device) -> nn.Parameter:
    return dense_init(gen, vocab, dim, dtype, device, scale=0.02)


# ---------------------------------------------------------------- norms
def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = reduce_partial(x.float())
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = reduce_partial(x.float())
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float()) + bias.float()).to(dt)


def group_norm_heads(x, scale, bias, eps: float = 64e-5):
    """Per-head LayerNorm used by RWKV-6 (x: ..., H, K), in f32."""
    dt = x.dtype
    x = reduce_partial(x.float())
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` and ``bias``), both
    zero-initialised around a unit gain as in the reference."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        zeros = torch.zeros(cfg.d_model, dtype=pdtype(cfg), device=device)
        self.scale = frozen(zeros)
        self.bias = frozen(zeros.clone()) if cfg.norm == "layernorm" \
            else None


def apply_norm(p: Norm, x, cfg: ModelConfig):
    """The block's norm; on a mesh, the input of its column-parallel
    products, whose gradient it reduces (:func:`reduce_partial_grad`)."""
    if p.bias is not None:
        return reduce_partial_grad(layer_norm(x, p.scale, p.bias))
    return reduce_partial_grad(rms_norm(x, p.scale))


# ---------------------------------------------------------------- heads
def split_heads(t, heads: int, head_dim: int):
    """(..., heads·head_dim) → (..., heads, head_dim). On a mesh whose
    "model" axis does not divide ``heads``, a projection sharded over
    "model" is gathered over it first: the view would split a head."""
    if is_dtensor(t) and heads % dtensor_axis_size(t, "model"):
        t = replicate_model(t)
    return t.reshape(*t.shape[:-1], heads, head_dim)


def merge_heads(t):
    """(..., heads, head_dim) → (..., heads·head_dim); where the "model"
    axis does not divide the heads (see :func:`split_heads`), the
    gradient is gathered over "model" before the view's backward, which
    would split a head."""
    out = t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
    if is_dtensor(t) and t.shape[-2] % dtensor_axis_size(t, "model"):
        out = replicate_model_grad(out)
    return out


# ---------------------------------------------------------------- RoPE
def rope_angles(positions, head_dim: int, theta: float):
    """positions: int (..., S) → cos/sin (..., S, head_dim//2) in f32."""
    half = head_dim // 2
    # made on the positions' device: a host-to-device copy here would
    # stall the stream once per layer
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D//2) or (S, D//2)."""
    half = x.shape[-1] // 2
    if cos.ndim == 2:  # (S, half)
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:  # (B, S, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    xf = x.float()
    x1f, x2f = xf[..., :half], xf[..., half:]
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- MLP
def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "relu": F.relu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


class GLUMLP(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = cdtype(cfg)
        self.w_gate = dense_init(gen, cfg.d_model, cfg.d_ff, dt, device)
        self.w_up = dense_init(gen, cfg.d_model, cfg.d_ff, dt, device)
        self.w_down = dense_init(gen, cfg.d_ff, cfg.d_model, dt, device)


def glu_mlp(p: GLUMLP, x, cfg: ModelConfig):
    dt = cdtype(cfg)
    g = x @ p.w_gate.to(dt)
    u = x @ p.w_up.to(dt)
    return (act_fn(cfg.act)(g) * u) @ p.w_down.to(dt)


# ---------------------------------------------------------------- embed/unembed
class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = cdtype(cfg)
        self.embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dt,
                                device)
        self.unembed = None if cfg.tie_embeddings else dense_init(
            gen, cfg.d_model, cfg.padded_vocab, dt, device, scale=0.02)


def embed(p: Embedding, tokens, cfg: ModelConfig):
    # on a mesh the table is gathered over "model" first: DTensor's rule
    # for a lookup into a vocab-sharded table fails on a 2-D mesh
    return F.embedding(tokens, replicate_model(p.embed).to(cdtype(cfg)))


def unembed(p: Embedding, x, cfg: ModelConfig):
    w = p.embed.to(cdtype(cfg)).T if cfg.tie_embeddings \
        else p.unembed.to(cdtype(cfg))
    return (x @ w).float()


def cross_entropy(logits, labels, mask=None):
    """logits (..., V) f32, labels int (...). Returns (mean_loss, n_tokens)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    # on a mesh the logits are gathered over the vocab ("model") first,
    # for the same reason as in :func:`embed`
    ll = torch.take_along_dim(replicate_model(logits), labels[..., None],
                              dim=-1)[..., 0]
    nll = lse - ll
    mask = torch.ones_like(nll) if mask is None else mask.float()
    total = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / total, total
