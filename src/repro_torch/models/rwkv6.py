"""RWKV-6 "Finch" blocks [arXiv:2404.05892]: data-dependent decay linear
recurrence, attention-free; the decode state is O(1) in context.

Time-mix: ddlerp token-shift (5-way LoRA mix), per-channel
data-dependent decay w_t = exp(-exp(w0 + lora(x))), per-head (K×V)
state recurrence
  o_t = r_t · (S_{t-1} + diag(u)·k_t v_tᵀ),   S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ.
Channel-mix: shifted squared-ReLU FFN with sigmoid receptance gate.

The JAX package's ``repro.models.rwkv6`` with weights in ``nn.Module``s.
Its ``time_mix`` runs the recurrence as an inline scan; here it goes
through :func:`repro_torch.kernels.rwkv6.rwkv6_forward` — the kernel K6
on CUDA, the per-step plain version on the CPU — or, where autograd
records (K6 is forward-only), through the differentiable plain version
on any device. Each weight is held in
the dtype the reference casts it to where it is used: the decay LoRA,
``w0``, ``u`` and the group-norm weights in ``param_dtype`` (the decay
is computed in f32), the rest in ``cfg.dtype``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6 import rwkv6_forward, rwkv6_forward_plain
from repro_torch.models.layers import (cdtype, const_init, dense_init,
                                       group_norm_heads, merge_heads,
                                       normal_init, pdtype, recording,
                                       split_heads)
from repro_torch.parallel.sharding import (is_dtensor, replicate_model,
                                           replicated_like)

_MIX_NAMES = ("r", "k", "v", "w", "g")


class TimeMix(nn.Module):
    """The reference's ``time_mix_params``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        D, H, K = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_size
        r_mix, r_dec = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
        cd, pd = cdtype(cfg), pdtype(cfg)
        self.mu_base = const_init(0.0, (D,), cd, device)
        self.mu = const_init(0.0, (5, D), cd, device)
        self.w_mix1 = dense_init(gen, D, 5 * r_mix, cd, device, scale=0.01)
        self.w_mix2 = normal_init(gen, (5, r_mix, D), 0.01, cd, device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, dense_init(gen, D, D, cd, device))
        # decay bias: w ≈ exp(-exp(-2)) ≈ .87
        self.w0 = const_init(-2.0, (D,), pd, device)
        self.w_dec1 = dense_init(gen, D, r_dec, pd, device, scale=0.01)
        self.w_dec2 = dense_init(gen, r_dec, D, pd, device, scale=0.01)
        self.u = normal_init(gen, (H, K), 0.1, pd, device)
        self.ln_x_scale = const_init(1.0, (H, K), pd, device)
        self.ln_x_bias = const_init(0.0, (H, K), pd, device)


class ChannelMix(nn.Module):
    """The reference's ``channel_mix_params``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        cd = cdtype(cfg)
        self.mu_k = const_init(0.0, (D,), cd, device)
        self.mu_r = const_init(0.0, (D,), cd, device)
        self.wk = dense_init(gen, D, Fd, cd, device)
        self.wv = dense_init(gen, Fd, D, cd, device)
        self.wr = dense_init(gen, D, D, cd, device)


def _shifted(x, x_last):
    """The token shift: (B, S, D) inputs preceded by the carried last
    token (zeros when None)."""
    B, _, D = x.shape
    if x_last is None:
        x_last = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    return torch.cat([x_last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p: TimeMix, x, xprev, cfg: ModelConfig):
    """Data-dependent 5-way token-shift mix → dict name→mixed input."""
    dt = cdtype(cfg)
    dx = xprev - x
    base = x + dx * p.mu_base.to(dt)
    # on a mesh h is gathered over "model" first: its model-sharded last
    # dim does not split evenly into the 5 mixes, which DTensor's view
    # refuses
    h = replicate_model(torch.tanh(base @ p.w_mix1.to(dt)))
    h = h.reshape(*h.shape[:-1], 5, cfg.rwkv_lora_mix)
    off = torch.einsum("...fr,frd->...fd", h, p.w_mix2.to(dt))
    mix = p.mu.to(dt) + off                                     # (...,5,D)
    return {n: x + dx * mix[..., i, :] for i, n in enumerate(_MIX_NAMES)}


def _decay(p: TimeMix, xw, cfg: ModelConfig):
    """w_t ∈ (0,1): exp(-exp(w0 + tanh(xw@W1)@W2)), computed in f32."""
    z = xw.float()
    lora = torch.tanh(z @ p.w_dec1.float()) @ p.w_dec2.float()
    return torch.exp(-torch.exp(p.w0.float() + lora))


def _rkvwg(p: TimeMix, x, xprev, cfg: ModelConfig):
    dt = cdtype(cfg)
    m = _ddlerp(p, x, xprev, cfg)
    H, K = cfg.rwkv_heads, cfg.rwkv_head_size
    r = split_heads(m["r"] @ p.wr.to(dt), H, K)
    k = split_heads(m["k"] @ p.wk.to(dt), H, K)
    v = split_heads(m["v"] @ p.wv.to(dt), H, K)
    g = F.silu(m["g"] @ p.wg.to(dt))
    w = split_heads(_decay(p, m["w"], cfg), H, K)               # f32
    return r, k, v, w, g


def _out(p: TimeMix, o, g, cfg: ModelConfig):
    dt = cdtype(cfg)
    o = group_norm_heads(o.to(dt), p.ln_x_scale, p.ln_x_bias)
    o = merge_heads(o) * g
    return o @ p.wo.to(dt)


def time_mix(p: TimeMix, x, cfg: ModelConfig, state=None):
    """x (B,S,D). state: (x_prev (B,D), S (B,H,K,K)) or None.
    Returns (out (B,S,D), (x[:, -1], final S f32)). The recurrence runs
    through K6 on CUDA (its o rounded to ``cfg.dtype`` once, where the
    reference's ``_out`` rounds its f32 scan output)."""
    xprev = _shifted(x, None if state is None else state[0])
    r, k, v, w, g = _rkvwg(p, x, xprev, cfg)
    s0 = None if state is None else state[1]
    run = (rwkv6_forward_plain if recording(r, k, v, w, p.u, s0)
           else rwkv6_forward)
    o, s_fin = _on_shards(run, r.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), w.transpose(1, 2), p.u, s0)
    return _out(p, o.transpose(1, 2), g, cfg), (x[:, -1], s_fin)


def _on_shards(run, r, k, v, w, u, s0):
    """``run(r, k, v, w, u, init_state=s0)`` (r, k, v, w (B, H, T, K)); on
    a mesh, on each rank's shards: the recurrence is independent across
    the batch and the heads, over which alone the mesh splits it, so the
    ranks need no collective, and each runs it as one card does (rather
    than one DTensor dispatch per step). The output and the final state
    (B, H, K, K) take r's placements."""
    if not is_dtensor(r):
        return run(r, k, v, w, u, init_state=s0)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, pl = r.device_mesh, r.placements
    # u (H, K): the rank's heads; its gradient from the rank's rows is a
    # part of the whole, summed over the mesh dims that split the batch
    u_pl = [Shard(0) if isinstance(q, Shard) and q.dim == 1 else Replicate()
            for q in pl]
    u_grad = [Partial() if isinstance(q, Shard) and q.dim == 0 else up
              for q, up in zip(pl, u_pl)]

    def local(t, placements, grads=None):
        if not is_dtensor(t):
            t = replicated_like(t, r)
        return t.redistribute(mesh, placements).to_local(
            grad_placements=grads)
    o, s_fin = run(*(local(t, pl) for t in (r, k, v, w)),
                   local(u, u_pl, u_grad),
                   init_state=None if s0 is None else local(s0, pl))
    return (DTensor.from_local(o, mesh, pl, run_check=False),
            DTensor.from_local(s_fin, mesh, pl, run_check=False))


def time_mix_step(p: TimeMix, x, cfg: ModelConfig, state):
    """Single-token decode. x (B,D); state (x_prev, S)."""
    x_prev, s = state
    r, k, v, w, g = _rkvwg(p, x, x_prev, cfg)
    s = s.float()
    u = p.u.float()
    kv = k.float()[..., None] * v.float()[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r.float(),
                     s + u[None, :, :, None] * kv)
    s_new = w[..., None] * s + kv
    return _out(p, o, g, cfg), (x, s_new)


def channel_mix(p: ChannelMix, x, cfg: ModelConfig, state=None):
    """x (B,S,D); state x_prev (B,D) or None. Returns (out, x[:, -1])."""
    return _channel_mix_core(p, x, _shifted(x, state), cfg), x[:, -1]


def channel_mix_step(p: ChannelMix, x, cfg: ModelConfig, state):
    return _channel_mix_core(p, x, state, cfg), x


def _channel_mix_core(p: ChannelMix, x, xprev, cfg: ModelConfig):
    dt = cdtype(cfg)
    dx = xprev - x
    xk = x + dx * p.mu_k.to(dt)
    xr = x + dx * p.mu_r.to(dt)
    kk = torch.square(F.relu(xk @ p.wk.to(dt)))
    return torch.sigmoid(xr @ p.wr.to(dt)) * (kk @ p.wv.to(dt))
