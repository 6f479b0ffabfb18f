"""Mamba-2 / SSD blocks [arXiv:2405.21060], chunked state-space dual form.

Per head h (P channels, N state): with per-step log-decay
a_t = -exp(A_log)·dt_t,
  h_t = exp(a_t)·h_{t-1} + dt_t · x_t ⊗ B_t,    y_t = C_t·h_t + D·x_t.

The JAX package's ``repro.models.mamba2`` with weights in an
``nn.Module``. Its ``ssd_chunked`` is the pure-JAX analogue of the SSD
kernel; here it goes through :func:`repro_torch.kernels.ssd.ssd_forward`
— the kernel K7 on CUDA, the plain chunked version on the CPU — or,
where autograd records (K7 is forward-only), through the differentiable
plain version on any device, with the reference's contract on the
sequence length. Weights the reference
casts to f32 where it uses them (``a_log``, ``dt_bias``, the norm scale)
are held in ``param_dtype``, the rest in ``cfg.dtype``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import CHUNK, ssd_forward, ssd_forward_plain
from repro_torch.models.layers import (cdtype, const_init, dense_init,
                                       frozen, normal_init, pdtype, recording,
                                       rms_norm)


class Mamba2(nn.Module):
    """The reference's ``mamba2_params``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        D = cfg.d_model
        di, N, H, W = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.conv_width
        conv_ch = di + 2 * N
        cd, pd = cdtype(cfg), pdtype(cfg)
        self.in_proj = dense_init(gen, D, 2 * di + 2 * N + H, cd, device)
        self.conv_w = normal_init(gen, (W, conv_ch), math.sqrt(1.0 / W), cd,
                                  device)
        self.conv_b = const_init(0.0, (conv_ch,), cd, device)
        self.a_log = frozen(torch.log(
            torch.arange(1, H + 1, dtype=torch.float32) * 0.5 + 0.5
        ).to(device=device, dtype=pd))
        self.d_skip = const_init(1.0, (H,), cd, device)
        self.dt_bias = const_init(0.0, (H,), pd, device)
        self.norm_scale = const_init(0.0, (di,), pd, device)
        self.out_proj = dense_init(gen, di, D, cd, device)


def _split_in(p: Mamba2, x, cfg: ModelConfig):
    """x (B,S,D) → z (B,S,di), xBC (B,S,di+2N), dt (B,S,H) as views."""
    di, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p.in_proj.to(cdtype(cfg))
    return (zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * N],
            zxbcdt[..., 2 * di + 2 * N:])


def _causal_conv(p: Mamba2, xBC, cfg: ModelConfig, conv_state=None):
    """Depthwise causal conv1d (width W). conv_state (B, W-1, C) carries
    the last W-1 inputs. Returns (out, new_conv_state)."""
    W = cfg.conv_width
    B, S, C = xBC.shape
    if conv_state is None:
        conv_state = torch.zeros((B, W - 1, C), dtype=xBC.dtype,
                                 device=xBC.device)
    xp = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    w = p.conv_w.to(xBC.dtype)
    out = sum(xp[:, i: i + S] * w[i] for i in range(W))
    out = F.silu(out + p.conv_b.to(xBC.dtype))
    return out, xp[:, -(W - 1):]


def ssd_chunked(xh, dt, a_log, Bm, Cm, *, chunk=CHUNK, init_state=None):
    """Chunked SSD scan: K7 on CUDA, the plain chunked version on the CPU
and under autograd.

    xh (B,S,H,P); dt (B,S,H) f32 post-softplus; a_log (H,);
    Bm/Cm (B,S,N). S must be a multiple of ``min(chunk, S)``. Returns
    (y (B,S,H,P), final_state (B,H,P,N) f32).
    """
    run = (ssd_forward_plain
           if recording(xh, dt, a_log, Bm, Cm, init_state) else ssd_forward)
    y, s = run(xh.transpose(1, 2), dt.transpose(1, 2), a_log, Bm, Cm,
               chunk=chunk, init_state=init_state)
    return y.transpose(1, 2), s


def ssd_reference(xh, dt, a_log, Bm, Cm, init_state=None):
    """Per-step scan oracle (tests only)."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    a = -torch.exp(a_log.float())
    s = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * a[None])                   # (B,H)
        upd = torch.einsum("bhp,bn->bhpn",
                           xh[:, t].float() * dt[:, t, :, None],
                           Bm[:, t].float())
        s = s * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, Cm[:, t].float()))
    return torch.stack(ys, dim=1).to(xh.dtype), s


def _dt(p: Mamba2, dt_raw):
    return F.softplus(dt_raw.float() + p.dt_bias.float())


def mamba2_block(p: Mamba2, x, cfg: ModelConfig, state=None):
    """x (B,S,D); state = (conv_state, ssm_state) or None.
    Returns (out (B,S,D), new_state)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    B_, S, _ = x.shape
    conv_state = None if state is None else state[0]
    ssm_state = None if state is None else state[1]
    z, xBC, dt_raw = _split_in(p, x, cfg)
    xBC, conv_state = _causal_conv(p, xBC, cfg, conv_state)
    xs = xBC[..., :di].reshape(B_, S, H, P)
    Bm = xBC[..., di: di + N]
    Cm = xBC[..., di + N:]
    y, ssm_state = ssd_chunked(xs, _dt(p, dt_raw), p.a_log, Bm, Cm,
                               init_state=ssm_state)
    y = y + p.d_skip.to(y.dtype)[None, None, :, None] * xs
    y = rms_norm(y.reshape(B_, S, di) * F.silu(z), p.norm_scale)
    return y @ p.out_proj.to(cdtype(cfg)), (conv_state, ssm_state)


def mamba2_step(p: Mamba2, x, cfg: ModelConfig, state):
    """Single-token decode. x (B,D); state (conv_state, ssm_state)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    B_ = x.shape[0]
    conv_state, ssm_state = state
    z, xBC, dt_raw = _split_in(p, x[:, None], cfg)
    xBC, conv_state = _causal_conv(p, xBC, cfg, conv_state)
    xs = xBC[:, 0, :di].reshape(B_, H, P)
    Bm = xBC[:, 0, di: di + N]
    Cm = xBC[:, 0, di + N:]
    dt = _dt(p, dt_raw[:, 0])
    decay = torch.exp(dt * -torch.exp(p.a_log.float())[None])   # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", xs.float() * dt[..., None],
                       Bm.float())
    s = ssm_state.float() * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", s, Cm.float()).to(x.dtype)
    y = y + p.d_skip.to(y.dtype)[None, :, None] * xs
    y = rms_norm(y.reshape(B_, di) * F.silu(z[:, 0]), p.norm_scale)
    return y @ p.out_proj.to(cdtype(cfg)), (conv_state, s)
