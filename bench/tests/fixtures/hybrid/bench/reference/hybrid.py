"""The plain float32 reference of the port's hybrid family, with its
weight layout: zamba2's stack (arXiv:2411.15242) as the port runs it.
G = num_hidden_layers / attn_every groups; each applies ONE shared block
(its weights the same in every group) to the stream x concatenated with
the embeddings x0 and fused back to width D (f = [x, x0] W_fuse; y = f +
attention(norm(f)); y += GLU(norm(y)); x += y), then ``attn_every``
Mamba-2 layers (arXiv:2405.21060), each x += Mamba2(norm(x)).

A Mamba-2 layer: [z, xBC, dt] = h W_in; xBC through a causal depthwise
conv of width ``mamba_d_conv`` and SiLU, then split into x (heads of
``mamba_headdim``), B and C (one group, ``mamba_d_state``); dt =
softplus(dt + dt_bias); per step, per head, the state h_t = exp(−exp(
a_log)·dt_t) h_{t−1} + dt_t x_t ⊗ B_t and y_t = h_t C_t + d_skip x_t;
out = RMSNorm(y ⊙ SiLU(z)) W_out. The scan runs step by step.

The port's conventions as in :mod:`bench.reference.decoder`: RMSNorm eps
1e-6 with the gain stored as 1 + g, RoPE on the halves of a head, no
biases but the conv's. Scales: matrices N(0, 1/fan_in), embeddings N(0,
0.02²), gains and the conv's bias N(0, 0.1²) offsets, a_log and dt_bias
N(0, 0.5²), d_skip N(0, 1)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.model import (causal_attention, glu, plain_mm,
                                   rms_norm, rope)
from bench.reference.weights import padded_vocab


def _mamba_sizes(cfg: dict) -> tuple[int, int, int, int, int]:
    """(d_inner, state, head_dim, heads, conv width)."""
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    P = cfg["mamba_headdim"]
    return di, cfg["mamba_d_state"], P, di // P, cfg["mamba_d_conv"]


def leaves(cfg: dict) -> list[tuple[str, tuple, float]]:
    """(name, shape, scale) of every leaf, in the order they are drawn;
    the shared block's once, the Mamba-2 layers' stacked over layers."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, KH, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    Fw, V = cfg["intermediate_size"], padded_vocab(cfg)
    di, N, _, Hs, W = _mamba_sizes(cfg)
    out = [("embed", (V, D), 0.02)]
    if not cfg["tie_word_embeddings"]:
        out.append(("unembed", (D, V), 0.02))
    out += [("ln_f", (D,), 0.1),
            ("s_fuse", (2 * D, D), (2 * D) ** -0.5),
            ("s_ln1", (D,), 0.1), ("s_ln2", (D,), 0.1),
            ("wq", (D, H * hd), D ** -0.5), ("wk", (D, KH * hd), D ** -0.5),
            ("wv", (D, KH * hd), D ** -0.5),
            ("wo", (H * hd, D), (H * hd) ** -0.5),
            ("w_gate", (D, Fw), D ** -0.5), ("w_up", (D, Fw), D ** -0.5),
            ("w_down", (Fw, D), Fw ** -0.5),
            ("m_ln", (L, D), 0.1),
            ("in_proj", (L, D, 2 * di + 2 * N + Hs), D ** -0.5),
            ("conv_w", (L, W, di + 2 * N), W ** -0.5),
            ("conv_b", (L, di + 2 * N), 0.1),
            ("a_log", (L, Hs), 0.5), ("d_skip", (L, Hs), 1.0),
            ("dt_bias", (L, Hs), 0.5), ("norm_scale", (L, di), 0.1),
            ("out_proj", (L, di, D), di ** -0.5)]
    return out


def mamba2(h, w: dict, i: int, cfg: dict, mm):
    """Mamba-2 layer ``i`` over the normed stream h (S, D)."""
    di, N, P, Hs, W = _mamba_sizes(cfg)
    S = h.shape[0]
    zxbcdt = mm(h, w["in_proj"][i].float())
    z, xbc, dt = (zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * N],
                  zxbcdt[:, 2 * di + 2 * N:])
    cw = w["conv_w"][i].float()
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    xbc = F.silu(sum(xp[k:k + S] * cw[k] for k in range(W))
                 + w["conv_b"][i].float())
    xs, Bm, Cm = (xbc[:, :di].reshape(S, Hs, P), xbc[:, di:di + N],
                  xbc[:, di + N:])
    dt = F.softplus(dt + w["dt_bias"][i].float())
    decay = torch.exp(-torch.exp(w["a_log"][i].float()) * dt)
    state = torch.zeros((Hs, P, N), device=h.device)
    y = torch.empty_like(xs)
    for t in range(S):
        state = (state * decay[t, :, None, None]
                 + (dt[t, :, None] * xs[t])[..., None] * Bm[t])
        y[t] = state @ Cm[t]
    y = y + w["d_skip"][i].float()[:, None] * xs
    y = rms_norm(y.reshape(S, di) * F.silu(z), w["norm_scale"][i].float(),
                 cfg["rms_norm_eps"])
    return mm(y, w["out_proj"][i].float())


@torch.no_grad()
def logits_at(cfg: dict, w: dict, tokens: torch.Tensor, at: torch.Tensor,
              mm=plain_mm) -> torch.Tensor:
    """Float32 logits (len(at), padded vocab) of ``tokens`` (S,) at the
    positions ``at``."""
    H, KH, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    eps, theta, K = cfg["rms_norm_eps"], cfg["rope_theta"], cfg["attn_every"]
    x0 = w["embed"][tokens].float()
    x, S = x0, x0.shape[0]
    for g in range(cfg["num_hidden_layers"] // K):
        f = mm(torch.cat([x, x0], dim=-1), w["s_fuse"].float())
        h = rms_norm(f, w["s_ln1"].float(), eps)
        q = rope(mm(h, w["wq"].float()).view(S, H, hd), theta)
        k = rope(mm(h, w["wk"].float()).view(S, KH, hd), theta)
        v = mm(h, w["wv"].float()).view(S, KH, hd)
        y = f + mm(causal_attention(q, k, v).reshape(S, H * hd),
                   w["wo"].float())
        y = y + glu(rms_norm(y, w["s_ln2"].float(), eps),
                    w["w_gate"].float(), w["w_up"].float(),
                    w["w_down"].float(), mm)
        x = x + y
        for i in range(g * K, (g + 1) * K):
            x = x + mamba2(rms_norm(x, w["m_ln"][i].float(), eps), w, i,
                           cfg, mm)
    h = rms_norm(x[at], w["ln_f"].float(), eps)
    head = (w["embed"].float().T if cfg["tie_word_embeddings"]
            else w["unembed"].float())
    return mm(h, head)
