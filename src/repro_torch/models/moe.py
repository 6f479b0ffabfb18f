"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch
(the JAX package's ``models/moe.py`` on torch).

Tokens are sorted by expert, gathered into a fixed-capacity (E, C, D)
buffer, run through expert-stacked GLU products (``torch.bmm`` in the
compute dtype; the reference computes them as plain einsums, outside
Pallas) and combined back weighted by their gates. Dropped tokens fall
through via the residual connection. The buffer is the reference's:
dropless (C = T) up to 4,096 tokens, so a prefill runs every expert over
every row.

The combine is deterministic: the reference's scatter-add
(``.at[tok].add``) would run on CUDA as atomics whose order, and so its
bf16 rounding, changes from run to run. Here the weighted rows go back
to their (token, choice) order through the inverse of the sort, and each
token's k choices are summed in choice order.

``moe_strategy="tp"`` is the reference's ``moe_ffn_tp``, a shard_map over
a mesh whose body without a mesh is the same local function; on one card
the port has that one function for both strategies.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (GLUMLP, act_fn, cdtype, dense_init,
                                       glu_mlp, normal_init)

#: token count up to which the buffer is dropless (C = T): decode and
#: small batches, where capacity drops would make decode diverge from
#: prefill
DROPLESS_TOKENS = 4096


class MoE(nn.Module):
    """The reference's ``moe_params``: ``router`` (D, E), ``w_gate`` and
    ``w_up`` (E, D, F), ``w_down`` (E, F, D), and ``dense`` (a GLU MLP)
    when ``moe_dense_residual`` is set (arctic)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = cdtype(cfg)
        E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.router = dense_init(gen, D, E, dt, device, scale=0.02)
        self.w_gate = normal_init(gen, (E, D, F), D ** -0.5, dt, device)
        self.w_up = normal_init(gen, (E, D, F), D ** -0.5, dt, device)
        self.w_down = normal_init(gen, (E, F, D), F ** -0.5, dt, device)
        self.dense = GLUMLP(cfg, gen, device) if cfg.moe_dense_residual \
            else None


def router_topk(logits, k: int):
    """Softmax (f32) then top-k, gates renormalised to sum 1. Returns
    (gates (T, k), idx (T, k), probs (T, E)). Equal probabilities rank
    by expert id, as ``jax.lax.top_k`` ranks them (a stable descending
    sort; ``torch.topk`` leaves ties in no stated order, and bf16 router
    logits tie often)."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def expert_counts(flat_e, num_experts: int):
    """Entries per expert of the flat expert ids, as int64 (a scatter-add
    of ones: ``torch.bincount`` reads the largest id back to the host,
    which would stall the stream twice a layer)."""
    return torch.zeros(num_experts, dtype=torch.int64,
                       device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))


def load_balance_loss(probs, idx, num_experts: int):
    """Switch-style auxiliary loss: E · Σ_e f_e · p_e."""
    me = probs.mean(dim=0)
    counts = expert_counts(idx.reshape(-1), num_experts).float()
    fe = counts / max(idx.numel(), 1)
    return num_experts * torch.sum(fe * me)


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: T (dropless) up to
    :data:`DROPLESS_TOKENS`, else T·k/E·capacity_factor rounded as
    Python's ``round`` does, at least 1."""
    if T <= DROPLESS_TOKENS:
        return T
    k, E = cfg.experts_per_token, cfg.num_experts
    return int(max(1, round(T * k / E * cfg.capacity_factor)))


def dispatch(idx, num_experts: int, C: int):
    """The sort-based dispatch of idx (T, k) into E·C slots: ``order``,
    the stable sort of the flat expert ids (ties keep (token, choice)
    order, as ``jnp.argsort`` does); ``slot`` (T·k,), each sorted entry's
    row of the (E·C + 1, D) buffer, E·C (the trash row) past its
    expert's capacity; ``valid``, the entries that got a slot."""
    flat_e = idx.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    counts = expert_counts(se, num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_e.numel(), device=idx.device) - starts[se]
    valid = pos < C
    slot = torch.where(valid, se * C + pos, num_experts * C)
    return order, slot, valid


def expert_glu(p: MoE, h, cfg: ModelConfig):
    """The expert-stacked GLU products: h (E, C, D) → (E, C, D), each
    expert over its C rows, in the compute dtype."""
    dt = cdtype(cfg)
    g = torch.bmm(h, p.w_gate.to(dt))
    u = torch.bmm(h, p.w_up.to(dt))
    return torch.bmm(act_fn(cfg.act)(g) * u, p.w_down.to(dt))


def moe_ffn(p: MoE, x, cfg: ModelConfig):
    """x (B, S, D) → (out (B, S, D), aux loss, a scalar f32 tensor)."""
    dt = cdtype(cfg)
    B, S, D = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.experts_per_token
    xf = x.reshape(T, D)

    gates, idx, probs = router_topk(xf @ p.router.to(dt), k)
    aux = load_balance_loss(probs, idx, E)
    C = capacity(cfg, T)
    order, slot, valid = dispatch(idx, E, C)
    tok = order // k

    buf = torch.zeros((E * C + 1, D), dtype=dt, device=x.device)
    buf[slot] = xf[tok]
    y = expert_glu(p, buf[:E * C].view(E, C, D), cfg)
    y = torch.cat([y.reshape(E * C, D), y.new_zeros((1, D))])

    # weighted rows back in (token, choice) order, then each token's k
    # choices summed in a fixed order (no scatter-add)
    gsort = gates.reshape(-1)[order].to(dt) * valid.to(dt)
    rows = torch.empty((T * k, D), dtype=dt, device=x.device)
    rows[order] = y[slot] * gsort[:, None]
    rows = rows.view(T, k, D)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]

    if p.dense is not None:
        out = out + glu_mlp(p.dense, xf, cfg)
    return out.reshape(B, S, D), aux
