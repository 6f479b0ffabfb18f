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

``moe_strategy="tp"`` is the reference's ``moe_ffn_tp``: without a mesh
the same local function; under one (:mod:`repro_torch.parallel.sharding`)
the experts F-sharded over "model" and one sum of the combined output.
The default strategy on DTensors (the launcher's placed state) keeps
the reference's dispatch over the whole batch: DTensor has no rules for
its sorts and scatters, so the tokens are gathered over the data axes
and routed on every rank, each rank runs the experts it holds
(expert-parallel over "model", as the weights are placed; they are
never gathered) and their outputs are gathered over "model".
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (GLUMLP, act_fn, cdtype, dense_init,
                                       glu_mlp, normal_init)
from repro_torch.parallel.sharding import (P, current_mesh, data_axes,
                                           fit_spec, is_dtensor, placements,
                                           replicated_like)

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
    if cfg.moe_strategy == "tp":
        return moe_ffn_tp(p, x, cfg)
    if is_dtensor(x):
        return _moe_ffn_ep(p, x, cfg)
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    out, aux = _moe_local_body(p, xf, cfg)
    if p.dense is not None:
        out = out + glu_mlp(p.dense, xf, cfg)
    return out.reshape(B, S, D), aux


def _weights(p: MoE, fn):
    """A namespace of ``p``'s expert weights, each ``fn(name, weight)``."""
    return SimpleNamespace(
        router=fn("router", p.router), w_gate=fn("w_gate", p.w_gate),
        w_up=fn("w_up", p.w_up), w_down=fn("w_down", p.w_down))


def _moe_local_body(p, xf, cfg: ModelConfig, *, experts=expert_glu,
                    enter=lambda t: t):
    """Route, dispatch, the expert GLU and the combine for a slab of
    tokens xf (T, D), without the dense residual; ``p`` is an
    :class:`MoE` or anything with its expert weights' names.
    ``experts(p, h, cfg)`` maps the (E, C, D) buffer to the experts'
    outputs; ``enter`` is applied to the tokens and gates where they
    enter the experts and the combine (the ``tp`` strategy's
    all-reduce of their gradients). Returns (out (T, D), aux)."""
    dt = cdtype(cfg)
    T, D = xf.shape
    E, k = cfg.num_experts, cfg.experts_per_token

    gates, idx, probs = router_topk(xf @ p.router.to(dt), k)
    aux = load_balance_loss(probs, idx, E)
    C = capacity(cfg, T)
    order, slot, valid = dispatch(idx, E, C)
    tok = order // k

    buf = torch.zeros((E * C + 1, D), dtype=dt, device=xf.device)
    buf[slot] = enter(xf)[tok]
    y = experts(p, buf[:E * C].view(E, C, D), cfg)
    y = torch.cat([y.reshape(E * C, D), y.new_zeros((1, D))])

    # weighted rows back in (token, choice) order, then each token's k
    # choices summed in a fixed order (no scatter-add)
    gsort = enter(gates.reshape(-1)[order].to(dt) * valid.to(dt))
    rows = torch.empty((T * k, D), dtype=dt, device=xf.device)
    rows[order] = y[slot] * gsort[:, None]
    rows = rows.view(T, k, D)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out, aux


def _replicated(t):
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _moe_ffn_ep(p: MoE, x, cfg: ModelConfig):
    """The default strategy on DTensors: routing, dispatch and combine
    over the whole batch on every rank (the reference's dispatch and
    capacity are over the global batch), each rank's own experts —
    its block of E over "model", as the weights are placed, all of them
    where the model axis does not divide E — and one gather of their
    (E, C, D) outputs over "model". The dense residual runs on ``x`` as
    placed. The output comes back placed as ``x`` came."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    B, S, D = x.shape
    mesh = x.device_mesh
    xr = _replicated(x)                 # the tokens, gathered over data

    rep = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    m = names.index("model") if "model" in names else None
    El = cfg.num_experts
    ep = [Replicate()] * mesh.ndim
    if m is not None and cfg.num_experts % mesh.size(m) == 0:
        El = cfg.num_experts // mesh.size(m)
        ep[m] = Shard(0)

    def own_experts(q, h, cfg):
        local = SimpleNamespace(**{
            n: getattr(q, n).redistribute(mesh, ep).to_local()
            for n in ("w_gate", "w_up", "w_down")})
        if El == cfg.num_experts:
            return expert_glu(local, h, cfg)
        # this rank's experts' rows; backward, their gradients gathered
        # over "model", so that every rank's token gradients are whole
        hl = DTensor.from_local(h, mesh, rep, run_check=False).redistribute(
            mesh, ep).to_local()
        y = expert_glu(local, hl, cfg)
        return _replicated(DTensor.from_local(y, mesh, ep,
                                              run_check=False)).to_local()

    q = SimpleNamespace(router=_replicated(p.router).to_local(),
                        w_gate=p.w_gate, w_up=p.w_up, w_down=p.w_down)
    out, aux = _moe_local_body(q, xr.to_local().reshape(B * S, D), cfg,
                               experts=own_experts)
    # back in x's layout, a partial sum of it taken as reduced
    back = [Replicate() if pl.is_partial() else pl for pl in x.placements]
    out = DTensor.from_local(out.reshape(B, S, D), mesh, rep,
                             run_check=False).redistribute(mesh, back)
    if p.dense is not None:
        out = out + glu_mlp(p.dense, x, cfg)
    return out, DTensor.from_local(aux, mesh, rep, run_check=False)


# ---------------------------------------------------------------- tp
class _SumOverGroup(torch.autograd.Function):
    """The sum of x over a process group; the gradient passes through
    unchanged, as every rank of the group holds the same downstream
    loss (the backward of a row-parallel reduction)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterGroup(torch.autograd.Function):
    """x as it is, where a value that every rank of a group holds alike
    enters work split over the group; its gradient, a partial one on
    each rank, summed over the group (the forward of a column-parallel
    product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _local(t, spec, mesh):
    """This rank's block of ``t`` laid out by ``spec`` on ``mesh``: a
    DTensor redistributed to it (differentiably; its gradient is a
    partial sum over the data axes where ``t`` is replicated there, as
    each data shard gives its tokens' part), a full tensor narrowed to
    it (one axis name an entry)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Partial, Replicate
        daxes = data_axes()
        pl = placements(spec, mesh)
        grad_pl = [Partial() if name in daxes and q == Replicate() else q
                   for name, q in zip(mesh.axis_names, pl)]
        return t.redistribute(t.device_mesh, pl).to_local(
            grad_placements=grad_pl)
    for d, axis in enumerate(spec):
        if axis is not None:
            n = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
            i = mesh.device_mesh.get_local_rank(axis) if n > 1 else 0
            t = t.narrow(d, i * (t.shape[d] // n), t.shape[d] // n)
    return t


def moe_ffn_tp(p: MoE, x, cfg: ModelConfig):
    """Tensor-parallel experts (the reference's ``moe_ffn_tp``). Without
    a mesh, the local function. Under a mesh: router, dispatch and
    combine stay local to each data shard (no token crosses a shard),
    the expert weights — and arctic's dense residual — are F-sharded
    over "model" where d_ff divides, and the combine runs on the
    F-partial outputs before the reduction, so the only collectives are
    ONE sum of the combined (T_local, D) output over "model" and the aux
    loss's mean over the data axes (and, backward, the sums over "model"
    of the tokens' and gates' gradients where they enter the F-sharded
    work, so that every rank's router and token gradients are whole).
    ``x`` and the weights are DTensors (taken to this rank's blocks) or
    full tensors on every rank (cut to them); ``out`` comes back as
    ``x`` came."""
    mesh = current_mesh()
    B, S, D = x.shape
    if mesh is None:
        xf = x.reshape(B * S, D)
        out, aux = _moe_local_body(p, xf, cfg)
        if p.dense is not None:
            out = out + glu_mlp(p.dense, xf, cfg)
        return out.reshape(B, S, D), aux

    daxes = tuple(a for a in data_axes() if a in mesh.axis_names)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    nshards = 1
    for a in daxes:
        nshards *= sizes[a]
    msize = sizes.get("model", 1)
    f_ok = "model" in sizes and cfg.d_ff % msize == 0
    split = f_ok and msize > 1
    # expert-stacked (3-D) and dense-residual (2-D) GLU weights are both
    # F-sharded, so every contribution to ``out`` is an F-partial sum
    # and the single sum reduces them together
    specs = {"w_gate": P(None, None, "model"), "w_up": P(None, None, "model"),
             "w_down": P(None, "model", None),
             "dense.w_gate": P(None, "model"), "dense.w_up": P(None, "model"),
             "dense.w_down": P("model", None)}

    def cut(n, t):
        return _local(t, specs.get(n, P()) if f_ok else P(), mesh)
    local = _weights(p, cut)
    group = mesh.device_mesh.get_group("model") if split else None

    def enter(t):
        return _EnterGroup.apply(t, group) if split else t
    d = daxes if len(daxes) > 1 else daxes[0]
    xspec = fit_spec(x.shape, P(d, None, None), mesh) if is_dtensor(x) \
        else P()
    xl = _local(x, xspec, mesh)
    Bl = xl.shape[0]
    xf = xl.reshape(Bl * S, D)
    out, aux = _moe_local_body(local, xf, cfg, enter=enter)
    if p.dense is not None:
        dense = SimpleNamespace(**{n: cut(f"dense.{n}", getattr(p.dense, n))
                                   for n in ("w_gate", "w_up", "w_down")})
        out = out + glu_mlp(dense, enter(xf), cfg)
    if split:
        out = _SumOverGroup.apply(out, group)
    for a in daxes:
        if sizes[a] > 1:
            aux = _SumOverGroup.apply(aux, mesh.device_mesh.get_group(a))
    aux = aux / nshards
    out = out.reshape(Bl, S, D)
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor
        out = DTensor.from_local(out, x.device_mesh, placements(xspec, mesh),
                                 run_check=False)
        aux = replicated_like(aux, x)
    return out, aux
