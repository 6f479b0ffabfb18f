"""Sharding rules: weights → PartitionSpec trees, activation constraints
(the JAX package's ``parallel/sharding.py`` over ``torch.distributed``).

Logical layout (single pod): mesh ("data", "model"); multi-pod adds a
leading "pod" axis that joins the data-parallel group.

Conventions:
  * column-parallel (D → X) weights shard their OUTPUT dim over "model";
  * row-parallel (X → D) weights shard their INPUT dim over "model";
  * expert-stacked weights shard the EXPERT dim over "model" (EP);
  * embed shards vocab over "model";
  * a dim is only sharded if the axis size divides it — otherwise that
    dim falls back to replicated.

The port keeps its own :class:`P` (a tuple of per-dim entries that
compares equal to the reference's ``PartitionSpec`` entry by entry) and
its own :class:`Mesh`, a holder of a ``DeviceMesh`` with the reference's
``axis_names`` and ``devices.shape``; the spec logic (``fit_spec``,
``param_pspec``, ``params_pspecs``, ``zero1_pspec``) is the reference's
host code and takes any object with those two attributes.

Specs key on the reference's tree: '/'-joined paths of the nested
layout that :func:`~repro_torch.models.model.weight_tree` gives, whose
leaves are stacked over layers (``layers``, ``enc_layers``: one leading
scan dim; the hybrid's ``mamba``: two, groups × layers). The port keeps
one weight per layer, without those scan dims. A stacked leaf's path
is a per-layer weight's qualified name with the layer indices taken
out, and its spec is the per-layer one behind leading scan entries
that are always None; so :func:`module_pspecs` applies the rules to
that path with no scan dims, and the stacked and the per-layer weight
shard alike.

:func:`placements` turns a fitted spec into DTensor placements, and
:func:`constrain` is a no-op outside a mesh: model code is
mesh-agnostic. Data parallelism is the batch's placement: the launcher
shards each batch over the data axes (``launch.specs.input_pspecs``),
the blocks keep their activations so (``constrain(x, "batch", ...)``,
as the reference's blocks do), and DTensor reduces the weights'
gradients over the data axes. The reference's ``shard_map`` shim (a
jax-version adapter) has no counterpart.
"""
from __future__ import annotations

import contextlib
import re
import threading

import numpy as np
import torch

_ctx = threading.local()


class P(tuple):
    """PartitionSpec: one entry per tensor dim, None (replicated), a mesh
    axis name or a tuple of them; trailing dims left out are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


class Mesh:
    """A named device mesh: ``axis_names`` and ``devices`` (the ranks, an
    array of the mesh's shape) as the reference's ``jax.sharding.Mesh``
    has them, over a ``DeviceMesh`` (``device_mesh``; None for a mesh of
    one rank built without a process group)."""

    def __init__(self, device_mesh, axis_names: tuple, devices=None):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.devices = (np.asarray(device_mesh.mesh) if devices is None
                        else np.asarray(devices))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.devices.shape))}, "
                f"{self.device_mesh.device_type if self.device_mesh else ''})")


def current_mesh() -> Mesh | None:
    return getattr(_ctx, "mesh", None)


def data_axes() -> tuple[str, ...]:
    mesh = current_mesh()
    if mesh is None:
        return ("data",)
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    prev = getattr(_ctx, "mesh", None)
    _ctx.mesh = mesh
    try:
        yield mesh
    finally:
        _ctx.mesh = prev


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= dict(zip(mesh.axis_names, mesh.devices.shape))[a]
    return n


def fit_spec(shape, spec: P, mesh=None) -> P:
    """Drop sharding on dims the mesh axis doesn't divide evenly."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return spec
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            out.append(None)
            continue
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        axes_t = tuple(a for a in axes_t if a in mesh.axis_names)
        if axes_t and dim % _axis_size(mesh, axes_t) == 0:
            out.append(axes_t if len(axes_t) > 1 else axes_t[0])
        else:
            out.append(None)
    return P(*out)


def placements(spec: P, mesh: Mesh) -> tuple:
    """DTensor placements of a fitted ``spec`` on ``mesh``: ``Shard(d)`` on
    each mesh dim that entry ``d`` names (a tuple of axes shards dim d
    over each, the first major, as jax orders them), ``Replicate()`` on
    the others and on any axis of size 1 (a shard of one is the whole,
    and DTensor's view rules refuse to merge a dim sharded even so)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    sizes = mesh.devices.shape
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes,) if isinstance(axes, str) else axes:
            i = mesh.axis_names.index(a)
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *axes):
    """Redistribute a DTensor to the fitted spec of ``axes`` (per-dim axis
    names; "batch" is sugar for the (pod,)data axes); a no-op without a
    mesh, on a plain tensor and where the rank differs."""
    mesh = current_mesh()
    if mesh is None or x.ndim != len(axes) or not is_dtensor(x):
        return x
    named = tuple(data_axes() if a == "batch" else a for a in axes)
    spec = fit_spec(x.shape, P(*named), mesh)
    return x.redistribute(x.device_mesh, placements(spec, mesh))


def place(t: torch.Tensor, mesh: Mesh | None, spec: P):
    """``t`` (the full tensor, on every rank) as a DTensor of ``spec`` on
    ``mesh``; ``t`` itself on a mesh of one rank, where every placement
    is Replicate and the single-card route runs unchanged."""
    if mesh is None or mesh.size == 1:
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh.device_mesh, placements(spec, mesh))


def replicate_model(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered over the "model" axis, around an op whose
    DTensor rule fails for a model-sharded layout; its placements on the
    data axes (the batch's shards) stay. Anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    names = t.device_mesh.mesh_dim_names
    return t.redistribute(t.device_mesh, [
        Replicate() if name == "model" else pl
        for name, pl in zip(names, t.placements)])


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor whose pending sums (``Partial`` placements: the output
    of a row-parallel product) are reduced, to Replicate on those mesh
    dims; anything else as it is. A norm reduces its f32 input so: left
    pending, the sums reach the next column-parallel product, for which
    DTensor would rather gather the weight than reduce the
    activation."""
    if not is_dtensor(t) or not any(pl.is_partial() for pl in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if pl.is_partial() else pl for pl in t.placements])


class _OnGrad(torch.autograd.Function):
    """The identity, whose backward passes the gradient through ``fn``."""

    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _on_grad(t: torch.Tensor, fn) -> torch.Tensor:
    if not is_dtensor(t) or not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _OnGrad.apply(t, fn)


def replicate_model_grad(t: torch.Tensor) -> torch.Tensor:
    """``t``, whose gradient is gathered over "model" as
    :func:`replicate_model` gathers a value; ``t`` itself where it is no
    DTensor or autograd does not record."""
    return _on_grad(t, replicate_model)


def reduce_partial_grad(t: torch.Tensor) -> torch.Tensor:
    """``t``, whose gradient is reduced as :func:`reduce_partial` reduces
    a value: the input of column-parallel products, whose backward
    leaves the gradient as pending sums over "model" (Megatron's
    conjugate all-reduce); left pending, the sums reach the
    row-parallel product's backward, where DTensor would gather the
    weight instead. ``t`` itself where it is no DTensor or autograd
    does not record."""
    return _on_grad(t, reduce_partial)


def replicated_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, the same whole tensor on every rank, as a replicated DTensor
    on ``like``'s mesh (differentiably); ``t`` itself where ``like`` is
    no DTensor."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def dtensor_axis_size(t: torch.Tensor, name: str) -> int:
    """The size of mesh axis ``name`` under DTensor ``t`` (1 where its
    mesh has no such axis)."""
    names = t.device_mesh.mesh_dim_names
    return t.device_mesh.shape[names.index(name)] if name in names else 1


def shard_offset(t: torch.Tensor, dim: int) -> int:
    """The global index of this rank's first element along ``dim`` of the
    DTensor ``t``, whose shards are even (a spec shards only the dims its
    axes divide): the mesh dims that shard ``dim``, the first major."""
    from torch.distributed.tensor import Shard

    mesh, n = t.device_mesh, 0
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            n = n * mesh.shape[i] + mesh.get_local_rank(i)
    return n * t._local_tensor.shape[dim]


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole of a DTensor as a plain tensor, gathered on every rank (a
    collective; differentiable); anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


# ------------------------------------------------------------ param rules
# matched against the '/'-joined param path, first hit wins.
_PARAM_RULES: list[tuple[str, P]] = [
    (r"(^|/)embed$", P("model", None)),
    (r"(^|/)unembed$", P(None, "model")),
    # MoE expert-stacked (E, D, F) / (E, F, D): expert-parallel
    (r"moe/w_(gate|up|down)$", P("model", None, None)),
    (r"moe/router$", P()),
    # column-parallel
    (r"(^|/)(wq|wk|wv|wg|w_gate|w_up|in_proj|w_mix1|w_dec1|fuse)$", P(None, "model")),
    (r"cross/(wq|wk|wv)$", P(None, "model")),
    (r"channel_mix/wk$", P(None, "model")),
    # row-parallel
    (r"(^|/)(wo|w_down|out_proj|w_dec2)$", P("model", None)),
    (r"channel_mix/wv$", P("model", None)),
    # rwkv mix lora second factor (5, r, D): replicate
    (r"w_mix2$", P()),
    # conv (W, C): shard channels
    (r"conv_w$", P(None, "model")),
]


def param_pspec(path: str, leaf, *, scan_dims: int = 0) -> P:
    """PartitionSpec for one param; `scan_dims` leading stacked dims get None."""
    spec = P()
    for pat, s in _PARAM_RULES:
        if re.search(pat, path):
            spec = s
            break
    return P(*((None,) * scan_dims + tuple(spec)))


_MOE_TP_RULES = [
    (r"moe/w_(gate|up)$", P(None, None, "model")),   # (E, D, F): F-sharded
    (r"moe/w_down$", P(None, "model", None)),        # (E, F, D)
]


def _scan_dims(path: str) -> int:
    if re.search(r"(^|/)(layers|enc_layers|mamba|groups)(/|$)", path):
        return 2 if re.search(r"(^|/)mamba(/|$)", path) else 1
    return 0


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def params_pspecs(params, num_layers_hint: int | None = None,
                  moe_tp: bool = False):
    """PartitionSpec tree for a weight tree in the reference's layout
    (nested dicts, layers stacked on the leading axes). Stacked layer
    params are recognised by path containing 'layers' / 'mamba' /
    'groups' — their leading scan dim(s) stay unsharded (ZeRO shards
    them instead). ``moe_tp`` switches expert weights from
    expert-parallel to the F-sharded tensor-parallel layout
    (models.moe's ``tp`` strategy)."""

    return map_with_path(lambda ps, leaf: _leaf_pspec(
        ps, leaf, moe_tp, _scan_dims(ps)), params)


def _leaf_pspec(path: str, leaf, moe_tp: bool, scan_dims: int) -> P:
    if moe_tp:
        for pat, sp in _MOE_TP_RULES:
            if re.search(pat, path):
                return P(*((None,) * scan_dims + tuple(sp)))
    return param_pspec(path, leaf, scan_dims=scan_dims)


def zero1_pspec(spec: P, shape, mesh) -> P:
    """ZeRO-1: additionally shard optimizer state over the data axes on
    the first unsharded dim that divides evenly."""
    daxes = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    n = _axis_size(mesh, daxes)
    dims = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = list(dims)
    for i, (d, s) in enumerate(zip(shape, dims)):
        if s is None and d % n == 0 and d >= n:
            out[i] = daxes if len(daxes) > 1 else daxes[0]
            break
    return P(*out)


def module_pspecs(module: torch.nn.Module, moe_tp: bool = False) -> dict:
    """{qualified name: spec} of ``module``'s weights, which the port
    keeps one per layer: :func:`params_pspecs`'s rule for the stacked
    leaf's path (the name with its layer indices taken out), without
    the leaf's leading scan entries (always None)."""
    return {n: _leaf_pspec(re.sub(r"/\d+(?=/|$)", "", n.replace(".", "/")),
                           p, moe_tp, 0)
            for n, p in module.named_parameters()}
