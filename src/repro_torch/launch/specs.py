"""Sharding specs for the launchers: cache, input and state trees (the
JAX package's ``launch/specs.py``), and :class:`StateShardings`, which
places a :class:`~repro_torch.training.train_step.TrainState` on a mesh
by them.

The spec functions are the reference's host code over any nested dict
whose leaves have a ``.shape`` (``TensorSpec``, tensors, the
reference's ShapeDtypeStructs). The reference's ``batch_pspecs`` always
returns ``{}`` and has no caller; it has no counterpart.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import (P, Mesh, fit_spec, full,
                                           map_with_path, module_pspecs,
                                           params_pspecs, place, placements,
                                           zero1_pspec)


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _leading_batch_spec(sds, mesh):
    daxes = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    d = daxes if len(daxes) > 1 else daxes[0]
    return fit_spec(sds.shape, P(*([d] + [None] * (len(sds.shape) - 1))), mesh)


def cache_pspecs(cfg: ModelConfig, cache_specs, mesh):
    """Decode-cache shardings.

    Dense KV (L,B,S,KH,hd): batch over data; kv-heads over model when they
    divide, else sequence over model (flash-decoding style partial
    softmax). SSM/RWKV states: batch over data, feature over model.
    """
    daxes = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    d = daxes if len(daxes) > 1 else daxes[0]
    msize = dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)

    def spec_for(path, sds):
        name = path.rpartition("/")[2]
        shp = sds.shape
        if name in ("k", "v", "ck", "cv", "attn_k", "attn_v"):
            # (L/G, B, S, KH, hd)
            if shp[3] % msize == 0:
                return fit_spec(shp, P(None, d, None, "model", None), mesh)
            return fit_spec(shp, P(None, d, "model", None, None), mesh)
        if name == "att_s":           # (L,B,H,K,K)
            return fit_spec(shp, P(None, d, "model", None, None), mesh)
        if name == "ssm":             # (G,K,B,H,P,N)
            return fit_spec(shp, P(None, None, d, "model", None, None), mesh)
        if name == "conv":            # (G,K,B,W-1,C)
            return fit_spec(shp, P(None, None, d, None, "model"), mesh)
        if name in ("att_x", "ffn_x"):  # (L,B,D)
            return fit_spec(shp, P(None, d, "model"), mesh)
        return fit_spec(shp, P(*([None] * len(shp))), mesh)

    return map_with_path(spec_for, cache_specs)


def input_pspecs(cfg: ModelConfig, specs, mesh):
    """PartitionSpec tree matching ``model.input_specs(shape)``."""
    out = {}
    for name, sds in specs.items():
        if name == "cache":
            out[name] = cache_pspecs(cfg, sds, mesh)
        else:
            out[name] = _leading_batch_spec(sds, mesh)
    return out


def state_pspecs(params_sds, opt_sds, mesh, zero1: bool = True,
                 moe_tp: bool = False):
    """TrainState shardings of a weight tree in the reference's layout:
    params by rules; m/v additionally ZeRO-1 sharded over the data
    axes."""
    p_specs = params_pspecs(params_sds, moe_tp=moe_tp)
    p_specs = _map2(lambda sds, sp: fit_spec(sds.shape, sp, mesh),
                    params_sds, p_specs)

    def z(sds, sp):
        if not zero1:
            return sp
        return zero1_pspec(sp, sds.shape, mesh)

    m_specs = _map2(z, params_sds, p_specs)
    return p_specs, m_specs


class StateShardings(NamedTuple):
    """Where a TrainState's tensors live on ``mesh``: ``params`` and
    ``moments``, {qualified weight name: fitted spec}. The weights take
    :func:`state_pspecs`'s rules through
    :func:`~repro_torch.parallel.sharding.module_pspecs` (their stacked
    leaf's spec, scan entries dropped). ZeRO-1 shards each moment over
    the data axes on the first unsharded dim of the weight the port
    holds that divides — the reference's rule on its stacked leaf picks
    the scan dim where that divides, which a per-layer weight lacks; a
    rank keeps 1/n of every layer's moments instead of all of 1/n of
    the layers. The step counter stays replicated."""
    mesh: Mesh
    params: dict
    moments: dict

    @classmethod
    def of(cls, module, mesh: Mesh, zero1: bool = True,
           moe_tp: bool = False) -> "StateShardings":
        raw = module_pspecs(module, moe_tp=moe_tp)
        ps, ms = {}, {}
        for n, p in module.named_parameters():
            ps[n] = fit_spec(p.shape, raw[n], mesh)
            ms[n] = zero1_pspec(ps[n], p.shape, mesh) if zero1 else ps[n]
        return cls(mesh, ps, ms)

    def place(self, state):
        """``state`` with every weight and moment a DTensor of its spec
        (gathered first where it was placed otherwise); on a mesh of one
        rank, the state as it is."""
        from repro_torch.training.optimizer import OptState
        from repro_torch.training.train_step import TrainState

        if self.mesh.size == 1:
            return state
        self.place_params(state.params)
        opt = state.opt
        return TrainState(state.params, OptState(
            step=full(opt.step),
            m={n: place(full(t), self.mesh, self.moments[n])
               for n, t in opt.m.items()},
            v={n: place(full(t), self.mesh, self.moments[n])
               for n, t in opt.v.items()}))

    def place_params(self, module) -> None:
        """Replace each of ``module``'s weights with a DTensor of its spec
        (a serving model's, which has no moments); on a mesh of one rank,
        nothing."""
        from torch import nn

        if self.mesh.size == 1:
            return
        for n, p in list(module.named_parameters()):
            owner, _, attr = n.rpartition(".")
            setattr(module.get_submodule(owner), attr, nn.Parameter(
                place(full(p.detach()), self.mesh, self.params[n]),
                requires_grad=p.requires_grad))

    def constrain(self, state):
        """The reference's ``out_shardings``: each moment of a state the
        step returned redistributed to its spec (the weights keep theirs:
        the step copies into them)."""
        from repro_torch.training.optimizer import OptState
        from repro_torch.training.train_step import TrainState

        if self.mesh.size == 1:
            return state

        def to(t, spec):
            return t.redistribute(t.device_mesh,
                                  placements(spec, self.mesh))
        opt = state.opt
        return TrainState(state.params, OptState(
            step=opt.step,
            m={n: to(t, self.moments[n]) for n, t in opt.m.items()},
            v={n: to(t, self.moments[n]) for n, t in opt.v.items()}))
