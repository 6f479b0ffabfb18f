"""build_model(cfg) → Model: weights / prefill / decode / cache specs.

The dense decoder of the JAX package's ``_build_decoder`` on torch. The
other families (MoE, RWKV-6, hybrid Mamba-2, encoder-decoder) and the
vision frontend are ported with their kernels in slice 3; asking for
them raises. :func:`params_from_jax` loads the reference's
``init_params`` tree (as numpy arrays, layers stacked on the leading
axis) into the port's weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fleet import check_device
from repro_torch.models import transformer as tfm
from repro_torch.models.kvcache import dense_cache_shape
from repro_torch.models.layers import (Embedding, Norm, apply_norm, cdtype,
                                       embed, pdtype, unembed)


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


class Decoder(nn.Module):
    """The weights: ``tok`` (embed/unembed), ``layers`` and ``ln_f``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.tok = Embedding(cfg, gen, device)
        self.layers = nn.ModuleList(tfm.Block(cfg, gen, device)
                                    for _ in range(cfg.num_layers))
        self.ln_f = Norm(cfg, device)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    params: Decoder
    prefill_fn: Callable[..., Any]       # (params, batch) -> (last_logits, cache)
    decode_fn: Callable[..., Any]        # (params, cache, token, pos) -> (logits, cache)
    cache_specs: Callable[..., Any]      # (batch, max_len) -> {name: TensorSpec}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is ported in slice 3 (MoE, RWKV-6, "
            f"hybrid, encoder-decoder)")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} is ported in slice 3")


def _last_logits(params: Decoder, x, cfg: ModelConfig):
    x = apply_norm(params.ln_f, x[:, -1:], cfg)
    return unembed(params.tok, x, cfg)[:, 0]


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: torch.Generator | None = None) -> Model:
    """The dense decoder on ``device`` with weights drawn from
    ``generator`` (a fresh one seeded 0 on ``device`` when None)."""
    _check_family(cfg)
    dev = check_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = Decoder(cfg, generator, dev)

    def prefill_fn(params: Decoder, batch):
        with torch.no_grad():
            x = embed(params.tok, batch["tokens"], cfg)
            S = x.shape[1]
            positions = torch.arange(S, device=x.device)[None, :]
            x, (k, v) = tfm.decoder_stack(params.layers, x, cfg, positions,
                                          collect_cache=True)
            if cfg.attention == "swa" and k.shape[2] > cfg.window:
                k = k[:, :, -cfg.window:]
                v = v[:, :, -cfg.window:]
            return _last_logits(params, x, cfg), {"k": k, "v": v}

    def decode_fn(params: Decoder, cache, token, pos):
        with torch.no_grad():
            x = embed(params.tok, token[:, None], cfg)
            x, cache = tfm.decode_step_stack(params.layers, x, cfg, cache,
                                             pos)
            return _last_logits(params, x, cfg), cache

    def cache_specs(batch, max_len):
        shape = dense_cache_shape(cfg, batch, max_len)
        return {"k": TensorSpec(shape, torch.bfloat16),
                "v": TensorSpec(shape, torch.bfloat16)}

    return Model(cfg, params, prefill_fn, decode_fn, cache_specs)


def params_from_jax(cfg: ModelConfig, params_np, *, device="cuda") -> Decoder:
    """The port's weights from the reference's ``init_params`` tree as
    numpy arrays (``{"tok": {"embed", "unembed"}, "layers": {...}
    stacked over layers, "ln_f": {"scale"}}``). Matrices land in
    ``cfg.dtype``, norm weights in ``param_dtype``, as the port holds
    them."""
    _check_family(cfg)
    dev = check_device(device)
    w = Decoder(cfg, torch.Generator().manual_seed(0), "meta")

    def load(param: nn.Parameter, arr, dtype) -> nn.Parameter:
        t = torch.tensor(np.asarray(arr, np.float32))
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(t.shape)} for a weight of "
                             f"{tuple(param.shape)}")
        return nn.Parameter(t.to(device=dev, dtype=dtype),
                            requires_grad=False)

    cd, pd = cdtype(cfg), pdtype(cfg)

    def load_norm(norm: Norm, tree) -> None:
        norm.scale = load(norm.scale, tree["scale"], pd)
        if norm.bias is not None:
            norm.bias = load(norm.bias, tree["bias"], pd)

    w.tok.embed = load(w.tok.embed, params_np["tok"]["embed"], cd)
    if w.tok.unembed is not None:
        w.tok.unembed = load(w.tok.unembed, params_np["tok"]["unembed"], cd)
    load_norm(w.ln_f, params_np["ln_f"])
    lay = params_np["layers"]
    for i, blk in enumerate(w.layers):
        load_norm(blk.ln1, {k: a[i] for k, a in lay["ln1"].items()})
        load_norm(blk.ln2, {k: a[i] for k, a in lay["ln2"].items()})
        for name in ("wq", "wk", "wv", "wo"):
            setattr(blk.attn, name, load(getattr(blk.attn, name),
                                         lay["attn"][name][i], cd))
        for name in ("w_gate", "w_up", "w_down"):
            setattr(blk.mlp, name, load(getattr(blk.mlp, name),
                                        lay["mlp"][name][i], cd))
    return w
