"""build_model(cfg) → Model: weights / prefill / decode / cache specs.

The JAX package's ``_build_decoder``, ``_build_rwkv`` and
``_build_hybrid`` on torch: the dense decoder, RWKV-6 and the hybrid
Mamba-2 + shared-attention stack (zamba2). MoE, the encoder-decoder and
the vision frontend are ported later in slice 3; asking for them
raises. :func:`params_from_jax` loads the reference's ``init_params``
tree (as numpy arrays, layers stacked on the leading axes) into the
port's weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fleet import check_device
from repro_torch.models import transformer as tfm
from repro_torch.models.kvcache import cache_specs
from repro_torch.models.layers import (Embedding, Norm, apply_norm, embed,
                                       unembed)


class Decoder(nn.Module):
    """The weights: ``tok`` (embed/unembed), ``ln_f`` and the family's
    stack — ``layers`` (dense blocks or RWKV-6 blocks) or ``blocks``
    (the hybrid groups), named as in the reference's tree."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.tok = Embedding(cfg, gen, device)
        if cfg.family == "hybrid":
            self.blocks = tfm.HybridBlocks(cfg, gen, device)
        else:
            block = tfm.RwkvBlock if cfg.family == "rwkv6" else tfm.Block
            self.layers = nn.ModuleList(block(cfg, gen, device)
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
    if cfg.family not in ("dense", "rwkv6", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} is ported later in slice 3 (MoE, "
            f"encoder-decoder)")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} is ported later in slice 3")


def _last_logits(params: Decoder, x, cfg: ModelConfig):
    x = apply_norm(params.ln_f, x[:, -1:], cfg)
    return unembed(params.tok, x, cfg)[:, 0]


def _positions(x):
    return torch.arange(x.shape[1], device=x.device)[None, :]


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: torch.Generator | None = None) -> Model:
    """The model of ``cfg``'s family on ``device`` with weights drawn
    from ``generator`` (a fresh one seeded 0 on ``device`` when None)."""
    _check_family(cfg)
    dev = check_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    build = {"dense": _build_decoder, "rwkv6": _build_rwkv,
             "hybrid": _build_hybrid}[cfg.family]
    return build(cfg, Decoder(cfg, generator, dev))


# ---------------------------------------------------------------- dense
def _build_decoder(cfg: ModelConfig, params: Decoder) -> Model:
    def prefill_fn(params: Decoder, batch):
        with torch.no_grad():
            x = embed(params.tok, batch["tokens"], cfg)
            x, (k, v) = tfm.decoder_stack(params.layers, x, cfg,
                                          _positions(x), collect_cache=True)
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

    return Model(cfg, params, prefill_fn, decode_fn, partial(cache_specs, cfg))


# ---------------------------------------------------------------- rwkv6
def _build_rwkv(cfg: ModelConfig, params: Decoder) -> Model:
    def prefill_fn(params: Decoder, batch):
        with torch.no_grad():
            x = embed(params.tok, batch["tokens"], cfg)
            x, states = tfm.rwkv_stack(params.layers, x, cfg,
                                       collect_state=True)
            return _last_logits(params, x, cfg), states

    def decode_fn(params: Decoder, cache, token, pos):
        with torch.no_grad():
            x = embed(params.tok, token[:, None], cfg)[:, 0]
            x, cache = tfm.rwkv_decode_step(params.layers, x, cfg, cache)
            x = apply_norm(params.ln_f, x[:, None], cfg)
            return unembed(params.tok, x, cfg)[:, 0], cache

    return Model(cfg, params, prefill_fn, decode_fn, partial(cache_specs, cfg))


# ---------------------------------------------------------------- hybrid
def _build_hybrid(cfg: ModelConfig, params: Decoder) -> Model:
    def prefill_fn(params: Decoder, batch):
        with torch.no_grad():
            x = embed(params.tok, batch["tokens"], cfg)
            x, states = tfm.hybrid_stack(params.blocks, x, cfg,
                                         _positions(x), collect=True)
            return _last_logits(params, x, cfg), states

    def decode_fn(params: Decoder, cache, token, pos):
        with torch.no_grad():
            x = embed(params.tok, token[:, None], cfg)
            x, cache = tfm.hybrid_decode_step(params.blocks, x, cfg, cache,
                                              pos)
            return _last_logits(params, x, cfg), cache

    return Model(cfg, params, prefill_fn, decode_fn, partial(cache_specs, cfg))


# ---------------------------------------------------------------- weights
def _index(tree, i: int):
    """Layer ``i`` of a tree whose leaves are stacked on the leading
    axis."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _load(module: nn.Module, tree, dev) -> None:
    """Replace each weight of ``module`` with the array of the same name
    in ``tree``, in the dtype the port holds that weight in (module lists
    take the stacked leading axes)."""
    if isinstance(module, nn.ModuleList):
        for i, child in enumerate(module):
            _load(child, _index(tree, i), dev)
        return
    for name, param in list(module.named_parameters(recurse=False)):
        t = torch.tensor(np.asarray(tree[name], np.float32))
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} for a weight "
                             f"of {tuple(param.shape)}")
        setattr(module, name, nn.Parameter(
            t.to(device=dev, dtype=param.dtype), requires_grad=False))
    for name, child in module.named_children():
        _load(child, tree[name], dev)


def params_from_jax(cfg: ModelConfig, params_np, *, device="cuda") -> Decoder:
    """The port's weights from the reference's ``init_params`` tree as
    numpy arrays (``{"tok": {"embed", "unembed"}, "layers" or "blocks":
    {...} stacked over layers, "ln_f": {...}}``). Each weight lands in
    the dtype the port holds it in: matrices in ``cfg.dtype``, weights
    the reference uses in f32 (norms, decays) in ``param_dtype``."""
    _check_family(cfg)
    dev = check_device(device)
    w = Decoder(cfg, torch.Generator().manual_seed(0), "meta")
    _load(w, params_np, dev)
    return w
