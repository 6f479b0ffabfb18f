"""build_model(cfg) → Model: weights / loss / prefill / decode / specs.

The JAX package's ``_build_decoder``, ``_build_rwkv``, ``_build_hybrid``
and ``_build_encdec`` on torch: the dense and MoE decoders, RWKV-6, the
hybrid Mamba-2 + shared-attention stack (zamba2) and the
encoder-decoder (whisper, whose conv frontend is a stub: ``frames``
come precomputed). The vision stub (llava) trains and prefills from
precomputed ``embeds`` in place of tokens; decode starts from tokens.

``build_model(cfg, trainable=True)`` holds f32 master weights that
require grad (:mod:`repro_torch.models.layers`); ``loss_fn`` is the
reference's (``loss + 0.01·aux``, metrics ``loss``, ``aux``, ``ntok``)
and, while autograd records, runs every attention and recurrence on its
plain differentiable version, never on the forward-only kernels.
:func:`params_from_jax` loads the reference's ``init_params`` tree (as
numpy arrays, layers stacked on the leading axes) into the port's
weights, frozen for serving or trainable; :func:`params_to_jax` gives
that tree back from the port's weights, which is how a checkpoint is
laid out and how trained weights reach a serving model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.fleet import check_device
from repro_torch.models import transformer as tfm
from repro_torch.models.kvcache import TensorSpec, cache_specs
from repro_torch.models.layers import (Embedding, Norm, apply_norm, cdtype,
                                       cross_entropy, dense_init, embed,
                                       unembed)


class Decoder(nn.Module):
    """The weights: ``tok`` (embed/unembed), ``ln_f`` and the family's
    stack — ``layers`` (dense or MoE blocks, RWKV-6 blocks, or the
    encoder-decoder's cross blocks, beside its ``frontend_proj``,
    ``enc_layers`` and ``ln_enc``) or ``blocks`` (the hybrid groups),
    named as in the reference's tree."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.tok = Embedding(cfg, gen, device)
        if cfg.family == "hybrid":
            self.blocks = tfm.HybridBlocks(cfg, gen, device)
        elif cfg.family == "rwkv6":
            self.layers = nn.ModuleList(tfm.RwkvBlock(cfg, gen, device)
                                        for _ in range(cfg.num_layers))
        else:
            cross = cfg.family == "encdec"
            if cross:
                self.frontend_proj = dense_init(gen, cfg.d_model, cfg.d_model,
                                                cdtype(cfg), device)
                self.enc_layers = nn.ModuleList(
                    tfm.Block(cfg, gen, device)
                    for _ in range(cfg.num_encoder_layers))
                self.ln_enc = Norm(cfg, device)
            self.layers = nn.ModuleList(tfm.Block(cfg, gen, device, cross)
                                        for _ in range(cfg.num_layers))
        self.ln_f = Norm(cfg, device)


def _weights(cfg: ModelConfig, gen: torch.Generator, dev,
             trainable: bool) -> Decoder:
    """Frozen serving weights, or trainable ones: every weight built in
    ``param_dtype`` (the compute dtype stays ``cfg.dtype``), requiring
    grad."""
    if not trainable:
        return Decoder(cfg, gen, dev)
    master = dataclasses.replace(cfg, dtype=cfg.param_dtype)
    return Decoder(master, gen, dev).requires_grad_(True)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    params: Decoder
    prefill_fn: Callable[..., Any]       # (params, batch) -> (last_logits, cache)
    decode_fn: Callable[..., Any]        # (params, cache, token, pos) -> (logits, cache)
    cache_specs: Callable[..., Any]      # (batch, max_len) -> {name: TensorSpec}
    loss_fn: Callable[..., Any]          # (params, batch) -> (loss, metrics)
    logits_fn: Callable[..., Any]        # (params, batch) -> f32 logits (B, S, V)
    input_specs: Callable[..., Any]      # (ShapeConfig) -> {name: TensorSpec}
    init_params: Callable[..., Any]      # (seed) -> fresh weights like params


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _BUILD_BY_FAMILY:
        raise ValueError(f"unknown family {cfg.family}")


def _lm_logits(params: Decoder, x, cfg: ModelConfig):
    return unembed(params.tok, apply_norm(params.ln_f, x, cfg), cfg)


def _lm_loss(logits, batch, aux):
    """The reference's ``_lm_loss`` on the logits: (loss + 0.01·aux,
    {"loss", "aux", "ntok"})."""
    loss, ntok = cross_entropy(logits, batch["labels"].long(),
                               batch.get("mask"))
    return loss + 0.01 * aux, {"loss": loss, "aux": aux, "ntok": ntok}


def _no_aux(x):
    return x.new_zeros((), dtype=torch.float32)


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """{name: TensorSpec} of the batch of ``shape.kind``: "train"
    (tokens, or the vision stub's ``embeds``, then ``labels``; the
    encoder-decoder's ``frames`` first), "prefill" (the same without
    labels) or "decode" (``token``, ``pos`` and the ``cache`` specs),
    as the reference's ``input_specs``. Token ids are int64, the
    port's index dtype (the reference's are int32)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": TensorSpec((B,), torch.int64, 0),
                "pos": TensorSpec((B,), torch.int64, 0),
                "cache": cache_specs(cfg, B, S)}
    d = {}
    if cfg.is_encoder_decoder:
        Se = max(S // cfg.encoder_seq_ratio, 1)
        d["frames"] = TensorSpec((B, Se, cfg.d_model), torch.bfloat16, 0, 1)
    if cfg.frontend == "vision":
        d["embeds"] = TensorSpec((B, S, cfg.d_model), torch.bfloat16, 0, 1)
    else:
        d["tokens"] = TensorSpec((B, S), torch.int64, 0, 1)
    if shape.kind == "train":
        d["labels"] = TensorSpec((B, S), torch.int64, 0, 1)
    return d


def _inputs_to_embeds(params: Decoder, batch, cfg: ModelConfig):
    """Tokens, or the vision stub's precomputed ``embeds`` (B, S, D) in
    the compute dtype, → (B, S, D)."""
    if "embeds" in batch:
        return batch["embeds"].to(cdtype(cfg))
    return embed(params.tok, batch["tokens"], cfg)


def _last_logits(params: Decoder, x, cfg: ModelConfig):
    x = apply_norm(params.ln_f, x[:, -1:], cfg)
    return unembed(params.tok, x, cfg)[:, 0]


def _positions(x):
    return torch.arange(x.shape[1], device=x.device)[None, :]


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: torch.Generator | None = None,
                trainable: bool = False) -> Model:
    """The model of ``cfg``'s family on ``device`` with weights drawn
    from ``generator`` (a fresh one seeded 0 on ``device`` when None):
    frozen, matrices in ``cfg.dtype``, for serving; with ``trainable``
    f32 masters that require grad."""
    _check_family(cfg)
    dev = check_device(device)

    def init_params(seed: int = 0) -> Decoder:
        """Fresh weights drawn from ``seed`` on the model's device (on
        ``meta``, shapes only)."""
        gen = torch.Generator(device="cpu" if dev.type == "meta"
                              else dev).manual_seed(seed)
        return _weights(cfg, gen, dev, trainable)

    params = (init_params() if generator is None
              else _weights(cfg, generator, dev, trainable))
    prefill_fn, decode_fn, trunk = _BUILD_BY_FAMILY[cfg.family](cfg)

    def logits_fn(params: Decoder, batch):
        return _lm_logits(params, trunk(params, batch)[0], cfg)

    def loss_fn(params: Decoder, batch):
        x, aux = trunk(params, batch)
        return _lm_loss(_lm_logits(params, x, cfg), batch, aux)

    return Model(cfg, params, prefill_fn, decode_fn,
                 partial(cache_specs, cfg), loss_fn, logits_fn,
                 partial(input_specs, cfg), init_params)


# ---------------------------------------------------------------- dense / moe
def _decoder_decode_fn(cfg: ModelConfig):
    """The decode step of the dense, MoE and encoder-decoder models."""
    def decode_fn(params: Decoder, cache, token, pos):
        with torch.no_grad():
            x = embed(params.tok, token[:, None], cfg)
            x, cache = tfm.decode_step_stack(params.layers, x, cfg, cache,
                                             pos)
            return _last_logits(params, x, cfg), cache
    return decode_fn


def _build_decoder(cfg: ModelConfig):
    """(prefill_fn, decode_fn, trunk): ``trunk(params, batch)`` is the
    training forward up to the final norm, (x, aux)."""
    def trunk(params: Decoder, batch):
        x = _inputs_to_embeds(params, batch, cfg)
        x, _, aux = tfm.decoder_stack(params.layers, x, cfg, _positions(x))
        return x, aux

    def prefill_fn(params: Decoder, batch):
        with torch.no_grad():
            x = _inputs_to_embeds(params, batch, cfg)
            x, (k, v), _ = tfm.decoder_stack(params.layers, x, cfg,
                                             _positions(x),
                                             collect_cache=True)
            if cfg.attention == "swa" and k.shape[2] > cfg.window:
                k = k[:, :, -cfg.window:]
                v = v[:, :, -cfg.window:]
            return _last_logits(params, x, cfg), {"k": k, "v": v}

    return prefill_fn, _decoder_decode_fn(cfg), trunk


# ---------------------------------------------------------------- rwkv6
def _build_rwkv(cfg: ModelConfig):
    def trunk(params: Decoder, batch):
        x = _inputs_to_embeds(params, batch, cfg)
        return tfm.rwkv_stack(params.layers, x, cfg)[0], _no_aux(x)

    def prefill_fn(params: Decoder, batch):
        with torch.no_grad():
            x = _inputs_to_embeds(params, batch, cfg)
            x, states = tfm.rwkv_stack(params.layers, x, cfg,
                                       collect_state=True)
            return _last_logits(params, x, cfg), states

    def decode_fn(params: Decoder, cache, token, pos):
        with torch.no_grad():
            x = embed(params.tok, token[:, None], cfg)[:, 0]
            x, cache = tfm.rwkv_decode_step(params.layers, x, cfg, cache)
            x = apply_norm(params.ln_f, x[:, None], cfg)
            return unembed(params.tok, x, cfg)[:, 0], cache

    return prefill_fn, decode_fn, trunk


# ---------------------------------------------------------------- hybrid
def _build_hybrid(cfg: ModelConfig):
    def trunk(params: Decoder, batch):
        x = _inputs_to_embeds(params, batch, cfg)
        return (tfm.hybrid_stack(params.blocks, x, cfg, _positions(x))[0],
                _no_aux(x))

    def prefill_fn(params: Decoder, batch):
        with torch.no_grad():
            x = _inputs_to_embeds(params, batch, cfg)
            x, states = tfm.hybrid_stack(params.blocks, x, cfg,
                                         _positions(x), collect=True)
            return _last_logits(params, x, cfg), states

    def decode_fn(params: Decoder, cache, token, pos):
        with torch.no_grad():
            x = embed(params.tok, token[:, None], cfg)
            x, cache = tfm.hybrid_decode_step(params.blocks, x, cfg, cache,
                                              pos)
            return _last_logits(params, x, cfg), cache

    return prefill_fn, decode_fn, trunk


# ---------------------------------------------------------------- encdec
def _build_encdec(cfg: ModelConfig):
    def encode(params: Decoder, frames):
        dt = cdtype(cfg)
        x = frames.to(dt) @ params.frontend_proj.to(dt)
        x, _, _ = tfm.decoder_stack(params.enc_layers, x, cfg,
                                    _positions(x), causal=False)
        return apply_norm(params.ln_enc, x, cfg)

    def trunk(params: Decoder, batch):
        """batch: ``tokens``, ``labels`` (B, S) and ``frames`` (B, Se,
        D)."""
        enc = encode(params, batch["frames"])
        x = embed(params.tok, batch["tokens"], cfg)
        x, _, aux = tfm.decoder_stack(params.layers, x, cfg, _positions(x),
                                      enc_out=enc)
        return x, aux

    def prefill_fn(params: Decoder, batch):
        """batch: ``tokens`` (B, S) and ``frames`` (B, Se, D)."""
        with torch.no_grad():
            enc = encode(params, batch["frames"])
            x = embed(params.tok, batch["tokens"], cfg)
            x, (k, v), _ = tfm.decoder_stack(params.layers, x, cfg,
                                             _positions(x), enc_out=enc,
                                             collect_cache=True)
            # cross K/V per decoder layer, computed once for decode
            ck, cv = zip(*(tfm.cross_kv(p.cross, enc, cfg)
                           for p in params.layers))
            cache = {"k": k, "v": v, "ck": torch.stack(ck),
                     "cv": torch.stack(cv)}
            return _last_logits(params, x, cfg), cache

    return prefill_fn, _decoder_decode_fn(cfg), trunk


_BUILD_BY_FAMILY = {"dense": _build_decoder, "moe": _build_decoder,
                    "rwkv6": _build_rwkv, "hybrid": _build_hybrid,
                    "encdec": _build_encdec}


# ---------------------------------------------------------------- weights
def _index(tree, i: int):
    """Layer ``i`` of a tree whose leaves are stacked on the leading
    axis."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _load(module: nn.Module, tree, dev) -> None:
    """Replace each weight of ``module`` with the array of the same name
    in ``tree`` (:func:`unstack_tree`), in the dtype the port holds that
    weight in and with its ``requires_grad``."""
    for name, arr in unstack_tree(module, tree).items():
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        param = getattr(owner, attr)
        t = torch.tensor(np.asarray(arr, np.float32))
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} for a weight "
                             f"of {tuple(param.shape)}")
        setattr(owner, attr, nn.Parameter(
            t.to(device=dev, dtype=param.dtype),
            requires_grad=param.requires_grad))


def params_from_jax(cfg: ModelConfig, params_np, *, device="cuda",
                    trainable: bool = False) -> Decoder:
    """The port's weights from the reference's ``init_params`` tree as
    numpy arrays (``{"tok": {"embed", "unembed"}, "layers" or "blocks":
    {...} stacked over layers, "ln_f": {...}}``, and the
    encoder-decoder's ``frontend_proj``, ``enc_layers`` and
    ``ln_enc``). Each weight lands in the dtype the port holds it in:
    for serving, frozen, matrices in ``cfg.dtype`` and weights the
    reference uses in f32 (norms, decays) in ``param_dtype``; with
    ``trainable``, every weight an f32 master that requires grad."""
    _check_family(cfg)
    dev = check_device(device)
    w = _weights(cfg, torch.Generator().manual_seed(0), "meta", trainable)
    _load(w, params_np, dev)
    return w


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def weight_tree(module: nn.Module, leaf=lambda name, p: p):
    """The reference's nested-dict layout of ``module``'s weights, each
    leaf ``leaf(qualified name, parameter)`` (torch tensors), module
    lists stacked on a new leading axis, as ``init_params`` stacks
    layers."""
    def walk(m: nn.Module, prefix: str):
        if isinstance(m, nn.ModuleList):
            return _stack([walk(c, f"{prefix}{i}.") for i, c in enumerate(m)])
        out = {n: leaf(prefix + n, p)
               for n, p in m.named_parameters(recurse=False)}
        for n, child in m.named_children():
            out[n] = walk(child, f"{prefix}{n}.")
        return out
    return walk(module, "")


def unstack_tree(module: nn.Module, tree) -> dict:
    """The inverse of :func:`weight_tree`: {qualified name: tensor} of
    ``module``'s weights from a tree in the reference's layout (views of
    the tree's leaves)."""
    out = {}

    def walk(m: nn.Module, t, prefix: str):
        if isinstance(m, nn.ModuleList):
            for i, c in enumerate(m):
                walk(c, _index(t, i), f"{prefix}{i}.")
            return
        for n, _ in m.named_parameters(recurse=False):
            out[prefix + n] = t[n]
        for n, child in m.named_children():
            walk(child, t[n], f"{prefix}{n}.")
    walk(module, tree, "")
    return out


def params_to_jax(params: Decoder) -> dict:
    """The reference's ``init_params`` tree of the port's weights as f32
    numpy arrays (layers stacked on the leading axes): what
    :func:`params_from_jax` takes, and what the reference's model
    runs."""
    def numpy(tree):
        if isinstance(tree, dict):
            return {k: numpy(v) for k, v in tree.items()}
        return tree.numpy()
    return numpy(weight_tree(params, lambda n, p: p.detach().float().cpu()))
