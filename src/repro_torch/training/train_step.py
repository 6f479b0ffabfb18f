"""Training step factory: microbatched grad accumulation, remat (inside
the model, :func:`repro_torch.models.transformer.remat`), optional int8
gradient compression, AdamW update (the JAX package's
``training/train_step.py`` on torch).

A :class:`TrainState` holds the model's weights (an ``nn.Module`` of f32
masters that require grad, ``build_model(..., trainable=True)``) and
the optimizer state, whose moments are dicts keyed by the weights'
qualified names. ``train_step(state, batch)`` computes the gradients
with autograd, updates through the functional :func:`adamw_update`,
then moves the new weights into the module (on a mesh, copies them into
the placed weights): like the reference's
launcher, which donates the old state to ``jit``, it consumes the state
it is given. :func:`state_tree` / :func:`load_state_tree` convert a
state to and from the reference's pytree layout (weights stacked over
layers), the layout of a checkpoint.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import TrainConfig
from repro_torch.models.model import Model, unstack_tree, weight_tree
from repro_torch.parallel.compression import maybe_compress_grads
from repro_torch.parallel.sharding import is_dtensor
from repro_torch.training.optimizer import (OptState, adamw_update,
                                            init_opt_state)


class TrainState(NamedTuple):
    params: nn.Module
    opt: OptState


def weights(params: nn.Module) -> dict:
    """{qualified name: tensor} of a module's weights."""
    return dict(params.named_parameters())


def init_train_state(model: Model, seed: int = 0, *,
                     params: nn.Module | None = None) -> TrainState:
    """A fresh state: ``params`` (e.g. carried from the reference with
    ``params_from_jax(..., trainable=True)``), else weights drawn from
    ``seed``, with zero moments."""
    if params is None:
        params = model.init_params(seed)
    return TrainState(params=params, opt=init_opt_state(weights(params)))


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """(B, ...) → n batches of (B/n, ...), in order."""
    out = []
    for i in range(n):
        mb = {}
        for k, x in batch.items():
            B = x.shape[0]
            if B % n:
                raise ValueError(f"batch {B} not divisible by "
                                 f"microbatches {n}")
            mb[k] = x[i * (B // n):(i + 1) * (B // n)]
        out.append(mb)
    return out


def make_loss_and_grad(model: Model, tc: TrainConfig):
    """``(params, batch) -> (loss, metrics, grads {name: tensor})``. With
    microbatches the gradients and loss are summed in f32 over the
    microbatches, then averaged; the metrics are the last
    microbatch's. A weight the loss does not reach (the vision stub's
    token embedding) gets a zero gradient, as ``jax.grad`` gives it."""
    def grad_fn(params: nn.Module, batch):
        named = weights(params)
        loss, metrics = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    if tc.microbatches <= 1:
        return grad_fn

    def accumulated(params: nn.Module, batch):
        # zeros like each weight: on a mesh, its shard, not a whole copy
        acc = {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in weights(params).items()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(acc.values())).device)
        for mb in _split_microbatches(batch, tc.microbatches):
            loss, metrics, grads = grad_fn(params, mb)
            for k, g in grads.items():
                acc[k] = acc[k] + g
            loss_sum = loss_sum + loss
        inv = 1.0 / tc.microbatches
        return loss_sum * inv, metrics, {k: g * inv for k, g in acc.items()}

    return accumulated


def make_train_step(model: Model, tc: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    hold the loss function's (``loss``, ``aux``, ``ntok``), the
    optimizer's (``grad_norm``, ``lr``) and ``total_loss`` (the mean over
    microbatches of ``loss + 0.01·aux``), all 0-d tensors."""
    loss_and_grad = make_loss_and_grad(model, tc)

    def train_step(state: TrainState, batch):
        loss, metrics, grads = loss_and_grad(state.params, batch)
        if tc.grad_compression == "int8":
            grads = maybe_compress_grads(grads)
        named = weights(state.params)
        new, opt, opt_metrics = adamw_update(named, grads, state.opt, tc)
        for k, p in named.items():
            if is_dtensor(p):
                # a DTensor's ``.data`` would not reach its local shard:
                # copy in, which also keeps the weight's placements
                with torch.no_grad():
                    p.copy_(new[k])
            else:
                p.data = new[k]
        metrics = dict(metrics, **opt_metrics, total_loss=loss)
        return TrainState(state.params, opt), metrics

    return train_step


# ------------------------------------------------------------ layout
def state_tree(state: TrainState, leaf=lambda t: t) -> TrainState:
    """``state`` in the reference's pytree layout: a TrainState whose
    weights and moments are nested dicts stacked over layers (each
    tensor through ``leaf`` first, e.g. a copy to the host)."""
    m, v = state.opt.m, state.opt.v
    return TrainState(
        params=weight_tree(state.params, lambda n, p: leaf(p.detach())),
        opt=OptState(step=leaf(state.opt.step),
                     m=weight_tree(state.params, lambda n, p: leaf(m[n])),
                     v=weight_tree(state.params, lambda n, p: leaf(v[n]))))


def load_state_tree(like: TrainState, tree: TrainState) -> TrainState:
    """A state from ``tree`` (:func:`state_tree`'s layout; leaves on any
    device) on ``like``'s module and device: the module's weights are
    replaced, each in its own dtype."""
    named = weights(like.params)
    dev = like.opt.step.device

    def to(src: dict, ref: dict) -> dict:
        return {k: t.to(device=ref[k].device, dtype=ref[k].dtype, copy=True)
                for k, t in src.items()}
    for k, t in to(unstack_tree(like.params, tree.params), named).items():
        named[k].data = t
    return TrainState(like.params, OptState(
        step=tree.opt.step.to(device=dev, dtype=torch.int32),
        m=to(unstack_tree(like.params, tree.opt.m), like.opt.m),
        v=to(unstack_tree(like.params, tree.opt.v), like.opt.v)))
