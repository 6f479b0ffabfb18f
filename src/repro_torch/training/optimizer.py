"""AdamW + warmup-cosine schedule (the JAX package's
``training/optimizer.py`` on torch).

Functional, as the reference is: :func:`adamw_update` takes the weights,
gradients and moments as dicts of tensors {name: tensor} and returns new
ones, in the reference's f32 arithmetic and order (``b ** step`` in f32,
the clip scale, ``(p - lr·delta).to(p.dtype)``). The moments mirror the
weights' names; on a mesh ZeRO-1 shards them over the data axes
(:class:`~repro_torch.launch.specs.StateShardings`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import TrainConfig


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    m: dict
    v: dict


def warmup_cosine(tc: TrainConfig):
    """lr(step) in f32: linear warm-up to ``learning_rate`` over
    ``warmup_steps``, then a cosine to 0 at ``total_steps``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = tc.learning_rate * step / max(tc.warmup_steps, 1)
        prog = torch.clamp((step - tc.warmup_steps)
                           / max(tc.total_steps - tc.warmup_steps, 1), 0, 1)
        cos = 0.5 * tc.learning_rate * (1 + torch.cos(math.pi * prog))
        return torch.where(step < tc.warmup_steps, warm, cos)
    return lr


def init_opt_state(params: dict) -> OptState:
    """Zero moments like ``params`` ({name: tensor}), step 0."""
    device = next(iter(params.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m={k: torch.zeros_like(p) for k, p in params.items()},
                    v={k: torch.zeros_like(p) for k, p in params.items()})


def global_norm(tree: dict) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt: OptState, tc: TrainConfig):
    """Returns (new_params, new_opt, metrics {"grad_norm", "lr"}); the
    inputs are left as they were."""
    step = opt.step + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if tc.grad_clip > 0
             else gnorm.new_ones(()))
    lr = warmup_cosine(tc)(step)
    b1, b2 = tc.beta1, tc.beta2
    stepf = step.to(torch.float32)
    # f32 powers on the device (a tensor made from the host would stall
    # the stream)
    bc1 = 1 - torch.pow(stepf.new_full((), b1), stepf)
    bc2 = 1 - torch.pow(stepf.new_full((), b2), stepf)

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * scale
        m = b1 * opt.m[k] + (1 - b1) * g
        v = b2 * opt.v[k] + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        delta = (mhat / (torch.sqrt(vhat) + tc.eps)
                 + tc.weight_decay * p.float())
        new_p[k] = (p - lr * delta.to(p.dtype)).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}
