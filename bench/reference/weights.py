"""The benchmark's weights: made on the device from a seed, in bf16,
in the layout of the configuration's architecture (``leaves(cfg)`` of
``bench/reference/<arch>.py``: every leaf stacked over layers, with its
scale), a few large draws a model. Both the program and the reference
are given them."""
from __future__ import annotations

from pathlib import Path

import torch

from bench import modules


def padded_vocab(cfg: dict) -> int:
    m = cfg["vocab_pad_to"]
    return (cfg["vocab_size"] + m - 1) // m * m


def make(cfg: dict, seed: int, device,
         root: Path | None = None) -> dict[str, torch.Tensor]:
    """Every leaf drawn from ``seed`` on ``device`` in bf16: the same seed
    on the same device gives the same weights. ``root``: the checkout
    whose ``bench/reference/<arch>.py`` lays them out."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = {}
    for name, shape, scale in modules.reference(cfg, root).leaves(cfg):
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.bfloat16)
        w[name] = t.mul_(scale)
    return w
