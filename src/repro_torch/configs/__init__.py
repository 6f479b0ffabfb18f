"""Architecture registry: ``--arch <id>`` → ModelConfig."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeConfig,
    SHAPES,
    TrainConfig,
    shape_applicable,
)

# arch id (CLI) → module name in this package
_ARCH_MODULES: dict[str, str] = {
    "rwkv6-3b": "rwkv6_3b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "granite-8b": "granite_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "starcoder2-3b": "starcoder2_3b",
    "whisper-small": "whisper_small",
    "arctic-480b": "arctic_480b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "zamba2-2.7b": "zamba2_2_7b",
    "llava-next-34b": "llava_next_34b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str, **kw) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.reduced(**kw)


def all_cells():
    """Yield every assigned (arch, shape) cell, with applicability flag."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            yield arch, shape.name, shape_applicable(cfg, shape)
