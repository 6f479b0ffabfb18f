"""Fault-tolerant checkpointing: atomic and async (the JAX package's
``training/checkpoint.py`` on torch, with its on-disk layout).

Layout:  <dir>/step_<N>/
           manifest.json       — step, tree structure, leaf shapes/dtypes
           leaf_<i>.npy        — one file per leaf (the full array)
           COMMITTED           — written last; restore ignores uncommitted dirs

Leaves are numbered in ``jax.tree_util``'s order: dict keys sorted,
tuples and NamedTuples in field order, None an empty subtree. A
:class:`~repro_torch.training.train_step.TrainState` is written in the
reference's layout (:func:`~repro_torch.training.train_step.state_tree`:
``TrainState(params, OptState(step, m, v))``, weights and moments
stacked over layers), so the reference's ``restore`` reads the port's
checkpoints and the port's reads the reference's. dtypes numpy lacks
(bf16, the float8s) are stored as raw unsigned views made through
torch, the logical dtype in the manifest. ``save`` takes its host copy
before it returns; the async writer thread works from that copy, so
the train loop may go on changing the state. Keeps the newest k. A
state placed on a mesh (DTensors) is gathered whole on every rank —
each rank calls ``save`` — and written by rank 0; ``restore`` reads it
whole on every rank and, given ``shardings``, places it on this run's
mesh, whatever mesh wrote it (the elastic-restart path).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.parallel.sharding import full
from repro_torch.training.train_step import (TrainState, load_state_tree,
                                             state_tree)

# dtypes numpy cannot hold: (torch dtype, same-width integer dtype in
# torch, the unsigned numpy dtype of the raw view on disk)
_RAW_VIEWS = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.int8, np.uint8),
}


def _is_state(tree) -> bool:
    return isinstance(tree, TrainState) and isinstance(tree.params,
                                                       nn.Module)


def _flatten(tree) -> list:
    """Leaves in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _flatten(t)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (tuple, list)):
        items = [_unflatten(t, leaves) for t in like]
        if hasattr(like, "_fields"):
            return type(like)(*items)
        return type(like)(items)
    return next(leaves)


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return f"{name}({', '.join(_structure(t) for t in tree)})"
    return "None" if tree is None else "*"


def _to_disk(x) -> tuple[np.ndarray, str]:
    """A host leaf as (the array np.save writes, logical dtype name)."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        if name in _RAW_VIEWS:
            _, as_int, raw = _RAW_VIEWS[name]
            return x.view(as_int).numpy().view(raw), name
        return x.numpy(), name
    arr = np.asarray(x)
    return arr, arr.dtype.name


def _from_disk(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _RAW_VIEWS:
        dtype, as_int, _ = _RAW_VIEWS[logical]
        return torch.from_numpy(arr.view(np.dtype(str(as_int).removeprefix(
            "torch.")))).view(dtype)
    return torch.from_numpy(arr)


def _host_copy(t) -> Any:
    if isinstance(t, torch.Tensor):
        return full(t.detach()).to("cpu", copy=True)
    return np.array(t, copy=True)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         async_: bool = False) -> threading.Thread | None:
    """Write a checkpoint of ``tree`` (nested dicts, tuples and
    NamedTuples of tensors or arrays, or a TrainState). Returns the
    writer thread when async; None on ranks other than 0, which only
    take part in gathering a placed state."""
    if _is_state(tree):
        host_tree = state_tree(tree, leaf=_host_copy)
    else:
        host_tree = _unflatten(tree, iter([_host_copy(x)
                                           for x in _flatten(tree)]))
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    host = [_to_disk(x) for x in _flatten(host_tree)]
    struct = _structure(host_tree)

    def write():
        d = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        for i, (arr, _) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest = {
            "step": step,
            "treedef": struct,
            "leaves": [{"shape": list(a.shape), "dtype": dt}
                       for a, dt in host],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "COMMITTED")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def _like_leaf(ref, arr: torch.Tensor):
    """A loaded leaf in the type, dtype and device of ``ref``."""
    if isinstance(ref, torch.Tensor):
        dev = "cpu" if ref.device.type == "meta" else ref.device
        return arr.to(device=dev, dtype=ref.dtype)
    if arr.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        arr = arr.float()
    return arr.numpy().astype(np.asarray(ref).dtype)


def restore(ckpt_dir: str, like: Any, *, step: int | None = None,
            shardings: Any = None) -> tuple[int, Any]:
    """Restore into the structure of ``like``: each leaf in ``like``'s
    leaf's type, dtype and device. For a TrainState (its tensors plain),
    a state on ``like``'s module (its weights replaced) and device, and
    with ``shardings`` (a :class:`~repro_torch.launch.specs.StateShardings`)
    placed by it."""
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    state = like if _is_state(like) else None
    if state is not None:
        like = state_tree(state, leaf=lambda t: torch.empty_like(
            t, device="meta"))
    flat_like = _flatten(like)
    if len(flat_like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"expected {len(flat_like)}")
    leaves = []
    for i, ref in enumerate(flat_like):
        arr = _from_disk(np.load(os.path.join(d, f"leaf_{i}.npy")),
                         manifest["leaves"][i]["dtype"])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(arr.shape)}"
                             f" != expected {tuple(ref.shape)}")
        leaves.append(_like_leaf(ref, arr))
    tree = _unflatten(like, iter(leaves))
    if state is not None:
        tree = load_state_tree(state, tree)
        if shardings is not None:
            tree = shardings.place(tree)
    return step, tree
