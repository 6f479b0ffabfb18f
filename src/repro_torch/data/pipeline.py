"""Deterministic synthetic LM data pipeline (the JAX package's
``data/pipeline.py`` on torch, batch for batch the same data).

Markov-chain token streams (so the loss actually decreases — the model
has structure to learn), generated per (step, shard) from a fold-in of
the seed: restart-exact (step N reproduces identical batches after a
restart) and shardable (each data shard makes only its slice). The
transition table comes from numpy's ``default_rng`` as in the
reference. The reference draws the streams with ``jax.random``
(partitionable threefry); :class:`_Key` reproduces ``key``, ``fold_in``,
``split``, ``randint``, ``uniform`` and ``normal`` (bf16) on the port's
threefry (:func:`repro_torch.kernels.fleet.threefry2x32`), so tokens
and labels equal the reference's bit for bit. Batches are made on the
CPU (int64 tokens, the port's index dtype) and moved by the caller.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.fleet import threefry2x32

_M32 = 0xFFFFFFFF
# bf16 constants of jax.random.normal: nextafter(-1, 0) and sqrt(2)
_BF16_LO = -0.99609375
_BF16_SQRT2 = float(np.sqrt(2))


class _Key(NamedTuple):
    """A ``jax.random`` threefry key: its two 32-bit words."""
    k0: int
    k1: int

    @classmethod
    def from_seed(cls, seed: int) -> "_Key":
        """``jax.random.key(seed)`` for a 32-bit seed: words (0, seed)."""
        return cls(0, seed & _M32)

    def fold_in(self, data: int) -> "_Key":
        x0, x1 = threefry2x32(self.k0, self.k1, 0, data & _M32)
        return _Key(x0, x1)

    def split(self, n: int = 2) -> list["_Key"]:
        """``jax.random.split`` (partitionable: key i hashes counter
        (0, i), the same words as ``fold_in(i)``)."""
        return [self.fold_in(i) for i in range(n)]

    def bits(self, shape) -> torch.Tensor:
        """32 random bits per element (int64 holding the word): counter
        i of the flat index, ``x0 ^ x1``."""
        i = torch.arange(int(np.prod(shape)), dtype=torch.int64)
        x0, x1 = threefry2x32(torch.tensor(self.k0), torch.tensor(self.k1),
                              i >> 32, i & _M32)
        return (x0 ^ x1).reshape(shape)

    def randint(self, shape, minval: int, maxval: int) -> torch.Tensor:
        """``jax.random.randint`` into int64: two draws of 32 bits folded
        modulo the span in wrapping uint32 arithmetic."""
        k1, k2 = self.split()
        hi, lo = k1.bits(shape), k2.bits(shape)
        span = max(maxval - minval, 1)
        mult = (((2 ** 16 % span) ** 2) & _M32) % span
        off = ((hi % span) * mult + lo % span) & _M32
        return minval + off % span

    def uniform(self, shape) -> torch.Tensor:
        """``jax.random.uniform`` in f32 over [0, 1): the mantissa
        trick."""
        bits = self.bits(shape)
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        return torch.clamp(f - 1.0, min=0.0)

    def normal_bf16(self, shape) -> torch.Tensor:
        """``jax.random.normal`` in bf16: 8 random bits a value, a bf16
        uniform over [nextafter(-1, 0), 1), sqrt(2)·erfinv in f32
        rounded to bf16, times sqrt(2) in bf16."""
        b8 = self.bits(shape) & 0xFF
        f = ((b8 >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16) - 1
        bf = torch.bfloat16
        lo = torch.tensor(_BF16_LO, dtype=bf)
        u = torch.maximum(lo, f * (torch.tensor(1.0, dtype=bf) - lo) + lo)
        return (torch.erfinv(u.float()).to(bf)
                * torch.tensor(_BF16_SQRT2, dtype=bf))


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    order: int = 1              # Markov order of the synthetic source


class SyntheticLM:
    """Batch factory: batch(step) -> {"tokens", "labels"} (+ stub
    frontends)."""

    def __init__(self, dc: DataConfig, cfg: ModelConfig | None = None):
        self.dc = dc
        self.cfg = cfg
        rng = np.random.default_rng(dc.seed)
        v = min(dc.vocab_size, 4096)       # transition table kept small
        self.v = v
        raw = rng.dirichlet(np.full(v, 0.05), size=v).astype(np.float32)
        self.trans = torch.from_numpy(np.cumsum(raw, axis=1))

    def batch(self, step: int, *, shard: int = 0, num_shards: int = 1):
        dc = self.dc
        b = dc.global_batch // num_shards
        key = _Key.from_seed(dc.seed).fold_in(step).fold_in(shard)
        k0, k1 = key.split()
        tok = k0.randint((b,), 0, self.v)
        us = k1.uniform((b, dc.seq_len))
        seq = []
        for t in range(dc.seq_len):
            tok = torch.clamp((self.trans[tok] < us[:, t, None]).sum(-1),
                              0, self.v - 1)
            seq.append(tok)
        tokens = torch.stack(seq, dim=1)                 # (b, S)
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        out = {"tokens": tokens, "labels": labels}
        if self.cfg is not None:
            out = adapt_batch_to_arch(out, self.cfg, key)
        return out


def adapt_batch_to_arch(batch, cfg: ModelConfig, key: _Key):
    """Attach stub-frontend inputs for audio/vision archs (bf16 normals
    times 0.02, as the reference draws them)."""
    scale = torch.tensor(0.02, dtype=torch.bfloat16)
    if cfg.frontend == "vision":
        B, S = batch["tokens"].shape
        emb = key.normal_bf16((B, S, cfg.d_model)) * scale
        return {"embeds": emb, "labels": batch["labels"]}
    if cfg.is_encoder_decoder:
        B, S = batch["tokens"].shape
        Se = max(S // cfg.encoder_seq_ratio, 1)
        frames = key.normal_bf16((B, Se, cfg.d_model)) * scale
        return dict(batch, frames=frames)
    return batch


def make_pipeline(cfg: ModelConfig, shape: ShapeConfig, seed: int = 1234):
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                    global_batch=shape.global_batch, seed=seed)
    return SyntheticLM(dc, cfg)


def to_device(batch: dict, device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}
