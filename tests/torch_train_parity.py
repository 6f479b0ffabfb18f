"""Shared harness of the port's training tests: one reduced model of
each family in both packages on the same weights (the reference's
``init_params`` carried over with ``params_from_jax(trainable=True)``),
a seeded training batch made with numpy, and each package's loss and
gradients on it, the port's gradients laid out as the reference's tree
(``weight_tree``) for a leaf-by-leaf comparison."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced as ref_reduced
from repro.models import build_model as ref_build
from repro_torch.configs import get_reduced
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.model import weight_tree
from repro_torch.training.train_step import make_loss_and_grad

#: the five families, and the vision stub, which trains from ``embeds``
ARCHS = ("tinyllama-1.1b", "olmoe-1b-7b", "rwkv6-3b", "zamba2-2.7b",
         "whisper-small", "llava-next-34b")
VOCAB = dict(vocab_size=64, vocab_pad_to=32)


def cfgs(arch, dtype, **kw):
    return (ref_reduced(arch, dtype=dtype, **VOCAB, **kw),
            get_reduced(arch, dtype=dtype, **VOCAB, **kw))


def train_batch(cfg, B=4, S=32, seed=0):
    """A training batch as numpy arrays: ``tokens`` (or the vision
    stub's ``embeds``), ``labels``, and the encoder-decoder's
    ``frames``, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.frontend == "vision":
        b["embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                       * 0.02).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.is_encoder_decoder:
        Se = max(S // cfg.encoder_seq_ratio, 1)
        b["frames"] = (rng.standard_normal((B, Se, cfg.d_model))
                       * 0.02).astype(np.float32)
    b["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return b


def port_batch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device).long() if v.dtype == np.int32
            else torch.from_numpy(v).to(device) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def ref_params(arch, seed=0):
    """The reference's ``init_params`` (f32 masters) as numpy."""
    rm = ref_build(ref_reduced(arch, **VOCAB))
    return jax.tree.map(np.asarray, rm.init_params(jax.random.key(seed)))


def port_model(arch, dtype, device="cpu", **kw):
    """(cfg, model, trainable weights carried from the reference)."""
    pcfg = get_reduced(arch, dtype=dtype, **VOCAB, **kw)
    pm = build_model(pcfg, device=device, trainable=True)
    return pcfg, pm, params_from_jax(pcfg, ref_params(arch), device=device,
                                     trainable=True)


@functools.lru_cache(maxsize=None)
def ref_loss_grads(arch, dtype):
    """(total loss, metrics, gradient tree as f32 numpy) of the
    reference on :func:`train_batch`."""
    rcfg = ref_reduced(arch, dtype=dtype, **VOCAB)
    rm = ref_build(rcfg)
    batch = {k: jnp.asarray(v) for k, v in train_batch(rcfg).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        rm.loss_fn, has_aux=True))(jax.tree.map(jnp.asarray,
                                                ref_params(arch)), batch)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(lambda g: np.asarray(g, np.float32), grads))


def grad_tree(params, grads: dict):
    """The port's gradients {name: tensor} in the reference's layout, as
    f32 numpy."""
    return jax.tree.map(lambda t: t.numpy(), weight_tree(
        params, lambda n, p: grads[n].detach().float().cpu()))


def port_loss_grads(arch, dtype, device="cpu", microbatches=1, **kw):
    """(total loss, metrics, gradient tree as f32 numpy) of the port,
    the same batch and weights as :func:`ref_loss_grads`."""
    from repro_torch.configs.base import TrainConfig

    pcfg, pm, pp = port_model(arch, dtype, device, **kw)
    loss, metrics, grads = make_loss_and_grad(
        pm, TrainConfig(microbatches=microbatches))(
        pp, port_batch(train_batch(pcfg), device))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            grad_tree(pp, grads))


def leaves(tree):
    """(path, leaf) pairs of a nested dict in the reference's order."""
    return [(jax.tree_util.keystr(p), x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def rel(a, b):
    """‖a − b‖ / ‖b‖ (norm-relative, b the reference)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
