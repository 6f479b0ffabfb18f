"""Shared harness of the port's model-parity tests: one reduced model of
each package on the same weights (the reference's ``init_params``
carried over with ``params_from_jax``), a seeded prompt through both
prefills, then greedy (or forced) decode steps through both."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced as ref_reduced
from repro.models import build_model as ref_build
from repro.models.kvcache import grow_cache as ref_grow
from repro_torch.configs import get_reduced
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.kvcache import grow_cache


def t(x):
    return torch.from_numpy(np.asarray(x))


def models(arch, dtype, seed=0):
    """(ref cfg, ref model, ref params, port cfg, port model, port
    params), the port's weights carried from the reference's."""
    rcfg = ref_reduced(arch, dtype=dtype)
    rm = ref_build(rcfg)
    rparams = rm.init_params(jax.random.key(seed))
    pcfg = get_reduced(arch, dtype=dtype)
    pm = build_model(pcfg, device="cpu")
    pparams = params_from_jax(pcfg, jax.tree.map(np.asarray, rparams),
                              device="cpu")
    return rcfg, rm, rparams, pcfg, pm, pparams


def run(arch, dtype, *, B=2, S=16, steps=8, forced=None):
    """Prefill S prompt tokens, then ``steps`` greedy decode steps (or the
    ``forced`` (steps, B) tokens) on both; returns both logit streams and
    token streams."""
    rcfg, rm, rparams, pcfg, pm, pparams = models(arch, dtype)
    tokens = np.random.default_rng(0).integers(
        0, rcfg.vocab_size, (B, S)).astype(np.int32)
    r_logits, r_cache = jax.jit(rm.prefill_fn)(
        rparams, {"tokens": jnp.asarray(tokens)})
    r_cache = ref_grow(rcfg, r_cache, S + steps + 1)
    p_logits, p_cache = pm.prefill_fn(pparams, {"tokens": t(tokens).long()})
    p_cache = grow_cache(pcfg, p_cache, S + steps + 1)
    r_dec = jax.jit(rm.decode_fn)
    out = {"ref": [np.asarray(r_logits, np.float32)],
           "port": [p_logits.float().numpy()], "ref_tok": [], "port_tok": []}
    for step in range(steps):
        rt = out["ref"][-1].argmax(-1).astype(np.int32)
        pt = out["port"][-1].argmax(-1)
        if forced is not None:
            rt = pt = forced[step]
        out["ref_tok"].append(rt)
        out["port_tok"].append(pt)
        pos = np.full(B, S + step, np.int32)
        r_logits, r_cache = r_dec(rparams, r_cache, jnp.asarray(rt),
                                  jnp.asarray(pos))
        p_logits, p_cache = pm.decode_fn(pparams, p_cache, t(pt).long(),
                                         t(pos).long())
        out["ref"].append(np.asarray(r_logits, np.float32))
        out["port"].append(p_logits.float().numpy())
    return out
