"""Quickstart: build any assigned architecture, train a few steps,
prefill + decode a few tokens (the JAX package's
``examples/quickstart.py`` on the port).

  PYTHONPATH=src python -m repro_torch.examples.quickstart \
      --arch tinyllama-1.1b [--device cpu]

On the card the prefill and decode run through the attention kernels
(K4, K5) and the recurrent ones (K6 on rwkv6-3b, K7 on zamba2-2.7b);
training takes the plain differentiable route.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.kernels.fleet import check_device
from repro_torch.models import build_model
from repro_torch.models.kvcache import grow_cache
from repro_torch.training.train_step import init_train_state, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda or cpu)")
    return ap.parse_args(argv)


def run(arch: str, steps: int = 10, device="cuda", params=None) -> dict:
    """The quickstart on ``device``: ``params`` (trainable weights, e.g.
    carried from the reference) or weights drawn from seed 0. Returns
    the per-step ``loss`` and ``grad_norm``, the greedy ``continuation``
    (None for the vision stub), and the ``model`` and trained
    ``state``."""
    dev = check_device(device)
    full = get_config(arch)
    cfg = get_reduced(arch)          # CPU-sized, same family as full
    model = build_model(cfg, device=dev, trainable=True)
    print(f"arch={arch} family={cfg.family} "
          f"(full: {full.num_layers}L d={full.d_model} "
          f"~{full.param_count() / 1e9:.1f}B params; reduced for CPU here)")

    # ---- train a few steps on the synthetic Markov pipeline
    shape = ShapeConfig("quick", seq_len=64, global_batch=8, kind="train")
    pipe = make_pipeline(cfg, shape, seed=0)
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=100)
    state = init_train_state(model, 0, params=params)
    step = make_train_step(model, tc)
    out = {"loss": [], "grad_norm": [], "continuation": None,
           "model": model}
    for i in range(steps):
        state, metrics = step(state, to_device(pipe.batch(i), dev))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        out["loss"].append(loss)
        out["grad_norm"].append(gnorm)
        print(f"step {i:3d}  loss={loss:.4f}  gnorm={gnorm:.3f}")
    out["state"] = state

    # ---- prefill + greedy decode
    if cfg.frontend == "vision":
        print("(vision arch: decode demo skipped — tokens come from the stub)")
        return out
    prompt = torch.arange(1, 9, dtype=torch.int64, device=dev)[None]
    batch = {"tokens": prompt}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros(
            (1, max(8 // cfg.encoder_seq_ratio, 1), cfg.d_model),
            dtype=torch.bfloat16, device=dev)
    logits, cache = model.prefill_fn(state.params, batch)
    # pad cache so decode has free slots
    cache = grow_cache(cfg, cache, 16)
    tok = torch.argmax(logits, -1)
    cont = [int(tok[0])]
    for t in range(5):
        pos = torch.full((1,), 8 + t, dtype=torch.int64, device=dev)
        logits, cache = model.decode_fn(state.params, cache, tok, pos)
        tok = torch.argmax(logits, -1)
        cont.append(int(tok[0]))
    print("greedy continuation:", cont)
    out["continuation"] = cont
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(args.arch, args.steps, args.device)


if __name__ == "__main__":
    main()
