"""Train a ~100M-parameter llama-family model end-to-end (the JAX
package's ``examples/train_100m.py`` on the port).

  PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_100m --tiny \
      --device cpu                                     # CI-sized

The full size (12 layers, d 768, vocab 32,000, seq 512, batch 8) trains
on the card; across cards the same config goes through the launcher
(``repro_torch.launch.train``). Includes async checkpointing + resume
and loss-curve printout; checkpoints go under the temporary directory
unless ``--ckpt-dir`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.kernels.fleet import check_device
from repro_torch.models import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.train_step import init_train_state, make_train_step


def config_100m() -> ModelConfig:
    """~110M params: 12L × d768 GQA decoder, llama-style."""
    return ModelConfig(
        name="llama-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32000, attention="full", rope_theta=10_000.0,
        attn_chunk=256, remat="none")


def tiny(cfg: ModelConfig) -> ModelConfig:
    """The CI-sized cut of ``--tiny``."""
    return dataclasses.replace(cfg, num_layers=2, d_model=128, num_heads=4,
                               num_kv_heads=2, head_dim=32, d_ff=256,
                               vocab_size=512, vocab_pad_to=32)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tiny", action="store_true",
                    help="shrink to CI size (seconds, not minutes)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "ck_100m"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.tiny:
        args.steps = min(args.steps, 20)
        args.seq, args.batch = 64, 8
    return args


def run(args, params=None) -> list[dict]:
    """The training run of ``args`` from ``params`` (trainable weights,
    e.g. carried from the reference) or weights drawn from seed 0.
    Returns each step's ``{"step", "loss", "lr"}``."""
    dev = check_device(args.device)
    cfg = tiny(config_100m()) if args.tiny else config_100m()
    model = build_model(cfg, device=dev, trainable=True)
    n = cfg.param_count()
    print(f"model: {cfg.num_layers}L d={cfg.d_model} → {n / 1e6:.0f}M params")

    tc = TrainConfig(learning_rate=6e-4, warmup_steps=20,
                     total_steps=args.steps, checkpoint_every=50)
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    pipe = make_pipeline(cfg, shape, seed=0)
    step_fn = make_train_step(model, tc)

    state = init_train_state(model, 0, params=params)
    start = 0
    if args.resume and ckpt.latest_steps(args.ckpt_dir):
        start, state = ckpt.restore(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    writer = None
    ema = None
    out = []
    for i in range(start, args.steps):
        state, m = step_fn(state, to_device(pipe.batch(i), dev))
        loss = float(m["loss"])
        out.append({"step": i, "loss": loss, "lr": float(m["lr"])})
        ema = loss if ema is None else 0.95 * ema + 0.05 * loss
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss={loss:.4f}  ema={ema:.4f}  "
                  f"lr={out[-1]['lr']:.2e}")
        if (i + 1) % tc.checkpoint_every == 0:
            if writer:
                writer.join()
            writer = ckpt.save(args.ckpt_dir, i + 1, state, async_=True)
    if writer:
        writer.join()
    ckpt.save(args.ckpt_dir, args.steps, state, async_=True).join()
    print(f"done; checkpoints: {ckpt.latest_steps(args.ckpt_dir)}")
    return out


def main(argv=None) -> list[dict]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
