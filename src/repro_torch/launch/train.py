"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 20 --seq 64 --batch 8 --reduced --ckpt-dir /tmp/ck \
      [--device cpu]

Trains on one card (``--device`` defaults to ``cuda``; pass ``cpu`` for
the plain torch versions), the full config or with ``--reduced`` the
CPU-sized one. Features: microbatching, remat (the config's), int8
gradient compression, async checkpointing every ``--ckpt-every`` steps
and ``--resume``, straggler deadline logging with DYVERSE-style
degraded mode (halve the batch after three deadline misses — load
shedding borrowed from the paper's eviction idea). The port runs on one
card until its sharding lands: ``--production-mesh`` raises, and
ZeRO-1 (``TrainConfig.zero1``) is a no-op.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.kernels.fleet import check_device
from repro_torch.models import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.train_step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="not available: the port trains on one card")
    ap.add_argument("--step-deadline-s", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise SystemExit("--production-mesh: the port runs on one card "
                         "until its sharding slice lands")
    dev = check_device(args.device)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=dev, trainable=True)
    tc = TrainConfig(microbatches=args.microbatches,
                     grad_compression=args.grad_compression,
                     total_steps=max(args.steps, 10),
                     step_deadline_s=args.step_deadline_s)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    pipe = make_pipeline(cfg, shape, seed=0)
    step_fn = make_train_step(model, tc)

    state = init_train_state(model, params=model.params)
    start = 0
    if args.resume and args.ckpt_dir and ckpt.latest_steps(args.ckpt_dir):
        start, state = ckpt.restore(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    writer = None
    misses = 0
    batch_scale = 1
    for i in range(start, args.steps):
        t0 = time.perf_counter()
        batch = pipe.batch(i)
        if batch_scale > 1:  # degraded mode: shed load
            batch = {k: x[: x.shape[0] // batch_scale]
                     for k, x in batch.items()}
        state, metrics = step_fn(state, to_device(batch, dev))
        loss, lr = float(metrics["loss"]), float(metrics["lr"])
        dt = time.perf_counter() - t0
        if tc.step_deadline_s and dt > tc.step_deadline_s:
            misses += 1
            print(f"step {i}: DEADLINE MISS ({dt:.2f}s > "
                  f"{tc.step_deadline_s}s) [{misses}/3]")
            if misses >= 3 and batch_scale == 1:
                batch_scale = 2
                print("degraded mode: halving per-step batch "
                      "(straggler mitigation)")
        print(f"step {i:4d} loss={loss:.4f} lr={lr:.2e} {dt * 1e3:.0f}ms")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            if writer:
                writer.join()
            writer = ckpt.save(args.ckpt_dir, i + 1, state, async_=True)
    if writer:
        writer.join()
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, state, async_=True).join()
        print(f"final checkpoint at step {args.steps}: "
              f"{ckpt.latest_steps(args.ckpt_dir)}")


if __name__ == "__main__":
    main()
