"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 20 --seq 64 --batch 8 --reduced --ckpt-dir /tmp/ck \
      [--device cpu]

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
      --reduced --steps 3

Trains the full config (or with ``--reduced`` the CPU-sized one) on the
ranks ``torchrun`` started — one rank, one card, when it is run alone —
over ``make_host_mesh()``, or ``make_production_mesh()`` with
``--production-mesh`` (256 ranks). ``--device`` defaults to ``cuda``;
pass ``cpu`` for the plain torch versions over gloo. With more than one
rank the state is placed by ``state_pspecs`` as DTensors, each batch
is sharded over the data axes by ``input_pspecs`` (every data rank
computes its rows; DTensor reduces the gradients over data), ZeRO-1
(``TrainConfig.zero1``) shards the moments over the data axes, and each
step's state is redistributed to those specs (the reference's
``out_shardings``); with one rank every placement is Replicate and the
step is the single-card step. Features: microbatching, remat (the
config's), int8 gradient compression, async checkpointing every
``--ckpt-every`` steps (written by rank 0 from the gathered state) and
``--resume`` onto this run's mesh, straggler deadline logging with
DYVERSE-style degraded mode (halve the batch after three deadline
misses — load shedding borrowed from the paper's eviction idea). The
deadline sees the interval the reference's sees: batch and dispatch,
up to the step's return, before any read of its metrics.
"""
from __future__ import annotations

import argparse
import time

import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.pipeline import make_pipeline, to_device
from repro_torch.kernels.fleet import check_device
from repro_torch.launch import mesh as meshes
from repro_torch.launch.specs import StateShardings, input_pspecs
from repro_torch.models import build_model
from repro_torch.parallel.sharding import full, place, use_mesh
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.train_step import init_train_state, make_train_step


def parse_args(argv=None):
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
                    help="use make_production_mesh() (needs 256 ranks)")
    ap.add_argument("--step-deadline-s", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Run the launcher; returns each step's ``{"step", "loss", "lr",
    "total_loss"}`` as floats."""
    args = parse_args(argv)
    dev = check_device(args.device)
    owned = not dist.is_initialized()
    try:
        mesh = (meshes.make_production_mesh(device=dev)
                if args.production_mesh else meshes.make_host_mesh(dev))
        return train(args, mesh)
    finally:
        if owned:
            meshes.destroy_process_group()


def train(args, mesh) -> list[dict]:
    """The training loop of :func:`main`'s ``args`` on ``mesh`` (any
    data × model layout over this run's ranks)."""
    from torch.distributed.tensor.experimental import implicit_replication

    dev = check_device(args.device)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
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
    out = []

    def place_batch(batch):
        # data parallelism: each data rank holds its rows of the batch
        specs = input_pspecs(cfg, batch, mesh)
        return {k: place(x, mesh, specs[k]) for k, x in batch.items()}

    with use_mesh(mesh), implicit_replication():
        shardings = StateShardings.of(model.params, mesh, zero1=tc.zero1,
                                      moe_tp=cfg.moe_strategy == "tp")
        state = init_train_state(model, params=model.params)
        start = 0
        if args.resume and args.ckpt_dir and ckpt.latest_steps(args.ckpt_dir):
            start, state = ckpt.restore(args.ckpt_dir, state,
                                        shardings=shardings)
            if rank0:
                print(f"resumed from step {start}")
        else:
            state = shardings.place(state)

        writer = None
        misses = 0
        batch_scale = 1
        for i in range(start, args.steps):
            t0 = time.perf_counter()
            batch = pipe.batch(i)
            if batch_scale > 1:  # degraded mode: shed load
                batch = {k: x[: x.shape[0] // batch_scale]
                         for k, x in batch.items()}
            state, metrics = step_fn(state, place_batch(to_device(batch,
                                                                  dev)))
            dt = time.perf_counter() - t0
            state = shardings.constrain(state)
            m = {k: float(full(metrics[k]))
                 for k in ("loss", "lr", "total_loss")}
            out.append(dict(step=i, **m))
            if tc.step_deadline_s and dt > tc.step_deadline_s:
                misses += 1
                if rank0:
                    print(f"step {i}: DEADLINE MISS ({dt:.2f}s > "
                          f"{tc.step_deadline_s}s) [{misses}/3]")
                if misses >= 3 and batch_scale == 1:
                    batch_scale = 2
                    if rank0:
                        print("degraded mode: halving per-step batch "
                              "(straggler mitigation)")
            if rank0:
                print(f"step {i:4d} loss={m['loss']:.4f} "
                      f"lr={m['lr']:.2e} {dt * 1e3:.0f}ms")
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                if writer:
                    writer.join()
                writer = ckpt.save(args.ckpt_dir, i + 1, state, async_=True)
        if writer:
            writer.join()
        if args.ckpt_dir:
            writer = ckpt.save(args.ckpt_dir, args.steps, state, async_=True)
            if writer:
                writer.join()
                print(f"final checkpoint at step {args.steps}: "
                      f"{ckpt.latest_steps(args.ckpt_dir)}")
    return out


if __name__ == "__main__":
    main()
