"""Multi-rank checks of the port's sharding layer: :func:`spawn` starts
``world`` processes, each one rank running this file,

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dist_ranks.py <scenario> <out dir> [arch]

within one time limit (``test_torch_distributed*.py``). Each scenario
brings up the gloo group, runs, writes this rank's results to ``<out
dir>/<scenario>_<rank>.npz`` and tears the group down. Inputs come from
seeded numpy. Imports only the port.
"""
import contextlib
import dataclasses
import functools
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import mesh as meshes
from repro_torch.parallel.sharding import (P, fit_spec, full,
                                           module_pspecs, place, placements,
                                           use_mesh, zero1_pspec)

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120

#: the compressed reduction's inputs: each rank's row of (4, REDUCE_N),
#: and a linear model's weights and 4 × GRAD_ROWS rows of data
REDUCE_N = 1000
GRAD_ROWS = 6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def env(**kw):
    """This process's environment for a child: the port on the path, one
    intra-op thread, and ``kw``."""
    out = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out.update({k: str(v) for k, v in kw.items()})
    return out


def _wait(procs, logs, what):
    """Wait for every process within SPAWN_TIMEOUT_S, kill them all on
    the way out, and fail with the logs' tails if one failed or hung."""
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise AssertionError(
            f"{what}: no end within {SPAWN_TIMEOUT_S} s\n"
            + "\n".join(log.read_text()[-1500:] for log in logs)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(p.returncode, log) for p, log in zip(procs, logs)
           if p.returncode]
    assert not bad, "\n".join(f"{what}: rc {rc}\n{log.read_text()[-3000:]}"
                              for rc, log in bad)


def spawn(scenario: str, world: int, out: Path, args=(), extra=()):
    """``world`` ranks of ``scenario`` (with ``args`` after the out dir,
    and the ``extra`` (argv, env) processes beside them), all within one
    time limit; returns each rank's results."""
    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        log = out / f"{scenario}_{r}.log"
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, scenario, str(out), *args],
                env=env(RANK=r, LOCAL_RANK=r, WORLD_SIZE=world,
                        MASTER_ADDR="localhost", MASTER_PORT=port),
                stdout=f, stderr=subprocess.STDOUT, cwd=ROOT))
    for i, (argv, child_env) in enumerate(extra):
        log = out / f"{scenario}_extra{i}.log"
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(argv, env=child_env, stdout=f,
                                          stderr=subprocess.STDOUT,
                                          cwd=ROOT))
    _wait(procs, logs, scenario)
    return [dict(np.load(out / f"{scenario}_{r}.npz")) for r in range(world)]


def reduce_inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, REDUCE_N))
         * rng.uniform(0.1, 10, (4, 1))).astype(np.float32)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32)}
    batch = {"x": rng.standard_normal((4 * GRAD_ROWS, 16)).astype(
        np.float32),
        "y": rng.standard_normal((4 * GRAD_ROWS, 8)).astype(np.float32)}
    return x, params, batch


def linear_loss(p, b):
    return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()


def scenario_reduce(rank, out):
    from repro_torch.parallel.compression import (compressed_allreduce,
                                                  make_compressed_grad_fn)

    mesh = meshes.make_mesh((4,), ("data",), "cpu")
    x, params, batch = reduce_inputs()
    y = compressed_allreduce(torch.from_numpy(x[rank]),
                             mesh.device_mesh.get_group("data"))
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    shard = {k: torch.from_numpy(v[rank * GRAD_ROWS:(rank + 1) * GRAD_ROWS])
             for k, v in batch.items()}
    g = make_compressed_grad_fn(linear_loss, mesh)(p, shard)
    np.savez(out, y=y.numpy(), gw=g["w"].numpy(), gb=g["b"].numpy())


def _placed_moe(pm, cfg, x, mesh):
    """``pm``'s weights as DTensors by their specs on ``mesh`` (``tp``'s
    F-sharded ones for that strategy), and ``x`` sharded over "data"."""
    from torch import nn

    holder = nn.Module()
    holder.moe = pm                   # the weights' paths are moe/...
    specs = {n.removeprefix("moe."): s for n, s in module_pspecs(
        holder, moe_tp=cfg.moe_strategy == "tp").items()}
    for n, p in list(pm.named_parameters()):
        owner, _, attr = n.rpartition(".")
        setattr(pm.get_submodule(owner), attr, nn.Parameter(
            place(p.detach(), mesh, fit_spec(p.shape, specs[n], mesh))))
    xs = place(x.detach(), mesh, fit_spec(x.shape, P("data"), mesh))
    return xs.requires_grad_()


def _moe_case(arch, mesh, strategy):
    """Reduced ``arch`` in f32 at capacity factor 8 with ``strategy``: the
    local function's output, aux and gradients (the weights' and the
    tokens') against the same under ``mesh``, on DTensors placed by their
    specs ("dtensor"; weights drawn from seed 0 on every rank) and, for
    ``tp`` on a mesh of one data shard, on full tensors on every rank
    ("mesh"). A DTensor's output and gradients are read whole. ``tp``
    routes each data shard's tokens apart and means the shards' aux
    losses, so its local run does the same, shard by shard."""
    from repro_torch.models import moe as PM

    cfg = dataclasses.replace(get_reduced(arch, capacity_factor=8.0),
                              dtype="float32", moe_strategy=strategy)
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    ndata = dict(zip(mesh.axis_names, mesh.devices.shape))["data"]
    shards = ndata if strategy == "tp" else 1
    res = {}
    for tag in ("local", "mesh", "dtensor"):
        if tag == "mesh" and (strategy != "tp" or ndata > 1):
            continue
        pm = PM.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
        pm.requires_grad_(True)
        x = x0.clone().requires_grad_()
        names, params = zip(*pm.named_parameters())
        if tag == "local":
            parts = [PM.moe_ffn(pm, xs, cfg) for xs in x.chunk(shards)]
            out = torch.cat([o for o, _ in parts])
            aux = sum(a for _, a in parts) / shards
        else:
            if tag == "dtensor":
                x = _placed_moe(pm, cfg, x, mesh)
                names, params = zip(*pm.named_parameters())
            with use_mesh(mesh):
                out, aux = PM.moe_ffn(pm, x, cfg)
        loss = torch.sum(out ** 2) + 0.01 * aux
        grads = torch.autograd.grad(loss, params + (x,))
        res[f"{tag}_out"] = full(out).detach().numpy()
        res[f"{tag}_aux"] = float(full(aux).detach())
        for n, gr in zip(names + ("x",), grads):
            res[f"{tag}_grad_{n}"] = full(gr).numpy()
    return {f"{arch}/{strategy}/{k}": v for k, v in res.items()}


def launcher_args(**kw):
    """The launcher's arguments for reduced tinyllama-1.1b on the CPU, 3
    steps of 4 × 32 tokens, with ``kw`` set."""
    from repro_torch.launch.train import parse_args
    args = parse_args(["--reduced", "--device", "cpu", "--steps", "3",
                       "--seq", "32", "--batch", "4"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@contextlib.contextmanager
def f32_launcher(**overrides):
    """The launcher module with its reduced configs in f32 (and
    ``overrides``) and a learning rate at which every step moves the
    weights (1e-2, no warm-up), for a 1e-5 comparison; put back on the
    way out."""
    import repro_torch.launch.train as lt

    saved = lt.get_reduced, lt.TrainConfig
    lt.get_reduced = lambda arch, **kw: get_reduced(arch, dtype="float32",
                                                    **overrides, **kw)
    lt.TrainConfig = functools.partial(TrainConfig, learning_rate=1e-2,
                                       warmup_steps=0)
    try:
        yield lt
    finally:
        lt.get_reduced, lt.TrainConfig = saved


@contextlib.contextmanager
def block_batches(seen: list):
    """Record the batch each decoder block's residual stream holds on
    this rank (its local rows on a DTensor) after the block's layout
    constraint."""
    import repro_torch.models.transformer as tfm

    constrain = tfm.constrain

    def recording(x, *axes):
        x = constrain(x, *axes)
        seen.append((x.to_local() if hasattr(x, "to_local") else x).shape[0])
        return x
    tfm.constrain = recording
    try:
        yield seen
    finally:
        tfm.constrain = constrain


#: the decode cases' layouts: (partials, grouped)
DECODE_LAYOUTS = ((False, False), (True, False), (False, True), (True, True))


def _decode_case(mesh, kv_heads):
    """Reduced tinyllama-1.1b in f32 with ``kv_heads`` KV heads (2 shard
    the cache's heads over "model" on (1, 2); 1 leaves it the sequence),
    two decode steps from a seeded cache: locally (the paged kernel's
    plain version) and, in each (partials, grouped) layout, with the
    weights, cache, tokens and positions placed by the launcher's specs
    (the dense decode, each rank writing its cache shard). Returns the
    logits and the final caches, read whole."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import StateShardings, input_pspecs
    from repro_torch.models import build_model

    base = dataclasses.replace(get_reduced("tinyllama-1.1b"),
                               dtype="float32", num_kv_heads=kv_heads)
    B, S = 4, 16
    rng = np.random.default_rng(7 + kv_heads)
    specs = build_model(base, device="meta").input_specs(
        ShapeConfig("decode", S, B, "decode"))
    cache0 = {k: rng.standard_normal(sp.shape).astype(np.float32)
              for k, sp in specs["cache"].items()}
    tokens = rng.integers(0, base.vocab_size, (2, B))
    pos0 = np.array([3, 9, 0, 13])

    def run(cfg, mesh):
        model = build_model(cfg, device="cpu")
        cache = {k: torch.tensor(v) for k, v in cache0.items()}
        tok = [torch.tensor(t) for t in tokens]
        pos = [torch.tensor(pos0 + i) for i in range(2)]
        if mesh is not None:
            StateShardings.of(model.params, mesh,
                              zero1=False).place_params(model.params)
            ps = input_pspecs(cfg, specs, mesh)
            cache = {k: place(v, mesh, ps["cache"][k])
                     for k, v in cache.items()}
            tok = [place(t, mesh, ps["token"]) for t in tok]
            pos = [place(p, mesh, ps["pos"]) for p in pos]
        logits = []
        with use_mesh(mesh) if mesh is not None else \
                contextlib.nullcontext(), implicit_replication():
            for t, p in zip(tok, pos):
                out, cache = model.decode_fn(model.params, cache, t, p)
                logits.append(full(out).numpy())
        return np.stack(logits), {k: full(v).numpy()
                                  for k, v in cache.items()}

    res = {f"init_{k}": v for k, v in cache0.items()}
    logits, cache = run(base, None)
    res["local_logits"] = logits
    res.update({f"local_{k}": v for k, v in cache.items()})
    for partials, grouped in DECODE_LAYOUTS:
        cfg = dataclasses.replace(base, decode_partials=partials,
                                  decode_grouped=grouped)
        tag = f"p{int(partials)}g{int(grouped)}"
        logits, cache = run(cfg, mesh)
        res[f"{tag}_logits"] = logits
        res.update({f"{tag}_{k}": v for k, v in cache.items()})
    return res


def scenario_two(rank, out, ckpt_dir):
    """MoE ``tp`` and the default strategy, and the decode cases, on the
    host mesh (1, 2) and on a (2, 1) mesh; the launcher on the host mesh (1, 2), writing
    checkpoints to ``ckpt_dir``; the launcher on a (2, 1) mesh with
    ZeRO-1, the state the last step took recorded: each weight's
    placements and each moment's shard shape and placements against the
    specs. Both launcher runs record each block's local batch."""
    with f32_launcher() as lt:
        res = {}
        host = meshes.make_host_mesh("cpu")
        dp = meshes.make_mesh((2, 1), ("data", "model"), "cpu")
        for tag, mesh in (("1x2", host), ("2x1", dp)):
            for arch in ("olmoe-1b-7b", "arctic-480b"):
                for strategy in ("tp", "ep"):
                    res.update({f"{tag}/{k}": v for k, v in _moe_case(
                        arch, mesh, strategy).items()})
            for kv in (1, 2):
                res.update({f"{tag}/decode_kv{kv}/{k}": v
                            for k, v in _decode_case(mesh, kv).items()})

        with block_batches([]) as seen:
            losses = lt.train(launcher_args(ckpt_dir=ckpt_dir,
                                            ckpt_every=2), host)
        res["host_loss"] = [m["total_loss"] for m in losses]
        res["host_block_batch"] = seen

        state_seen = {}
        make = lt.make_train_step

        def recording(model, tc):
            step = make(model, tc)

            def fn(state, batch):
                state_seen["state"] = state
                return step(state, batch)
            return fn
        lt.make_train_step = recording
        with block_batches([]) as seen:
            losses = lt.train(launcher_args(), dp)
        lt.make_train_step = make
        res["zero1_loss"] = [m["total_loss"] for m in losses]
        res["zero1_block_batch"] = seen
        state = state_seen["state"]
        specs = module_pspecs(state.params)
        bad = []
        for n, p in state.params.named_parameters():
            pspec = fit_spec(p.shape, specs[n], dp)
            if tuple(p.placements) != placements(pspec, dp):
                bad.append(f"{n}: weight {p.placements}, want {pspec}")
            spec = zero1_pspec(pspec, p.shape, dp)
            want = [s // 2 if spec[d:d + 1] == ("data",) else s
                    for d, s in enumerate(p.shape)]
            for moments in (state.opt.m, state.opt.v):
                t = moments[n]
                if (tuple(t.to_local().shape) != tuple(want)
                        or tuple(t.placements) != placements(spec, dp)):
                    bad.append(f"{n}: {tuple(t.to_local().shape)} "
                               f"{t.placements}, want {want} {spec}")
            if "data" not in spec:
                bad.append(f"{n}: {spec} shards no dim over data")
        res["zero1_bad"] = "\n".join(bad)
    np.savez(out, **res)


def family_overrides(case: str) -> tuple[str, dict]:
    """``arch`` or ``arch:kv``: the arch and its config overrides (``kv``
    KV heads)."""
    arch, _, kv = case.partition(":")
    return arch, ({"num_kv_heads": int(kv)} if kv else {})


def scenario_family(rank, out, case):
    """The launcher, reduced ``case`` (:func:`family_overrides`) in f32, 2
    steps, on the host mesh (1, 2) and on a data-parallel (2, 1) mesh."""
    arch, overrides = family_overrides(case)
    with f32_launcher(**overrides) as lt:
        res = {}
        for tag, shape in (("host", (1, 2)), ("data", (2, 1))):
            losses = lt.train(launcher_args(arch=arch, steps=2),
                              meshes.make_mesh(shape, ("data", "model"),
                                               "cpu"))
            res[f"{tag}_loss"] = [m["total_loss"] for m in losses]
    np.savez(out, **res)


def main():
    scenario, out_dir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    meshes.init_process_group("cpu")
    rank = dist.get_rank()
    out = out_dir / f"{scenario}_{rank}.npz"
    try:
        if scenario == "reduce":
            scenario_reduce(rank, out)
        elif scenario == "two":
            scenario_two(rank, out, str(out_dir / "ckpt"))
        elif scenario == "family":
            scenario_family(rank, out, sys.argv[3])
        else:
            raise SystemExit(f"unknown scenario {scenario!r}")
    finally:
        meshes.destroy_process_group()


if __name__ == "__main__":
    main()
