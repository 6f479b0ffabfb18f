"""Multi-pod dry-run: account every (arch × shape) cell on the production
meshes — per-rank FLOPs, bytes, collective wire bytes and memory, and
the three roofline terms over the H100's figures (the JAX package's
``launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --mesh single --out results/torch_dryrun

Host-only, as the reference is: it compiles on placeholder host devices
and touches no accelerator, and this entry point touches no card. A
cell brings up a fake default process group of 256 ranks (16×16) or 512
(2×16×16; :func:`repro_torch.launch.mesh.fake_process_group`), this
process its rank 0, and builds ``make_production_mesh`` over it. The
weights, the train state and the inputs are fake tensors
(``FakeTensorMode``): shapes, dtypes and placements with no storage, so
nothing is allocated at these shapes (arctic-480b's 476.8 B weights
included). They are placed by the launcher's own specs
(``launch.specs``) as DTensors, and rank 0 runs one step of the port's
plain route on them — the differentiable route of
``models.layers.recording`` and the dense decode of
``models.attention.decode_attention`` — as the reference compiles its
plain jnp route (its Pallas kernels run only on a TPU). The tensors are
on the CPU, so no kernel wrapper is reached.

Per-rank accounting, under the reference's result keys:

* ``hlo_flops`` — the FLOPs of the rank's local ops, by
  ``torch.utils.flop_counter``'s formulas (the matrix products). DTensor
  also runs each op on fake tensors of the GLOBAL shape to propagate
  shapes; those calls are not the rank's work and are left out.
* ``hlo_bytes`` — the bytes that the local ops read and write (each
  tensor input and output of every op that is not a view): eager,
  unfused traffic, an upper bound on the HBM bytes a fused program
  would move.
* ``collectives`` — :func:`parse_collectives`'s dict from the
  ``_c10d_functional`` ops the rank calls: payload is the op's
  per-rank result, k its group's size, wire bytes by the same ring
  formulas (:func:`wire_bytes`). On a CPU mesh DTensor replaces an
  all-to-all by an all-gather; the dry-run calls the all-to-all NCCL
  would run on the card.
* ``memory`` — ``argument_bytes`` (the rank's state and inputs),
  ``output_bytes``, ``peak_bytes`` (the most bytes the rank's storages
  held at once, arguments included, tracked as the fake storages are
  made and freed) and ``temp_bytes`` (the peak less the arguments).

``lower_s`` is the time to build and place the fake state and inputs,
``compile_s`` the time of the accounted step. The reference's
``scan_layers`` sizes its compiled program; the port keeps one weight
per layer and walks them in a loop, so the flag is taken and changes
nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import sys
import threading
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import fake_process_group, make_production_mesh

# H100 SXM 80 GB datasheet figures (roofline denominators): dense bf16
# tensor-core FLOP/s, HBM3 bytes/s, and NVLink bytes/s each way per
# card. A 16-rank axis spans two 8-card hosts, whose link between them
# is slower than NVLink, so there the collective term is a lower bound.
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, NVLink, each way

# `%name = <result-shapes> <op>(args...)` — op token must directly precede
# its argument list, else fusion consumers referencing %all-reduce.N match
_OP_RE = re.compile(
    r"=\s*(\(?[a-z0-9_]+\[[0-9,]*\][^=()]*?\)?)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_SHAPES_RE = re.compile(r"([a-z0-9_]+)\[([0-9,]*)\]")

_DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "s8": 1,
                "u8": 1, "pred": 1, "f64": 8, "s64": 8, "u64": 8, "s16": 2,
                "u16": 2, "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8}


def wire_bytes(op: str, payload: float, k: int) -> float:
    """Wire bytes per chip of one collective by the ring formulas: AR
    2·S·(k-1)/k; AG/A2A S·(k-1)/k on the payload actually moved; RS
    S·k·(k-1)/k (its operand is the result × k); CP S."""
    frac = (k - 1) / k if k > 1 else 1.0
    if op == "all-reduce":
        return 2 * payload * frac
    if op == "reduce-scatter":
        return payload * k * frac  # operand = result × k
    if op in ("all-gather", "all-to-all"):
        return payload * frac
    return payload  # collective-permute


def collectives_from_calls(calls) -> dict:
    """{"ops": {op: {count, payload_bytes, wire_bytes}},
    "wire_bytes_per_chip"} of (op, payload bytes, group size) calls: what
    :func:`parse_collectives` returns, from :func:`collective_call`'s
    records or from the HLO's collectives."""
    per_op: dict[str, dict] = {}
    total_wire = 0.0
    for op, payload, k in calls:
        wire = wire_bytes(op, payload, k)
        d = per_op.setdefault(op, {"count": 0, "payload_bytes": 0.0,
                                   "wire_bytes": 0.0})
        d["count"] += 1
        d["payload_bytes"] += payload
        d["wire_bytes"] += wire
        total_wire += wire
    return {"ops": per_op, "wire_bytes_per_chip": total_wire}


def parse_collectives(hlo_text: str) -> dict:
    """Sum per-chip payload bytes of every collective in post-SPMD HLO.

    Result shapes in partitioned HLO are per-device. Wire bytes per chip
    use ring formulas (:func:`wire_bytes`). k comes from replica_groups
    when parseable.
    """
    calls = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        shapes_blob, op = m.groups()
        if f"{op}-done" in line:
            continue  # counted at -start
        payload = 0
        for dtype, dims in _SHAPES_RE.findall(shapes_blob):
            nbytes = _DTYPE_BYTES.get(dtype, 4)
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            payload += n * nbytes
        calls.append((op, payload, _group_size(line)))
    return collectives_from_calls(calls)


def _group_size(line: str) -> int:
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", line)
    if m:
        return int(m.group(2))
    m = re.search(r"replica_groups=\{\{([0-9, ]+)\}", line)
    if m:
        return len(m.group(1).split(","))
    return 2


# ------------------------------------------------------------ collectives
#: the functional collectives a rank calls → the HLO op they count as
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "isend": "collective-permute", "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_call(func, args, out):
    """(op, payload bytes, group size) of a functional collective ``func``
    called on ``args`` with result ``out``, or None for any other op.
    The payload is the per-rank result, as in partitioned HLO."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    op = _COLLECTIVE_OPS.get(func.__name__.split(".")[0])
    if op is None:
        return None
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a for a in args if isinstance(a, str)]
    k = _resolve_process_group(names[-1]).size() if names else 2
    payload = sum(_nbytes(t) for t in tree_leaves(out)
                  if isinstance(t, torch.Tensor))
    return op, payload, k


# ------------------------------------------------------------ accounting
_state = threading.local()


def _propagating() -> bool:
    return getattr(_state, "propagating", 0) > 0


@contextlib.contextmanager
def _rank_route():
    """While accounting: mark DTensor's global-shape shape propagation,
    whose ops are not the rank's, and send a reshard between two
    sharded dims through the all-to-all op that NCCL runs on the card
    (a CPU mesh falls back to an all-gather)."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    def marked(self, *a, **kw):
        _state.propagating = getattr(_state, "propagating", 0) + 1
        try:
            return orig(self, *a, **kw)
        finally:
            _state.propagating -= 1

    orig_a2a = getattr(placement_types, "shard_dim_alltoall", None)

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = mesh.get_group(mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, group.group_name)

    setattr(ShardingPropagator, name, marked)
    if orig_a2a is not None:
        placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)
        if orig_a2a is not None:
            placement_types.shard_dim_alltoall = orig_a2a


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _is_factory(func, tensors_in) -> bool:
    rets = func._schema.returns
    return (not tensors_in and len(rets) == 1
            and str(rets[0].type) == "Tensor")


class Accountant(TorchDispatchMode):
    """Counts the ops a rank runs on its local tensors: FLOPs, bytes read
    and written, collectives, and the bytes its storages hold (live and
    peak). Ops on DTensors are left to DTensor, which runs the local op
    on its shards (seen here) after its shape propagation (not counted).
    A factory (an op with no tensor input: ``zeros``, ``arange``, ...)
    of 16 MiB or more returns a fake tensor of ``fake_mode``, so that
    nothing large is allocated; smaller ones run for real, as DTensor's
    own bookkeeping needs."""

    FAKE_FACTORY_BYTES = 1 << 24

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes = 0
        self.calls: list = []
        self.live = 0
        self.peak = 0
        self._held: set = set()

    def hold(self, tensors) -> None:
        """Track the storages of ``tensors`` (once each) until they are
        freed."""
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held:
                continue
            n = st.nbytes()
            self._held.add(key)
            weakref.finalize(st, self._free, key, n)
            self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key, n) -> None:
        self._held.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _propagating():
            return func(*args, **kwargs)
        t_in = [a for a in tree_leaves((args, kwargs))
                if isinstance(a, torch.Tensor)]
        if _is_factory(func, t_in):
            with self.fake_mode:
                out = func(*args, **kwargs)
            if _nbytes(out) < self.FAKE_FACTORY_BYTES:
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        t_out = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        call = collective_call(func, args, out)
        if call is not None:
            self.calls.append(call)
        if t_out and not _is_view(func):
            self.bytes += sum(_nbytes(t) for t in t_in + t_out)
            self.hold(t_out)
        return out


def local_tensors(tree) -> list:
    """The rank's tensors in ``tree`` (nested dicts, tuples, modules'
    weights): each DTensor's local shard, each plain tensor itself."""
    from torch import nn
    from torch.distributed.tensor import DTensor

    out = []

    def walk(x):
        if isinstance(x, nn.Module):
            for p in x.parameters():
                walk(p)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, DTensor):
            out.append(x._local_tensor)
        elif isinstance(x, torch.Tensor):
            out.append(x)
    walk(tree)
    return out


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def account(fn, args: tuple, fake_mode) -> dict:
    """Run ``fn(*args)`` (``args``: fake tensors, placed) once under an
    :class:`Accountant`. Returns the per-rank counts: ``hlo_flops``,
    ``hlo_bytes``, ``collectives`` and ``memory``."""
    from torch.distributed.tensor.experimental import implicit_replication

    acct = Accountant(fake_mode)
    arg_bytes = _storage_bytes(local_tensors(args))
    acct.hold(local_tensors(args))
    with _rank_route(), implicit_replication(), acct:
        out = fn(*args)
    out_bytes = _storage_bytes(local_tensors(out))
    return {
        "hlo_flops": float(acct.flops), "hlo_bytes": float(acct.bytes),
        "collectives": collectives_from_calls(acct.calls),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": acct.peak - arg_bytes,
                   "peak_bytes": acct.peak},
    }


# ------------------------------------------------------------ the cells
def _zero_inputs(specs, mesh, pspecs, device):
    """Zeros of each spec's shape and dtype (fake under the caller's
    FakeTensorMode), placed by ``pspecs``."""
    from repro_torch.parallel.sharding import place

    if isinstance(specs, dict):
        return {k: _zero_inputs(v, mesh, pspecs[k], device)
                for k, v in specs.items()}
    return place(torch.zeros(specs.shape, dtype=specs.dtype, device=device),
                 mesh, pspecs)


def build_step(arch: str, shape, mesh, tc: TrainConfig, cfg=None,
               device="cpu"):
    """Returns (fn, args, cfg): one train step
    (forward, backward, AdamW, the state redistributed to its specs),
    one ``prefill_fn`` or one ``decode_fn`` step, on fake weights, state
    and inputs placed on ``mesh`` (a mesh of one rank: plain tensors).
    Call it under a ``FakeTensorMode`` (on ``device``, the CPU; a real
    step on a card, to hold the counts against, builds there outside
    it). ``shape`` is a ``SHAPES`` name or a ``ShapeConfig``."""
    from repro_torch.launch.specs import StateShardings, input_pspecs
    from repro_torch.models import build_model
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    train = shape.kind == "train"
    model = build_model(cfg, device=device, trainable=train)
    specs = model.input_specs(shape)
    inputs = _zero_inputs(specs, mesh, input_pspecs(cfg, specs, mesh),
                          device)
    shardings = StateShardings.of(model.params, mesh,
                                  zero1=train and tc.zero1,
                                  moe_tp=cfg.moe_strategy == "tp")
    if train:
        state = shardings.place(init_train_state(model,
                                                 params=model.params))
        train_step = make_train_step(model, tc)

        def step_fn(state, batch):
            new, metrics = train_step(state, batch)
            return shardings.constrain(new), metrics
        return step_fn, (state, inputs), cfg
    shardings.place_params(model.params)
    if shape.kind == "prefill":
        return model.prefill_fn, (model.params, inputs), cfg
    return (model.decode_fn, (model.params, inputs["cache"], inputs["token"],
                              inputs["pos"]), cfg)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N(_active)·tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len / 3.0  # fwd only: 2N·D
        return 2.0 * n * shape.global_batch * shape.seq_len
    else:
        return 2.0 * n * shape.global_batch
    return 6.0 * n * toks


def account_cell(arch: str, shape, mesh, tc: TrainConfig, cfg=None) -> dict:
    """The per-rank counts of one step of ``arch`` at ``shape`` on
    ``mesh`` (:func:`account`), with ``lower_s`` (build and place) and
    ``compile_s`` (the accounted step)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.parallel.sharding import use_mesh

    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    t0 = time.time()
    with use_mesh(mesh):
        with fake_mode:
            fn, args, cfg = build_step(arch, shape, mesh, tc, cfg=cfg)
        t_lower = time.time() - t0
        counts = account(fn, args, fake_mode)
    counts["lower_s"] = t_lower
    counts["compile_s"] = time.time() - t0 - t_lower
    return counts


def derive(counts: dict, cfg, shape, n_chips: int) -> dict:
    """The reference's derived keys from the per-rank counts."""
    mf = model_flops(cfg, shape)
    hlo_flops = counts["hlo_flops"]
    # the counts are PER RANK, so the roofline terms divide by per-card
    # peaks directly (global = per-rank × ranks)
    terms = {"compute_s": hlo_flops / PEAK_FLOPS,
             "memory_s": counts["hlo_bytes"] / HBM_BW,
             "collective_s":
                 counts["collectives"]["wire_bytes_per_chip"] / LINK_BW}
    dominant = max(terms, key=terms.get)
    return {
        "model_flops": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_frac": (mf / n_chips) / hlo_flops if hlo_flops else None,
        **terms,
        "dominant": dominant,
        # step-time lower bound assuming zero overlap between the three
        # engines; roofline_frac = useful-FLOPs time / that bound (an MFU
        # upper bound for this program)
        "step_time_lb_s": max(terms.values()),
        "roofline_frac": ((mf / n_chips / PEAK_FLOPS) / max(terms.values())
                          if max(terms.values()) > 0 else None),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             tc: TrainConfig | None = None, extra: dict | None = None,
             overrides: dict | None = None) -> dict:
    cfg = get_config(arch)
    # the reference unrolls its layers here; the port's are a loop
    # already, and the flag changes nothing (see the module docstring)
    ov = {"scan_layers": False, **(overrides or {})}
    cfg = dataclasses.replace(cfg, **ov)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped",
                "reason": "full-attention arch; long_500k needs sub-quadratic "
                          "attention (DESIGN.md §Arch-applicability)"}
    tc = tc or TrainConfig()
    with fake_process_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        counts = account_cell(arch, shape, mesh, tc, cfg=cfg)
    n_chips = mesh.size
    out = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "n_chips": n_chips,
        "status": "ok",
        "lower_s": round(counts["lower_s"], 1),
        "compile_s": round(counts["compile_s"], 1),
        "memory": counts["memory"],
        "hlo_flops": counts["hlo_flops"], "hlo_bytes": counts["hlo_bytes"],
        "collectives": counts["collectives"],
        **derive(counts, cfg, shape, n_chips),
    }
    if extra:
        out.update(extra)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default=None, help="directory for JSON results")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--scan-layers", action="store_true",
                    help="the reference's lax.scan over layers; the port's "
                         "layers are a loop, so this changes nothing")
    # §Perf hillclimb knobs
    ap.add_argument("--moe-strategy", default=None, choices=["ep", "tp"])
    ap.add_argument("--bf16-reduce", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--decode-partials", action="store_true")
    ap.add_argument("--decode-grouped", action="store_true")
    ap.add_argument("--attn-bf16-probs", action="store_true")
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args()

    tc = TrainConfig(microbatches=args.microbatches,
                     zero1=not args.no_zero1)
    overrides = {}
    if args.scan_layers:
        overrides["scan_layers"] = True
    if args.remat:
        overrides["remat"] = args.remat
    if args.moe_strategy:
        overrides["moe_strategy"] = args.moe_strategy
    if args.bf16_reduce:
        overrides["bf16_reduce"] = True
    if args.seq_parallel:
        overrides["seq_parallel"] = True
    if args.decode_partials:
        overrides["decode_partials"] = True
    if args.decode_grouped:
        overrides["decode_grouped"] = True
    if args.attn_bf16_probs:
        overrides["attn_bf16_probs"] = True
    if args.attn_chunk:
        overrides["attn_chunk"] = args.attn_chunk
    if args.capacity_factor:
        overrides["capacity_factor"] = args.capacity_factor
    try:
        res = run_cell(args.arch, args.shape, args.mesh == "multi", tc,
                       extra={"tag": args.tag}, overrides=overrides)
    except Exception as e:
        res = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:], "tag": args.tag}
    print(json.dumps({k: v for k, v in res.items() if k != "trace"},
                     indent=2, default=str))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        fname = f"{args.arch}__{args.shape}__{args.mesh}__{args.tag}.json"
        with open(os.path.join(args.out, fname), "w") as f:
            json.dump(res, f, indent=2, default=str)
    sys.exit(0 if res["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
