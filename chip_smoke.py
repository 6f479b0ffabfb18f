#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Builds every kernel from ``src/repro_torch/csrc`` with nvcc (one process
per source, all at once) and drives the port's three paths:

* the simulator (phases ``kernels``, ``paper``, ``mega``): the fleet
  kernels K1-K3 against their plain torch versions, then
  ``engine="torch"`` through the paper scenarios and the mega-scale
  federations, each result checked against the port's batched engine;
* serving (phase ``serving``): the attention kernels K4 (flash prefill)
  and K5 (paged decode) against their plain versions, full-width
  tinyllama-1.1b in the multi-tenant engine on the card, its prefill
  logits against the CPU on a 2-layer cut of the same weights, and both
  serving scenarios on the card against the same scenarios on the CPU;
* recurrent serving (phase ``recurrent``): the recurrent kernels K6
  (RWKV-6) and K7 (Mamba-2 SSD) against their plain versions, K4/K5 at
  zamba2's head dim 80, one full-width rwkv6-3b and one zamba2-2.7b
  tenant in the engine on the card, and their prefill logits against
  the CPU on cuts of the same weights.

Each path's launch counts are reset just before it and read just after.
Needs one CUDA card; exits non-zero on any failure.

    python3 chip_smoke.py                 # everything
    python3 chip_smoke.py --phases env,kernels
    python3 chip_smoke.py --phases env,serving
    python3 chip_smoke.py --phases env,recurrent

The line before the last is the card (``nvidia-smi`` name and power
limit) and, before that, the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("env", "kernels", "paper", "mega", "serving", "recurrent")
VR_TOL = 0.02           # engine="torch" vs the port's batched engine
CPU_GPU_VR_TOL = 1e-3   # the same engine on the card and on the CPU
SUM_RTOL = 1e-5         # f32 row sums in another order (K1/K2 else exact)
# main-path sizes: the jaxscale stream row (4 × 25,000 tenants) and a
# 4 × 2,500 game federation whose 120 s chunks reach L = 6848 requests
STREAM_TENANTS = 100_000
GAME_TENANTS = 10_000
GAME_L = 6848
CHUNK_S = 120
SWEEP_CELLS = STREAM_TENANTS * CHUNK_S   # K2's threshold sweep, a call
DEVICE = "cuda"
# serving: full-width tinyllama-1.1b, 2 tenants × 4 requests of 1024
# prompt tokens and 32 new tokens; the attention kernels at its shapes
SERVE_ARCH = "tinyllama-1.1b"
SERVE_TENANTS = 2
SERVE_REQUESTS = 4
SERVE_PROMPT = 1024
SERVE_NEW = 32
SERVE_SMAX = 2048
SERVE_CUT_LAYERS = 2        # CPU-vs-card check on a cut of the weights
SERVE_CUT_PROMPT = 512
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # tests/test_kernels.py
LOGIT_TOL = 5e-2            # × max |logit|, bf16 CPU vs card
FLEET_KERNELS = ("latency_scale", "row_draw", "poisson")
SERVING_KERNELS = ("flash_attention", "paged_attention")
# recurrent serving: one full-width rwkv6-3b and one zamba2-2.7b tenant,
# the same requests; the CPU-vs-card cuts keep 2 RWKV-6 layers and
# zamba2's first group (its shared block and 6 Mamba-2 layers). In f32
# the card's logits must agree with the CPU's within REC_F32_TOL × max
# |logit|. In the served bf16 the card's logits are held to the CPU's
# f32 ones, within BF16_NOISE_FACTOR × the CPU's own bf16-vs-f32
# distance: zamba2's group rounds in bf16 about as far from f32 (5-8 %
# of max |logit| on an H100 and on the CPU) as 5e-2 × max |logit|, so a
# fixed bf16-vs-bf16 limit would measure where each side rounds
REC_ARCHS = ("rwkv6-3b", "zamba2-2.7b")
REC_CUT_LAYERS = 2
REC_F32_TOL = 1e-3          # × max |logit|, f32 CPU vs card
BF16_NOISE_FACTOR = 2.0
RECURRENT_KERNELS = ("rwkv6", "ssd")
REC_PATH_KERNELS = RECURRENT_KERNELS + SERVING_KERNELS


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int = 20) -> float | None:
    """Mean device time per call of the CUDA kernels whose name holds
    ``kernel``, from a torch.profiler trace of ``reps`` calls; None when
    the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except (RuntimeError, AssertionError) as e:
        log(f"profiler unavailable ({e}); timing with CUDA events")
        return None
    total_us = sum(getattr(e, "device_time_total", 0.0)
                   for e in prof.key_averages() if kernel in e.key)
    return total_us / reps / 1e3 if total_us else None


def kernel_times(fn, kernel: str, reps: int = 20) -> dict:
    """``ms``: the device time of the call's kernels whose name holds
    ``kernel`` ("" for all of them), from the profiler, else the
    CUDA-event time; ``event_ms``: CUDA events around each call, which
    also count the host's launch path when the kernels are shorter."""
    ev = cuda_ms(fn, reps=reps)
    dev = device_ms(fn, kernel, reps=reps)
    return {"ms": dev if dev is not None else ev, "event_ms": ev,
            "ms_source": "profiler" if dev is not None else "events"}


def all_kernels_ms(fn, reps: int = 5) -> float:
    """Summed device time per call of every kernel ``fn`` launches (the
    plain versions and library calls are many kernels with host work in
    between); the CUDA-event time when the profiler records nothing."""
    return kernel_times(fn, "", reps=reps)["ms"]


def graph_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA
    graph, the graph replayed between two CUDA events (median of
    ``reps``), divided by ``n``. Replay issues no host work per call, so
    this is the device's own time for the call's kernels, launch gaps
    inside the graph included and the host's dispatch excluded."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------- phase 1
def phase_env(fleet) -> dict:
    import torch

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi_line()}")
    nvcc = subprocess.run([fleet._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    log(f"nvcc: {nvcc[-1] if nvcc else '?'}")
    secs = fleet.build(verbose=True)
    log(f"kernel build: {secs:.2f} s (nvcc {' '.join(fleet.NVCC_FLAGS)}; "
        f"-fmad=false for {', '.join(fleet._NO_FMAD)})")
    ptxas = {}
    for name in FLEET_KERNELS + SERVING_KERNELS + RECURRENT_KERNELS:
        ptxas[name] = ptxas_report(fleet.BUILD_LOGS.get(name, ""))
        for f in ptxas[name]:
            log(f"[ptxas] {name} {f['function']}: {f['registers']} "
                f"registers, spill stores/loads {f['spill_stores']}/"
                f"{f['spill_loads']} B, stack {f['stack']} B"
                + (", wgmma SERIALIZED" if f["wgmma_serialized"] else ""))
    # the fleet kernels are issue-bound: a spill is instructions and
    # local-memory traffic in every cell; a kernel whose own spill line
    # was not read counts as a failure, not as a kernel that does not
    # spill
    spills = [f"{name} {f['function']}" for name in FLEET_KERNELS
              for f in ptxas[name] if f["spill_stores"] or f["spill_loads"]]
    unread = [f"{name} {f['function']}" for name in FLEET_KERNELS
              for f in ptxas[name]
              if f["spill_stores"] is None or f["spill_loads"] is None]
    unread += [name for name in FLEET_KERNELS if not ptxas[name]]
    if spills:
        log(f"[ptxas] fleet kernels that spill: {', '.join(spills)}")
    if unread:
        log(f"[ptxas] fleet kernels without a spill line: "
            f"{', '.join(unread)}")
    sass = poisson_sass(fleet)
    failures = ([f"{f} spills" for f in spills]
                + [f"{f} has no spill line in the ptxas log" for f in unread]
                + ([] if sass.get("ok") else
                   [f"poisson SASS counts: {sass.get('why')}"]))
    return {"build_s": secs, "ptxas": ptxas, "fleet_spills": spills,
            "sass": sass, "failures": failures}


#: SASS opcodes by the pipe that executes them (sm_90): the f64 pipe,
#: the integer ALU pipe, the FMA pipe, the transcendental/conversion
#: unit, memory, control; the rest (shuffles, votes, moves to and from
#: the uniform datapath) count as "other"
SASS_PIPES = {
    "f64": ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"),
    "alu": ("LOP3", "LOP", "SHF", "IADD3", "ISETP", "SEL", "FSEL", "LEA",
            "PRMT", "IABS", "IMNMX", "FSETP", "FMNMX", "PLOP3", "P2R", "R2P",
            "FLO", "POPC", "BREV", "MOV", "SGXT", "BMSK", "VIADD", "VIMNMX"),
    "fma": ("IMAD", "FFMA", "FADD", "FMUL", "HFMA2", "IMUL", "FCHK"),
    "xu": ("MUFU", "I2F", "F2I", "F2F", "FRND", "I2FP", "F2IP"),
    "mem": ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDL", "STL", "ATOMG",
            "ATOM", "ATOMS", "RED", "LDC"),
    "ctl": ("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "WARPSYNC",
            "NOP", "BAR", "YIELD", "JMP", "BRX"),
}


def sass_blocks(text: str) -> dict:
    """``cuobjdump -sass`` output cut into basic blocks: for each
    function, a list of (start address, [(address, instruction)])."""
    import re

    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    out = {}
    for name, ins in funcs.items():
        targets = {int(t, 16) for _, txt in ins
                   for t in re.findall(r"\b(?:BRA|BSSY|CALL\.\w+|JMP)\b"
                                       r"[^;]*?0x([0-9a-f]+)", txt)}
        blocks, block = [], []
        for addr, txt in ins:
            if addr in targets and block:
                blocks.append(block)
                block = []
            block.append((addr, txt))
            # BRA.DIV leaves only for a diverged warp: it does not end
            # the block that a converged warp runs
            if (_sass_op(txt) in ("BRA", "EXIT", "RET", "CALL", "JMP", "BRX")
                    and "BRA.DIV" not in txt):
                blocks.append(block)
                block = []
        if block:
            blocks.append(block)
        out[name] = [(b[0][0], b) for b in blocks]
    return out


def _sass_op(txt: str) -> str:
    """The opcode without predicate and modifiers: ``@!P0 DFMA.RM`` ->
    DFMA."""
    words = txt.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def sass_pipes(block) -> dict:
    """Instructions of a block by pipe (SASS_PIPES), and all of them."""
    counts = dict.fromkeys(SASS_PIPES, 0)
    counts["other"] = 0
    for _, txt in block:
        op = _sass_op(txt)
        if op == "NOP":
            continue
        pipe = next((k for k, ops in SASS_PIPES.items() if op in ops),
                    "other")
        counts[pipe] += 1
    counts["all"] = sum(counts.values())
    return counts


#: K3's inversion steps between two looks (kSteps in csrc/poisson.cu):
#: the search block of its SASS holds this many steps
POISSON_STEPS = 16


def poisson_sass(fleet) -> dict:
    """K3's SASS counted by pipe: the search block (the basic block that
    ends in the warp's vote, with the most f64 instructions) divided by
    its steps, and the set-up block (the one that holds threefry's key
    constant 0x1bd11bda, interleaved with exp). ``ok`` is true only when
    the (f64, alu) counts equal fleet.POISSON_STEP_OPS and
    POISSON_SETUP_OPS, the counts of the bound; else ``why`` says what
    differs or was not found."""
    name = "poisson"
    lib = fleet._LIBS.get(name)
    tool = Path(fleet._nvcc()).with_name("cuobjdump")
    if lib is None or not tool.exists():
        why = "no library or no cuobjdump"
        log(f"[sass] {name}: {why}")
        return {"ok": False, "why": why}
    text = subprocess.run([str(tool), "-sass", lib._name],
                          capture_output=True, text=True).stdout
    for func, blocks in sass_blocks(text).items():
        if "poisson_kernel" not in func:
            continue
        counts = [(sass_pipes(b), b) for _, b in blocks]
        loops = [c for c, b in counts if any("VOTE" in t for _, t in b)]
        setups = [c for c, b in counts
                  if any("0x1bd11bda" in t for _, t in b)]
        if not loops or not setups:
            why = "no search or set-up block found"
            log(f"[sass] {name}: {why}")
            return {"ok": False, "why": why}
        loop = max(loops, key=lambda c: c["f64"])
        step = {k: v / POISSON_STEPS for k, v in loop.items()}
        setup = max(setups, key=lambda c: c["all"])
        total = sass_pipes([i for _, b in blocks for i in b])
        for what, c in (("search block", loop), ("a step", step),
                        ("set-up block", setup), ("kernel", total)):
            log(f"[sass] {name} {what}: "
                + ", ".join(f"{k} {v:g}" for k, v in c.items() if v))
        got = ((step["f64"], step["alu"]), (setup["f64"], setup["alu"]))
        want = (fleet.POISSON_STEP_OPS, fleet.POISSON_SETUP_OPS)
        ok = got == want
        why = (f"(f64, alu) a step {got[0]}, a set-up {got[1]}; the bound "
               f"counts {want[0]}, {want[1]}")
        log(f"[sass] {name}: {why}: {'ok' if ok else 'FAIL'}")
        return {"ok": ok, "why": why, "function": func,
                "search_block": loop, "step": step, "setup_block": setup,
                "total": total}
    why = "no poisson_kernel in the SASS"
    log(f"[sass] {name}: {why}")
    return {"ok": False, "why": why}


def ptxas_report(text: str) -> list:
    """Registers, spills and stack of each kernel in nvcc's ``-Xptxas
    -v`` output, and whether ptxas serialized its wgmma instructions."""
    import re

    def short(mangled):
        # the kernel's name: the mangled identifier that ends in _kernel
        # (a length, then that many characters), and its template args
        for i in range(len(mangled)):
            m = re.match(r"\d+", mangled[i:])
            name = m and mangled[i + m.end():i + m.end() + int(m.group())]
            if name and name.endswith("_kernel"):
                break
        else:
            return mangled
        m = re.match(r"I(.*?)EEv", mangled[i + m.end() + len(name):])
        if not m:
            return name
        args = re.findall(r"Li(\d+)E|Lb(\d)E|(f)|13__nv_bfloat16|(S\d*_)",
                          m.group(1) + "E")
        names = [n or {"1": "tc", "0": "fma"}.get(b) or ("f32" if f else "bf16")
                 for n, b, f, _ in args]
        return f"{name}<{','.join(names)}>"

    out, cur, entry, props = [], None, None, None
    serialized = set(re.findall(r"serialized[^']*'(\w+)'", text))
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            cur = {"function": short(entry), "registers": None,
                   "spill_stores": None, "spill_loads": None, "stack": None,
                   "wgmma_serialized": entry in serialized}
            out.append(cur)
            continue
        if cur is None:
            continue
        # a kernel's lines name it; those of the device functions it
        # calls (lgamma's, say) follow and must not overwrite them
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props == entry:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


# ---------------------------------------------------------------- phase 2
def _keys(names, seed=7):
    import numpy as np
    import torch

    from repro_torch.sim.engines.torch_backend import _row_key_words

    k0, k1 = _row_key_words(np.full(len(names), seed, np.uint32), names)
    return (torch.from_numpy(k0.view(np.int32)).to(DEVICE),
            torch.from_numpy(k1.view(np.int32)).to(DEVICE))


def phase_kernels(fleet) -> dict:
    """Each kernel against its plain version on the same CUDA tensors,
    at the shapes the main path gives it."""
    import numpy as np
    import torch

    from repro_torch.sim.engines.torch_backend import _chunk_word
    from repro_torch.sim.workload import (FleetBatch, make_game_fleet,
                                          make_stream_fleet)

    results = {}
    rng = np.random.default_rng(11)

    # ---- K1 latency_scale at (10^4, 120): a game fleet's chunk
    game = make_game_fleet(GAME_TENANTS, np.random.default_rng(42))
    fb = FleetBatch(game)
    units = rng.integers(1, 40, len(game)).astype(np.int64)
    demand = fb.demand_rates(0, CHUNK_S)
    capacity = np.maximum(units, 1) * fb.unit_rate

    def f32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(DEVICE)

    args = (f32(fb.base_pf), f32(fb.alpha), f32(demand), f32(capacity))
    got = fleet.latency_scale(*args)
    ref = fleet.latency_scale_plain(*args)
    torch.cuda.synchronize()
    rel = float(((got - ref).abs() / ref.abs()).max())
    err = float((got - ref).abs().max())
    mism = int((got != ref).sum())
    f64_ref = fb.latency_scale(units, 0, CHUNK_S)
    rel64 = float(np.max(np.abs(got.cpu().numpy() - f64_ref) / f64_ref))
    # powf runs on the cells where rho > 1: count this run's
    pow_cells = int((args[2] / args[3][:, None] > 1.0).sum())
    bound, by = fleet.latency_scale_bound_ms(*demand.shape,
                                             pow_cells=pow_cells)
    results["latency_scale"] = dict(
        shape=list(demand.shape), max_abs_err=err, max_rel_err=rel,
        max_rel_err_vs_numpy_f64=rel64, mismatches=mism,
        pow_cells=pow_cells,
        **kernel_times(lambda: fleet.latency_scale(*args),
                       "latency_scale_kernel"),
        plain_ms=all_kernels_ms(lambda: fleet.latency_scale_plain(*args)),
        bound_ms=bound, bound_by=by,
        **dict(zip(("bytes_bound_ms", "ops_bound_ms"),
                   fleet.latency_scale_bound_terms(*demand.shape,
                                                   pow_cells))),
        library_ms=None,
        ok=mism == 0 and rel64 <= 2e-5)

    # ---- K2 row_draw, dense at (10^5, 120): the stream federation chunk
    stream = make_stream_fleet(STREAM_TENANTS, np.random.default_rng(42))
    sb = FleetBatch(stream)
    k0, k1 = _keys([w.name for w in stream])
    counts = sb.arrival_counts([None] * len(stream), 0, CHUNK_S)
    scale = f32(sb.latency_scale(np.full(len(stream), 16, np.int64),
                                 0, CHUNK_S)[:, 0])
    sigma = f32([w.jitter_sigma for w in stream])
    slo = f32([w.base_latency for w in stream])
    active = torch.from_numpy(counts > 0).to(DEVICE)
    ch = _chunk_word(0, 1)
    dense_kw = dict(sigma=sigma, scale=scale, slo=slo, active=active)
    got = fleet.row_draw("dense", k0, k1, ch, **dense_kw)
    dense_ref = fleet.row_draw_plain("dense", k0, k1, ch, CHUNK_S, scale,
                                     sigma, slo, active, None)
    results["row_draw"] = _row_draw_check(fleet, "dense", got, dense_ref,
                                          counts.shape)
    results["row_draw"].update(
        **kernel_times(lambda: fleet.row_draw("dense", k0, k1, ch,
                                              **dense_kw), "row_draw_kernel"),
        plain_ms=all_kernels_ms(lambda: fleet.row_draw_plain(
            "dense", k0, k1, ch, CHUNK_S, scale, sigma, slo, active, None),
            reps=5))

    # ---- K2 fused and jitter at (10^4, 6848): the game federation's L
    G, L = GAME_TENANTS, GAME_L
    gk0, gk1 = _keys([w.name for w in game])
    gsig = f32([w.jitter_sigma for w in game])
    gscale = f32(rng.uniform(0.05, 0.2, G))
    gslo = f32([w.base_latency for w in game])
    totals = torch.from_numpy(rng.integers(0, L + 1, G).astype(np.int32)
                              ).to(DEVICE)
    fused_kw = dict(cols=L, sigma=gsig, scale=gscale, slo=gslo,
                    totals=totals)
    got = fleet.row_draw("fused", gk0, gk1, ch, **fused_kw)
    fused_ref = fleet.row_draw_plain("fused", gk0, gk1, ch, L, gscale, gsig,
                                     gslo, None, totals)
    fused = _row_draw_check(fleet, "fused", got, fused_ref, (G, L))
    fused.update(
        **kernel_times(lambda: fleet.row_draw("fused", gk0, gk1, ch,
                                              **fused_kw), "row_draw_kernel"),
        plain_ms=all_kernels_ms(lambda: fleet.row_draw_plain(
            "fused", gk0, gk1, ch, L, gscale, gsig, gslo, None, totals),
            reps=3))
    got = fleet.row_draw("jitter", gk0, gk1, ch, cols=L, sigma=gsig)
    jref = fleet.row_draw_plain("jitter", gk0, gk1, ch, L, None, gsig)
    torch.cuda.synchronize()
    jerr = float(((got - jref).abs() / jref).max())
    jmism = _draw_diff(got, jref)[0]
    bound, by = fleet.row_draw_bound_ms("jitter", G, L)
    jitter = dict(
        shape=[G, L], max_abs_err=float((got - jref).abs().max()),
        max_rel_err=jerr, mismatches=jmism,
        **kernel_times(lambda: fleet.row_draw("jitter", gk0, gk1, ch,
                                              cols=L, sigma=gsig),
                       "row_draw_kernel"),
        plain_ms=all_kernels_ms(lambda: fleet.row_draw_plain(
            "jitter", gk0, gk1, ch, L, None, gsig), reps=3),
        bound_ms=bound, bound_by=by, library_ms=None, ok=jmism == 0)
    results["row_draw"]["modes"] = {"fused": fused, "jitter": jitter}
    sweep = row_draw_sweep(
        fleet, np.random.default_rng(12),
        ("dense", (k0, k1, ch), dense_kw, dense_ref),
        ("fused", (gk0, gk1, ch), fused_kw, fused_ref),
        ("jitter", (gk0, gk1, ch), dict(cols=L, sigma=gsig), jref))
    results["row_draw"]["sweep"] = sweep
    results["row_draw"]["ok"] = (results["row_draw"]["ok"] and fused["ok"]
                                 and jitter["ok"]
                                 and all(r["ok"] for r in sweep))

    # ---- K3 poisson at (10^4, 120): the game fleet's arrival rates;
    # a (10^3, 120) block at lam = 150 covers the PTRS branch
    lam = f32(type(game[0]).batch_arrival_lam(game, 0, CHUNK_S))
    cha = _chunk_word(0, 0)
    got = fleet.poisson(gk0, gk1, cha, lam)
    ref = fleet.poisson_plain(gk0, gk1, cha, lam)
    torch.cuda.synchronize()
    mism = int((got != ref).sum())
    nb = min(1000, GAME_TENANTS)
    lam_big = torch.full((nb, CHUNK_S), 150.0, device=DEVICE)
    got_big = fleet.poisson(gk0[:nb], gk1[:nb], cha, lam_big)
    ref_big = fleet.poisson_plain(gk0[:nb], gk1[:nb], cha, lam_big)
    torch.cuda.synchronize()
    mism_big = int((got_big != ref_big).sum())
    mean_big = float(got_big.double().mean())
    var_big = float(got_big.double().var())
    bound, by = fleet.poisson_bound_ms(lam.cpu().numpy(),
                                       got.cpu().numpy())
    rates = poisson_rates(fleet, (gk0, gk1, cha), lam)
    results["poisson"] = dict(
        shape=list(lam.shape),
        max_abs_err=float(max((got - ref).abs().max(),
                              (got_big - ref_big).abs().max())),
        mismatches=mism + mism_big, ptrs_mean=mean_big, ptrs_var=var_big,
        **kernel_times(lambda: fleet.poisson(gk0, gk1, cha, lam),
                       "poisson_kernel"),
        plain_ms=all_kernels_ms(
            lambda: fleet.poisson_plain(gk0, gk1, cha, lam), reps=3),
        bound_ms=bound, bound_by=by,
        **dict(zip(("bytes_bound_ms", "f64_bound_ms", "alu_bound_ms"),
                   fleet.poisson_bound_terms(lam.cpu().numpy(),
                                             got.cpu().numpy()))),
        library_ms=all_kernels_ms(lambda: torch.poisson(lam), reps=20),
        rates=rates,
        ok=(mism + mism_big == 0 and all(r["ok"] for r in rates)
            and abs(mean_big - 150.0) < 5 * math.sqrt(150.0 / lam_big.numel())
            and abs(var_big / 150.0 - 1.0) < 0.05))
    for name, r in results.items():
        log(f"[kernel] {name}: " + json.dumps(
            {k: v for k, v in r.items() if k != "sweep"}))
        rows = [(name, r)] + [(f"{name}/{m}", v)
                              for m, v in r.get("modes", {}).items()]
        for label, v in rows:
            log(f"[kernel] {label} {v['shape']}: max err "
                f"{v['max_abs_err']:.3g}, mismatches {v['mismatches']}, kernel {v['ms']:.4f} ms "
                f"({v['ms_source']}; events {v['event_ms']:.4f} ms), plain "
                f"{v['plain_ms']:.3f} ms, bound {v['bound_ms'] * 1e3:.2f} µs "
                f"({v['bound_by']}) {'ok' if v['ok'] else 'FAIL'}")
    return results


def _draw_diff(got, ref) -> tuple[int, float]:
    """K2's outputs against the plain version's: the cells and rows whose
    latencies, flags or counts differ, and the row sums' largest
    relative error (0 for jitter, which has none)."""
    if not isinstance(got, tuple):
        return int((got != ref).sum()), 0.0
    bad = sum(int((x != y).sum())
              for x, y in zip(got[:2] + got[3:], ref[:2] + ref[3:]))
    rel = (got[2] - ref[2]).abs() / ref[2].abs().clamp(min=1e-30)
    return bad, float(rel.max())


def _row_draw_check(fleet, mode, got, ref, shape) -> dict:
    """Dense/fused outputs against the plain version: latencies, flags
    and counts bit for bit (``mismatches`` counts the cells and rows
    that differ), row sums (another order) within SUM_RTOL."""
    import torch

    lat, rlat = got[0], ref[0]
    torch.cuda.synchronize()
    rel = ((lat - rlat).abs() / rlat.abs()).max()
    mism, sum_rel = _draw_diff(got, ref)
    bound, by = fleet.row_draw_bound_ms(mode, *shape)
    return dict(shape=list(shape),
                max_abs_err=float((lat - rlat).abs().max()),
                max_rel_err=float(rel), mismatches=mism,
                row_sum_max_rel_err=sum_rel, bound_ms=bound, bound_by=by,
                library_ms=None, ok=mism == 0 and sum_rel <= SUM_RTOL)


def row_draw_sweep(fleet, rng, dense, fused, jitter) -> list:
    """K2's layouts timed at the main shapes: V and rows a CTA on the
    dense (10^5, 120) chunk; the short/wide threshold on dense chunks of
    SWEEP_CELLS (1.2e7) cells at 120, 256 and 512 columns; V and warps a CTA of
    the wide path on the fused and jitter (10^4, 6848) ones. Every
    layout is held to the plain version as the default one is."""
    import numpy as np
    import torch

    base = fleet.ROW_DRAW_LAYOUT
    out = []

    def one(label, mode, keys, kw, ref, layout):
        got = fleet.row_draw(mode, *keys, layout=layout, **kw)
        torch.cuda.synchronize()
        bad, sum_rel = _draw_diff(got, ref)
        ms = kernel_times(lambda: fleet.row_draw(mode, *keys, layout=layout,
                                                 **kw), "row_draw_kernel",
                          reps=10)["ms"]
        rec = {"case": label, "mode": mode, "layout": layout._asdict(),
               "ms": ms, "mismatches": bad, "row_sum_max_rel_err": sum_rel,
               "ok": bad == 0 and sum_rel <= SUM_RTOL,
               "default": layout == base}
        out.append(rec)
        log(f"[kernel] row_draw sweep {label} {mode}, short V/warps/max "
            f"{layout.short_v}/{layout.short_warps}/{layout.short_max}, wide "
            f"V/warps {layout.wide_v}/{layout.wide_warps}: "
            f"{ms:.4f} ms{' (default)' if rec['default'] else ''} "
            f"{'ok' if rec['ok'] else f'FAIL {bad} mismatches'}")

    mode, keys, kw, ref = dense
    for v in (2, 4):
        for w in (4, 8, 16):
            one("short V x rows a CTA", mode, keys, kw, ref,
                base._replace(short_v=v, short_warps=w))
    # the threshold: the same cells a call, short against wide
    for cols in (120, 256, 512):
        rows = SWEEP_CELLS // cols
        k0 = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, rows,
                                           dtype=np.int64).astype(np.int32))
        k1 = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, rows,
                                           dtype=np.int64).astype(np.int32))
        vec = {k: torch.from_numpy(rng.uniform(lo, hi, rows).astype(
            np.float32)).to(DEVICE) for k, lo, hi in (
                ("scale", 0.05, 3.0), ("sigma", 0.08, 0.3), ("slo", 0.1, 3.0))}
        act = torch.from_numpy(rng.random((rows, cols)) < 0.5).to(DEVICE)
        keys_c = (k0.to(DEVICE), k1.to(DEVICE), keys[2])
        ref_c = fleet.row_draw_plain("dense", *keys_c, cols, vec["scale"],
                                     vec["sigma"], vec["slo"], act, None)
        kw_c = dict(active=act, **vec)
        for short_max in (1 << 20, 0):
            one(f"threshold ({rows}, {cols}) "
                f"{'short' if short_max else 'wide'}", "dense", keys_c,
                kw_c, ref_c, base._replace(short_max=short_max))
        del ref_c, act
    for mode, keys, kw, ref in (fused, jitter):
        for v in (2, 4):
            for w in (4, 8, 16):
                one("wide V x warps a CTA", mode, keys, kw, ref,
                    base._replace(wide_v=v, wide_warps=w))
    return out


def poisson_rates(fleet, keys, lam) -> list:
    """K3 on other rates of the same shape: all
    zero (the set-up and the writes alone), one rate of 25 everywhere
    (the game fleet's mean) and the game rates with the rows sorted by
    rate (the spans' order against rows of like rates). Counts are held
    to the plain version's."""
    import torch

    rates = {"zero": torch.zeros_like(lam),
             "lam 25": torch.full_like(lam, 25.0),
             "game, rows sorted by rate": None}
    order = lam.mean(dim=1).argsort()
    out = []
    for name, r in rates.items():
        k0, k1, ch = keys
        if r is None:
            k0, k1, r = k0[order], k1[order], lam[order]
        bad = int((fleet.poisson(k0, k1, ch, r)
                   != fleet.poisson_plain(k0, k1, ch, r)).sum())
        ms = kernel_times(lambda: fleet.poisson(k0, k1, ch, r),
                          "poisson_kernel", reps=10)["ms"]
        out.append({"rates": name, "ms": ms, "mismatches": bad,
                    "ok": bad == 0})
        log(f"[kernel] poisson rates {name}: {ms:.4f} ms "
            f"{'ok' if bad == 0 else f'FAIL {bad} mismatches'}")
    return out


# ---------------------------------------------------------------- phase 3
def _vr_table(name, res_t, res_b) -> bool:
    ok = True
    for k in res_b.outcomes:
        vt = res_t.outcomes[k].violation_rate
        vb = res_b.outcomes[k].violation_rate
        good = math.isfinite(vt) and abs(vt - vb) <= VR_TOL
        ok &= good
        log(f"[paper] {name} {k}: torch VR {vt:.6f} batched VR {vb:.6f} "
            f"|dVR| {abs(vt - vb):.6f} wall {res_t.outcomes[k].wall_s:.3f}s"
            f" {'ok' if good else 'FAIL'}")
    return ok


def phase_paper() -> dict:
    from repro_torch.sim import SCENARIOS, run_scenario

    ok = True
    runs = (("paper_game_32", {"scale_kernel": True}),
            ("paper_face_detection", {}))
    for name, opts in runs:
        sc = SCENARIOS[name]
        res_t = run_scenario(dataclasses.replace(
            sc, engine="torch", backend_options={"device": DEVICE, **opts}))
        res_b = run_scenario(dataclasses.replace(sc, engine="batched"))
        ok &= _vr_table(name, res_t, res_b)
    # a small input: the same engine on the card and on the CPU (plain
    # versions, same bits) must agree to f32 noise
    sc = dataclasses.replace(SCENARIOS["paper_face_detection"],
                             engine="torch")
    on_gpu = run_scenario(dataclasses.replace(
        sc, backend_options={"device": DEVICE}), quick=True)
    on_cpu = run_scenario(dataclasses.replace(
        sc, backend_options={"device": "cpu"}), quick=True)
    for k in on_cpu.outcomes:
        d = abs(on_gpu.outcomes[k].violation_rate
                - on_cpu.outcomes[k].violation_rate)
        good = d <= CPU_GPU_VR_TOL
        ok &= good
        log(f"[paper] quick paper_face_detection {k}: cuda vs cpu |dVR| "
            f"{d:.2e} {'ok' if good else 'FAIL'}")
    return {"ok": ok}


# ---------------------------------------------------------------- phase 4
_FLEET_KERNELS = ("latency_scale_kernel", "row_draw_kernel",
                  "poisson_kernel")


def device_busy(run) -> dict:
    """One profiled run: wall, device time by group, and the share of
    the wall the card sat idle (one stream, so busy times add up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = {"fleet_kernels_ms": 0.0, "memcpy_ms": 0.0, "other_ms": 0.0}
    for e in prof.key_averages():
        ms = getattr(e, "device_time_total", 0.0) / 1e3
        if any(k in e.key for k in _FLEET_KERNELS):
            busy["fleet_kernels_ms"] += ms
        elif "Memcpy" in e.key or "Memset" in e.key:
            busy["memcpy_ms"] += ms
        else:
            busy["other_ms"] += ms
    total = sum(busy.values())
    return {"profiled_wall_s": wall, **busy,
            "idle_share": 1.0 - total / 1e3 / wall}


def phase_mega() -> dict:
    import torch

    from repro_torch.sim import (EdgeFederation, FleetSpec, Scenario,
                                 TenantClassSpec, TopologySpec)

    ok = True
    rows = []
    for kind, n, opts in (("stream", STREAM_TENANTS, {}),
                          ("game", GAME_TENANTS, {"scale_kernel": True})):
        sc = Scenario(name=f"mega_{kind}",
                      fleet=FleetSpec((TenantClassSpec(kind, n),)),
                      topology=TopologySpec(n_nodes=4, headroom=16),
                      duration_s=240, round_interval=120, seed=7)
        row = {"fleet": kind, "tenants": n, "nodes": 4, "duration_s": 240}
        for engine, bopts in (("torch", {"device": DEVICE, **opts}),
                              ("batched", {})):
            s = dataclasses.replace(sc, engine=engine, backend_options=bopts)
            fed = EdgeFederation(s.fleet.build(), s.federation_config("sdps"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fed.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            row[f"{engine}_wall_s"] = wall
            row[f"{engine}_tenant_s_per_s"] = n * 240 / wall
            row[f"{engine}_vr"] = res.violation_rate
        s = dataclasses.replace(sc, engine="torch",
                                backend_options={"device": DEVICE, **opts})
        fed = EdgeFederation(s.fleet.build(), s.federation_config("sdps"))
        row["torch_profile"] = device_busy(fed.run)
        d = abs(row["torch_vr"] - row["batched_vr"])
        good = math.isfinite(row["torch_vr"]) and d <= VR_TOL
        ok &= good
        rows.append(row)
        log(f"[mega] {json.dumps(row)} |dVR| {d:.6f} "
            f"{'ok' if good else 'FAIL'}")
    return {"ok": ok, "rows": rows}


# ---------------------------------------------------------------- phase 5
def _attn_case(att, label, kind, args, kw, dtype, bound, library):
    """One attention kernel case: the kernel against its plain version on
    the same CUDA tensors, and its, the plain version's and one library
    call's device times (:func:`graph_ms`; torch.profiler lost kernel
    records in the later sessions of a long run), with the CUDA-event
    time of one call from the host beside them."""
    import torch

    kernel = att.flash_attention if kind == "flash" else att.paged_attention
    plain = (att.flash_attention_plain if kind == "flash"
             else att.paged_attention_plain)
    got = kernel(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    return dict(case=label, dtype=dtype, max_abs_err=err,
                tolerance=ATTN_TOL[dtype],
                ms=graph_ms(lambda: kernel(*args, **kw)),
                event_ms=cuda_ms(lambda: kernel(*args, **kw)),
                ms_source="cuda graph",
                plain_ms=graph_ms(lambda: plain(*args, **kw), n=5),
                bound_ms=bound[0], bound_by=bound[1],
                library_ms=graph_ms(library),
                ok=err <= ATTN_TOL[dtype])


def attention_cases(seed, H, KH, D, flash_specs, paged_modes, tag="",
                    sweep=()):
    """K4 and K5 against their plain versions at an engine's shapes:
    (B=1, H, KH, D) prefill for each flash spec (Sq, causal, window,
    dtype[, Sk]), and decode for each paged mode (mode, dtype[, B]) of B
    = SERVE_TENANTS · SERVE_REQUESTS sequences (page 16): "identity" — a
    dense (B, 2048, KH, D) cache through the identity page table, lengths
    1,025–1,056 — "random" distinct pages with the same lengths, or
    "edges": random pages and lengths around K5's 128-token rounds (1,
    127–129, its split count's rounds − 1, exactly and + 1, the whole
    table; the first B of them). dtype "mixed" is f32 q with bf16 pools.
    ``tag`` ends every label. ``sweep`` lists split counts at which the
    first paged case is also timed. Returns (flash cases, paged
    cases)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import attention as att

    rng = np.random.default_rng(seed)

    def rand(shape, dtype):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(device=DEVICE, dtype=getattr(torch, dtype))

    flash = []
    for spec in flash_specs:
        S, causal, window, dtype = spec[:4]
        Sk = spec[4] if len(spec) > 4 else S
        q, k, v = (rand(s, dtype) for s in ((1, H, S, D), (1, KH, Sk, D),
                                            (1, KH, Sk, D)))
        if window or Sk != S:
            qp = torch.arange(S, device=DEVICE)[:, None]
            kp = torch.arange(Sk, device=DEVICE)[None, :]
            band = torch.ones((S, Sk), dtype=torch.bool, device=DEVICE)
            if causal:
                band &= kp <= qp
            if window:
                band &= kp > qp - window

            def lib(q=q, k=k, v=v, band=band):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                                      enable_gqa=True)
        else:
            def lib(q=q, k=k, v=v, causal=causal):
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal,
                                                      enable_gqa=True)
        label = (f"S={S}" + (f" Sk={Sk}" if Sk != S else "")
                 + f" {'causal' if causal else 'non-causal'}"
                 + (f" window={window}" if window else "")
                 + (f" H={H} KH={KH} D={D}" if D not in (64, 80) else "")
                 + tag)
        flash.append(_attn_case(
            att, label, "flash", (q, k, v),
            dict(causal=causal, window=window), dtype,
            att.flash_attention_bound_ms(1, H, KH, S, Sk, D, causal=causal,
                                         window=window,
                                         itemsize=q.element_size()), lib))

    paged = []
    for pm in paged_modes:
        mode, dtype = pm[:2]
        B = pm[2] if len(pm) > 2 else SERVE_TENANTS * SERVE_REQUESTS
        page, mp = 16, SERVE_SMAX // 16
        qd, pd = ("float32", "bfloat16") if dtype == "mixed" else (dtype,
                                                                   dtype)
        splits = att.paged_splits(
            B * KH * -(-(H // KH) // att.paged_rows(H // KH)), mp * page,
            torch.cuda.get_device_properties(0).multi_processor_count)
        if mode == "edges":
            # a sequence's splits are whole rounds of min(len, capacity):
            # lengths that end inside, on and just past a round, and that
            # fill all splits, all but one token, or spill into a longer
            # split with the last ones empty
            r, full = att.PAGED_ROUND, att.PAGED_ROUND * splits
            edges = [1, r - 1, r, r + 1, full - 1, full, full + 1, mp * page]
            lengths_np = np.array(edges[:B] if B > 1 else [full + 1],
                                  np.int32)
        else:
            lengths_np = rng.integers(SERVE_PROMPT + 1,
                                      SERVE_PROMPT + SERVE_NEW + 1,
                                      B).astype(np.int32)
        lengths = torch.from_numpy(lengths_np).to(DEVICE)
        valid = (torch.arange(mp * page, device=DEVICE)[None, :]
                 < lengths[:, None])[:, None, None, :]
        q = rand((B, H, D), qd)
        if mode == "identity":
            label = (f"identity view of a dense ({B}, {SERVE_SMAX}, {KH}, "
                     f"{D}) cache")
            kc, vc = (rand((B, SERVE_SMAX, KH, D), pd) for _ in range(2))
            kp, page = att.dense_cache_pages(kc)
            vp, _ = att.dense_cache_pages(vc)
            table = att.identity_page_table(B, SERVE_SMAX, page, DEVICE)
        else:
            label = ("random distinct pages" if mode == "random" else
                     f"random pages, B={B}, lengths "
                     f"{','.join(map(str, lengths_np))} ({splits} splits)")
            P = 4 * B * mp
            kp, vp = (rand((KH, P, page, D), pd) for _ in range(2))
            table = torch.from_numpy(np.stack([
                rng.choice(P, size=mp, replace=False) for _ in range(B)
            ]).astype(np.int32)).to(DEVICE)
            kc = kp[:, table.long()].permute(1, 0, 2, 3, 4).reshape(
                B, KH, mp * page, D).transpose(1, 2)
            vc = vp[:, table.long()].permute(1, 0, 2, 3, 4).reshape(
                B, KH, mp * page, D).transpose(1, 2)
        if D not in (64, 80) or H != 32:
            label += f" H={H} KH={KH} D={D}"

        # SDPA takes one dtype: mixed cases give it f32 copies of the pools
        kl, vl = (x.transpose(1, 2).to(q.dtype) for x in (kc, vc))

        def lib(q=q, kl=kl, vl=vl, valid=valid):
            return F.scaled_dot_product_attention(
                q[:, :, None], kl, vl, attn_mask=valid, enable_gqa=True)
        args = (q, kp, vp, table, lengths)
        case = _attn_case(
            att, label + tag, "paged", args, {},
            "bfloat16" if "bfloat16" in (qd, pd) else "float32",
            att.paged_attention_bound_ms(lengths_np, KH, H, D, mp, page,
                                         itemsize=kp.element_size()), lib)
        case["splits"] = splits
        if dtype == "mixed":
            case["case"] += " (f32 q, bf16 pools)"
        if sweep and not paged:
            code = {"float32": 0, "bfloat16": 1, "mixed": 2}[dtype]
            case["split_sweep_ms"] = {
                n: graph_ms(lambda n=n: att._paged_launch(code, *args, n))
                for n in sweep}
            log(f"[kernel case] paged_attention {label} split sweep (ms): "
                f"{json.dumps(case['split_sweep_ms'])}; the plan: {splits}")
        paged.append(case)
    return flash, paged


def merge_cases(out: dict, name: str, cases: list) -> None:
    """Log each case and fold it into ``out[name]``, the kernel's record:
    the first case a kernel ever gets is its main one, the rest are its
    modes; its error is the largest and its verdict all of theirs."""
    for c in cases:
        lib = ("" if c["library_ms"] is None
               else f", library {c['library_ms']:.4f} ms")
        log(f"[kernel case] {name} {c['case']} {c['dtype']}: max err "
            f"{c['max_abs_err']:.3g} (tol {c['tolerance']}), kernel "
            f"{c['ms']:.4f} ms ({c['ms_source']}; events "
            f"{c['event_ms']:.4f} ms), plain {c['plain_ms']:.4f} ms{lib}, "
            f"bound {c['bound_ms'] * 1e3:.2f} µs ({c['bound_by']}) "
            f"{'ok' if c['ok'] else 'FAIL'}")
    if name not in out:
        main = dict(cases[0])
        main["shape"] = main.pop("case")
        main["modes"] = {}
        out[name] = main
        cases = cases[1:]
    entry = out[name]
    entry["modes"].update({f"{c['case']} {c['dtype']}": c for c in cases})
    entry["max_abs_err"] = max([entry["max_abs_err"]]
                               + [c["max_abs_err"] for c in cases])
    entry["ok"] = entry["ok"] and all(c["ok"] for c in cases)


def serving_kernel_checks(out: dict) -> None:
    """K4 and K5 against their plain versions at tinyllama-1.1b's shapes:
    (B=1, H=32, KH=4, D=64) prefill and (B=8, H=32, KH=4, D=64, page 16)
    decode, with ragged and windowed prefills, the other head dims, K5's
    split edges in all three dtype codes, B = 1 and G = 1, and K5 timed
    at other split counts than its plan."""
    flash, paged = attention_cases(
        21, 32, 4, 64,
        ((SERVE_PROMPT, True, 0, "bfloat16"), (6, True, 0, "bfloat16"),
         (130, True, 0, "bfloat16"), (SERVE_PROMPT, True, 256, "bfloat16"),
         (130, False, 0, "bfloat16"), (130, True, 0, "float32"),
         (1000, True, 0, "bfloat16"), (1000, True, 100, "bfloat16"),
         (130, False, 0, "bfloat16", 1000), (70, True, 0, "bfloat16", 1000),
         (1000, True, 100, "float32")),
        (("identity", "bfloat16"), ("random", "bfloat16"),
         ("random", "float32"), ("edges", "bfloat16"),
         ("edges", "float32"), ("edges", "mixed"), ("edges", "bfloat16", 1)),
        sweep=(1, 2, 3, 5, 9))
    merge_cases(out, "flash_attention", flash)
    merge_cases(out, "paged_attention", paged)
    for D in (16, 32, 128):     # the other head dims K4/K5 are built for
        flash, paged = attention_cases(
            30 + D, 8, 2, D,
            ((1000, True, 0, "bfloat16"), (130, True, 48, "bfloat16")),
            (("edges", "bfloat16"),))
        merge_cases(out, "flash_attention", flash)
        merge_cases(out, "paged_attention", paged)


def _timed(fn, sink: list):
    """``fn`` wrapped to append its synchronized wall (ms) to ``sink``."""
    import torch

    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        sink.append(1e3 * (time.perf_counter() - t0))
        return out
    return run


def launches_per_call(cfg) -> tuple[dict, dict]:
    """The kernel launches one prefill and one decode step of ``cfg``'s
    model make: K4/K5 once per attention layer (the hybrid family's
    shared block once per group), K6 once per RWKV-6 layer, K7 once per
    Mamba-2 layer."""
    L = cfg.num_layers
    if cfg.family == "rwkv6":
        return {"rwkv6": L}, {}
    if cfg.family == "hybrid":
        G = L // cfg.attn_every
        return {"flash_attention": G, "ssd": L}, {"paged_attention": G}
    return {"flash_attention": L}, {"paged_attention": L}


def serving_engine(fleet, archs, kernels) -> tuple:
    """Full-width tenants of ``archs`` (one each) in the multi-tenant
    engine on the card, SERVE_REQUESTS requests of SERVE_PROMPT +
    SERVE_NEW tokens each: every request completes, and each kernel of
    ``kernels`` launches exactly as often as the tenants' prefills and
    decode steps call it (:func:`launches_per_call`). Returns (row,
    engine, tenant names, one prompt per tenant)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import TenantSpec
    from repro_torch.serving import EngineConfig, MultiTenantEngine
    from repro_torch.serving.scheduler import reserved_pages

    cfgs = [get_config(a) for a in archs]
    n = len(archs)
    torch.cuda.reset_peak_memory_stats()
    pages = -(-(SERVE_PROMPT + SERVE_NEW) // 16)
    eng = MultiTenantEngine(EngineConfig(
        page_size=16, slot_cap=8, max_seq_len=SERVE_SMAX, policy="none",
        capacity_slots=n * SERVE_REQUESTS,
        capacity_pages=n * SERVE_REQUESTS * pages,
        default_units=SERVE_REQUESTS), seed=0, device=DEVICE)
    names = [f"tenant{i}" for i in range(n)]
    walls = {}
    for name, cfg in zip(names, cfgs):
        if not eng.add_tenant(TenantSpec(name=name, slo_latency=60.0), cfg):
            raise RuntimeError(f"{name} not admitted")
        rt = eng.tenants[name]
        walls[name] = ([], [])
        rt._prefill = _timed(rt._prefill, walls[name][0])
        rt._decode = _timed(rt._decode, walls[name][1])
    rng = np.random.default_rng(5)
    prompts = {name: [[int(x) for x in rng.integers(1, cfg.vocab_size,
                                                    SERVE_PROMPT)]
                      for _ in range(SERVE_REQUESTS)]
               for name, cfg in zip(names, cfgs)}
    reqs = [eng.submit(name, prompts[name][j], max_new_tokens=SERVE_NEW)
            for name in names for j in range(SERVE_REQUESTS)]
    assert reserved_pages(reqs[0], 16) == pages
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.drain(max_steps=4 * SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = sum(r.phase.value == "done" and len(r.generated) == SERVE_NEW
               for r in reqs)
    tokens = sum(len(r.generated) for r in reqs)
    counts = {k: fleet.LAUNCHES[k] for k in kernels}
    expected = dict.fromkeys(kernels, 0)
    per_tenant = {}
    for name, arch, cfg in zip(names, archs, cfgs):
        pre, dec = walls[name]
        for calls, per in zip((len(pre), len(dec)), launches_per_call(cfg)):
            for k, m in per.items():
                expected[k] += calls * m
        per_tenant[name] = {
            "arch": arch, "layers": cfg.num_layers, "prefills": len(pre),
            "decode_steps": len(dec),
            "prefill_ms_per_request": statistics.median(pre),
            "decode_ms_per_step": statistics.median(dec)}
    ok = done == len(reqs) and counts == expected
    row = {"archs": list(archs), "requests": len(reqs), "completed": done,
           "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW,
           "launches": counts, "expected_launches": expected,
           "tenants": per_tenant, "engine_wall_s": wall,
           "generated_tokens": tokens,
           "generated_tokens_per_s": tokens / wall,
           "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[engine] {json.dumps(row)} {'ok' if ok else 'FAIL'}")
    row["ok"] = ok
    return row, eng, names, [prompts[name][0] for name in names]


def engine_device_time(row, eng, names, prompts) -> dict:
    """Device time of one full-width prefill and of one decode step at
    the engine's batch, per tenant (:func:`graph_ms` over the model's
    own functions, after the run), and from them the share of the
    engine's wall in which the card had nothing to do (the rest is the
    host dispatching the models' torch operations one by one)."""
    import torch

    out = {"tenants": {}}
    busy = 0.0
    B = eng.cfg.slot_cap
    for name, prompt in zip(names, prompts):
        rt = eng.tenants[name]
        tokens = torch.tensor(prompt, dtype=torch.int64, device=DEVICE)[None]
        token = torch.zeros(B, dtype=torch.int64, device=DEVICE)
        pos = torch.full((B,), SERVE_PROMPT, dtype=torch.int64,
                         device=DEVICE)
        pre = graph_ms(lambda: rt.model.prefill_fn(rt.params,
                                                   {"tokens": tokens}), n=1)
        dec = graph_ms(lambda: rt.model.decode_fn(rt.params, rt.cache, token,
                                                  pos), n=1)
        t = row["tenants"][name]
        busy += t["prefills"] * pre + t["decode_steps"] * dec
        out["tenants"][name] = {"arch": t["arch"], "prefill_device_ms": pre,
                                "decode_step_device_ms": dec}
    out["engine_device_busy_s"] = busy / 1e3
    out["idle_share"] = 1.0 - busy / 1e3 / row["engine_wall_s"]
    log(f"[engine] device time {json.dumps(out)}")
    return out


def _cut_logits(rt, keep: int, dtype: str, device: str, tokens):
    """Prefill logits (on the CPU, f32) of the first ``keep`` layers of
    a tenant's full-width weights (for the hybrid family, its shared
    block and the first ``keep / attn_every`` groups), held in
    ``dtype``, through the port on ``device``, and the seconds it took."""
    import torch

    from repro_torch.models import build_model

    cfg = rt.cfg
    groups = keep // cfg.attn_every if cfg.family == "hybrid" else keep
    prefix = "blocks.mamba." if cfg.family == "hybrid" else "layers."
    state = {k: v.to(device) for k, v in rt.params.state_dict().items()
             if not (k.startswith(prefix)
                     and int(k[len(prefix):].split(".")[0]) >= groups)}
    model = build_model(dataclasses.replace(cfg, num_layers=keep,
                                            dtype=dtype),
                        device=device)
    model.params.load_state_dict(state)
    t0 = time.perf_counter()
    logits, _ = model.prefill_fn(model.params, {"tokens": tokens.to(device)})
    if device != "cpu":
        torch.cuda.synchronize()
    s = time.perf_counter() - t0
    if not (bool(torch.isfinite(logits).all())
            and tuple(logits.shape) == (1, cfg.padded_vocab)):
        raise RuntimeError(f"{cfg.name} cut: logits of shape "
                           f"{tuple(logits.shape)} or not finite")
    return logits.float().cpu(), s


def cut_check(rt, prompt, keep: int, dtype: str, tol: float) -> dict:
    """A cut of ``keep`` layers (:func:`_cut_logits`) held in ``dtype``
    on the card and on the CPU: the prefill logits must agree within
    ``tol`` × max |logit|."""
    import torch

    tokens = torch.tensor(prompt[:SERVE_CUT_PROMPT], dtype=torch.int64)[None]
    gpu, _ = _cut_logits(rt, keep, dtype, DEVICE, tokens)
    cpu, cpu_s = _cut_logits(rt, keep, dtype, "cpu", tokens)
    err = float((gpu - cpu).abs().max())
    scale = float(cpu.abs().max())
    out = {"arch": rt.cfg.name, "layers": keep, "dtype": dtype,
           "prompt": SERVE_CUT_PROMPT, "max_abs_logit_err": err,
           "max_abs_logit": scale, "tolerance": tol * scale,
           "cpu_prefill_s": cpu_s, "ok": err <= tol * scale}
    log(f"[cut check] {json.dumps(out)}")
    return out


def served_dtype_cut_check(rt, prompt, keep: int) -> dict:
    """The same cut in the tenant's served dtype (bf16) on the card and
    on the CPU, each against the CPU's f32 logits: the card may stray
    from f32 at most BF16_NOISE_FACTOR times as far as the CPU does."""
    import torch

    tokens = torch.tensor(prompt[:SERVE_CUT_PROMPT], dtype=torch.int64)[None]
    dtype = rt.cfg.dtype
    ref, _ = _cut_logits(rt, keep, "float32", "cpu", tokens)
    gpu, _ = _cut_logits(rt, keep, dtype, DEVICE, tokens)
    cpu, cpu_s = _cut_logits(rt, keep, dtype, "cpu", tokens)
    card_err = float((gpu - ref).abs().max())
    cpu_err = float((cpu - ref).abs().max())
    tol = BF16_NOISE_FACTOR * cpu_err
    out = {"arch": rt.cfg.name, "layers": keep, "dtype": dtype,
           "against": "float32 on the CPU", "prompt": SERVE_CUT_PROMPT,
           "card_max_abs_logit_err": card_err,
           "cpu_max_abs_logit_err": cpu_err,
           "max_abs_logit": float(ref.abs().max()), "tolerance": tol,
           "cpu_prefill_s": cpu_s, "ok": card_err <= tol}
    # how far each kernel's roundings explain the card's distance: the
    # same card run with the kernel's plain version in its place (K4: p
    # in f32; K6/K7: every product in f32); informational
    from repro_torch.kernels import attention as att
    from repro_torch.kernels import rwkv6 as k6
    from repro_torch.kernels import ssd as k7
    from repro_torch.models import mamba2, rwkv6

    swaps = ({"plain_rwkv6": ((rwkv6, "rwkv6_forward",
                               k6.rwkv6_forward_plain),)}
             if rt.cfg.family == "rwkv6" else
             {"plain_flash": ((att, "flash_attention",
                               att.flash_attention_plain),),
              "plain_ssd": ((mamba2, "ssd_forward", k7.ssd_forward_plain),),
              "plain_flash_and_ssd": (
                  (att, "flash_attention", att.flash_attention_plain),
                  (mamba2, "ssd_forward", k7.ssd_forward_plain))})
    for key, swap in swaps.items():
        kept = [getattr(mod, name) for mod, name, _ in swap]
        for mod, name, plain in swap:
            setattr(mod, name, plain)
        try:
            got, _ = _cut_logits(rt, keep, dtype, DEVICE, tokens)
        finally:
            for (mod, name, _), fn in zip(swap, kept):
                setattr(mod, name, fn)
        out[f"card_max_abs_logit_err_{key}"] = float((got - ref).abs().max())
    log(f"[cut check] {json.dumps(out)}")
    return out


def _serving_signature(res) -> dict:
    """Every outcome field the serving federation's tests read, per
    policy (wall-clock overheads excluded)."""
    sig = {}
    for key, r in res.results.items():
        sig[key] = {
            "vr": r.violation_rate, "per_node_vr": r.per_node_vr,
            "accounting": [r.total_requests, r.total_violations,
                           r.submitted, r.completed, r.cloud_requests,
                           r.shed, r.tokens, r.requests_conserved],
            "faults": [r.failed_nodes, r.recovered_nodes, r.replaced,
                       r.cloud],
            "placements": [(p.t, p.tenant, p.node, p.kind, p.source)
                           for p in r.placements],
            "failovers": sum(p.kind == "failover" for p in r.placements),
            "bands": r.token_latency_bands,
            "latencies": {n: nr.latencies.tolist()
                          for n, nr in r.node_results.items()},
        }
    return sig


def serving_scenarios(fleet) -> dict:
    """Both serving scenarios on the card, then on the CPU: every result
    field must match exactly (outcomes depend on the virtual clock and
    token counts alone)."""
    import torch

    from repro_torch.sim import SCENARIOS, run_scenario

    ok = True
    rows = []
    for name in ("serving_edge_pair", "serving_timeout_retry"):
        sc = SCENARIOS[name]
        before = {k: fleet.LAUNCHES[k] for k in SERVING_KERNELS}
        t0 = time.perf_counter()
        on_gpu = run_scenario(dataclasses.replace(
            sc, backend_options={"device": DEVICE}))
        gpu_s = time.perf_counter() - t0
        launched = {k: fleet.LAUNCHES[k] - before[k]
                    for k in SERVING_KERNELS}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)     # tiny tensors: threads only add overhead
        try:
            on_cpu = run_scenario(dataclasses.replace(
                sc, backend_options={"device": "cpu"}))
        finally:
            torch.set_num_threads(threads)
        same = _serving_signature(on_gpu) == _serving_signature(on_cpu)
        good = same and all(n > 0 for n in launched.values())
        ok &= good
        row = {"scenario": name, "cuda_wall_s": gpu_s, "launches": launched,
               "identical_to_cpu": same,
               "vr": {k: o.violation_rate for k, o in on_gpu.outcomes.items()},
               "completed": {k: r.completed
                             for k, r in on_gpu.results.items()}}
        rows.append(row)
        log(f"[serving] scenario {json.dumps(row)} {'ok' if good else 'FAIL'}")
    return {"ok": ok, "rows": rows}


# ---------------------------------------------------------------- phase 6
def kernel_breakdown_us(fn, reps: int = 10) -> dict:
    """Device µs per launch of each CUDA kernel ``fn`` launches, by
    kernel name, from a torch.profiler trace of ``reps`` calls (averaged
    over the launches the trace recorded: late in a long run it loses
    some); empty when the profiler records no device activity."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except (RuntimeError, AssertionError) as e:
        log(f"profiler unavailable ({e})")
        return {}
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0)
        m = re.search(r"(\w+_kernel)", e.key)
        if t and m:
            out[m.group(1)] = t / e.count
    return out


def _recurrent_case(label, dtype, kernel, plain, args, kw, bound, *,
                    long_run: bool, phases: bool = False) -> dict:
    """One K6/K7 case: the kernel against its plain version run in f64
    on the same inputs (the oracle — two f32 sums in other orders can
    differ by more than the tolerance), and the kernel's and the plain
    version's (in the inputs' dtype) device times by graph replay; with
    ``phases``, the device time of each of the call's launches.
    Outputs: the reference's allclose tolerance (2e-2 bf16, 2e-5 f32),
    or over ``long_run``s in f32, 1e-4 × max |o|; final states 1e-3."""
    import torch

    if phases:
        log(f"[phases] {kernel.__name__} {label} {dtype}: µs per launch "
            f"{json.dumps(kernel_breakdown_us(lambda: kernel(*args, **kw)))}")

    got, s = kernel(*args, **kw)
    want, want_s = plain(*(a.double() for a in args),
                         **{k: v.double() if torch.is_tensor(v) else v
                            for k, v in kw.items()})
    torch.cuda.synchronize()
    diff = (got.double() - want).abs()
    if long_run and dtype == "float32":
        rtol, atol = 0.0, 1e-4 * float(want.abs().max())
        tol = f"1e-4 x max|o| = {atol:.3g}"
    else:
        rtol = atol = ATTN_TOL[dtype]
        tol = f"rtol=atol={atol:g}"
    used = float((diff / (atol + rtol * want.abs())).max())
    s_err = float((s.double() - want_s).abs().max())
    s_used = float(((s.double() - want_s).abs()
                    / (1e-3 + 1e-3 * want_s.abs())).max())
    return dict(case=label, dtype=dtype, max_abs_err=float(diff.max()),
                tolerance=tol, allowance_used=used,
                state_max_abs_err=s_err, state_allowance_used=s_used,
                ms=graph_ms(lambda: kernel(*args, **kw)),
                event_ms=cuda_ms(lambda: kernel(*args, **kw)),
                ms_source="cuda graph",
                plain_ms=graph_ms(lambda: plain(*args, **kw), n=1),
                bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                ok=used <= 1.0 and s_used <= 1.0)


def recurrent_kernel_checks(out: dict) -> None:
    """K6 and K7 against their plain versions — at the full-width
    prefill shapes of rwkv6-3b (1, 40, 1024, 64) and zamba2-2.7b
    (1, 80, 1024, 64, N = 64) in the model's strided layouts, at the
    reference's sweep shapes (tests/test_kernels.py), each with and
    without an initial state, and at the edges of the kernels' 64-step
    chunks (T = 1, 63, 65 and 1,000, B = 2, K6's strong decays and decays
    near 1) — and K4/K5 at zamba2's head dim 80. Runs whose state grows
    (1,000 steps and more, decays near 1) are held in f32 at 1e-4 × max
    |o|: there f32 sums round past 2e-5 in any order."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rwkv6 as k6
    from repro_torch.kernels import ssd as k7

    rng = np.random.default_rng(23)

    def rand(shape, dtype=torch.float32):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(device=DEVICE, dtype=dtype)

    both = ("bfloat16", "float32")
    # (shape, dtypes, initial state, the model's layout, decay shift)
    cases = []
    for (B, H, T, K), dtypes, init, layout, decay in (
            ((1, 40, SERVE_PROMPT, 64), both, False, True, None),
            ((1, 40, SERVE_PROMPT, 64), ("bfloat16",), True, True, None),
            ((2, 2, 64, 16), both, False, False, None),
            ((1, 4, 96, 32), both, False, False, None),
            ((2, 1, 50, 16), both, True, False, None),
            ((2, 2, 1, 64), both, True, False, None),
            ((2, 2, 63, 64), both, False, False, None),
            ((2, 2, 65, 32), both, True, False, None),
            ((2, 2, 1000, 64), both, True, True, None),
            ((2, 2, 130, 64), both, True, False, -8.0),
            ((2, 2, 130, 64), both, True, False, 8.0)):
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            # the model's layout: (B, T, H, K) projections seen as
            # (B, H, T, K)
            shape = (B, T, H, K) if layout else (B, H, T, K)
            r, k, v = (rand(shape, dt) for _ in range(3))
            w = torch.sigmoid(rand(shape) if decay is None
                              else decay + 0.1 * rand(shape))
            if layout:
                r, k, v, w = (x.transpose(1, 2) for x in (r, k, v, w))
            kw = {"init_state": rand((B, H, K, K))} if init else {}
            label = (f"({B}, {H}, {T}, {K})" + (" model layout" if layout
                                                 else "")
                     + (" initial state" if init else "")
                     + (f" w = sigmoid({decay:+g})" if decay else ""))
            cases.append(_recurrent_case(
                label, dtype, k6.rwkv6_forward, k6.rwkv6_forward_plain,
                (r, k, v, w, rand((H, K))), kw,
                k6.rwkv6_bound_ms(B, H, T, K, itemsize=r.element_size(),
                                  init_state=init),
                long_run=T >= 1000 or (decay or 0) > 0,
                phases=T == SERVE_PROMPT))
    merge_cases(out, "rwkv6", cases)

    cases = []
    for (B, H, T, P, N, chunk), dtypes, init, layout in (
            ((1, 80, SERVE_PROMPT, 64, 64, 128), both, False, True),
            ((1, 80, SERVE_PROMPT, 64, 64, 128), ("bfloat16",), True, True),
            ((2, 2, 128, 16, 16, 32), both, False, False),
            ((1, 4, 64, 32, 32, 64), both, False, False),
            ((2, 1, 96, 16, 8, 32), both, True, False),
            ((2, 2, 1, 16, 16, 128), both, True, True),
            ((2, 2, 63, 32, 16, 128), both, False, True),
            ((2, 2, 65, 16, 32, 128), both, True, True),
            ((2, 2, 1000, 64, 64, 200), both, True, True)):
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            a_log = rand((H,)) * 0.5
            dtv = F.softplus(rand((B, T, H))).transpose(1, 2)
            if layout:
                # the model's conv output: x, B and C are column slices
                xbc = rand((B, T, H * P + 2 * N), dt)
                x = xbc[..., :H * P].reshape(B, T, H, P).transpose(1, 2)
                Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
            else:       # the sweep: B/C in f32 beside x
                x = rand((B, H, T, P), dt)
                Bm, Cm = rand((B, T, N)), rand((B, T, N))
            kw = {"chunk": chunk}
            if init:
                kw["init_state"] = rand((B, H, P, N))
            label = (f"({B}, {H}, {T}, {P}) N={N}" + (" model layout"
                                                       if layout else "")
                     + (" initial state" if init else ""))
            cases.append(_recurrent_case(
                label, dtype, k7.ssd_forward, k7.ssd_forward_plain,
                (x, dtv, a_log, Bm, Cm), kw,
                k7.ssd_bound_ms(B, H, T, P, N, itemsize=x.element_size(),
                                bc_itemsize=Bm.element_size(),
                                init_state=init), long_run=T >= 1000,
                phases=T == SERVE_PROMPT))
    merge_cases(out, "ssd", cases)

    # zamba2-2.7b's shared attention: 32 heads of 80, no grouping
    flash, paged = attention_cases(
        22, 32, 32, 80,
        ((SERVE_PROMPT, True, 0, "bfloat16"),
         (SERVE_PROMPT, True, 0, "float32"), (1000, True, 100, "bfloat16")),
        (("identity", "bfloat16"), ("identity", "float32"),
         ("edges", "bfloat16"), ("edges", "mixed")), tag=" D=80",
        sweep=(1, 2, 3))
    merge_cases(out, "flash_attention", flash)
    merge_cases(out, "paged_attention", paged)


# ------------------------------------------------------------------- main
def _path_launches(path: str, counts: dict, launches: dict,
                   extra: str = "") -> list:
    """Record a path's launch counts (set to 0 just before its run, read
    just after) under ``launches[kernel][path]`` and return the
    failures: each kernel of the path must have launched."""
    log(f"[launches] {path} path: {json.dumps(counts)}{extra}")
    for k, n in counts.items():
        launches.setdefault(k, {})[path] = n
    return [f"kernel {k} never launched on the {path} path"
            for k, n in counts.items() if n == 0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import fleet
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 2

    failures = []
    if "env" in phases:
        failures += phase_env(fleet)["failures"]
    else:
        fleet.build()
    kern = phase_kernels(fleet) if "kernels" in phases else {}
    failures += [f"kernel {k}" for k, r in kern.items() if not r["ok"]]

    # each path: counts set to 0 just before it, read just after
    launches, row_draw_modes = {}, {}
    if "paper" in phases or "mega" in phases:
        fleet.reset_launches()
        if "paper" in phases and not phase_paper()["ok"]:
            failures.append("paper scenarios")
        if "mega" in phases and not phase_mega()["ok"]:
            failures.append("mega-scale federations")
        torch.cuda.synchronize()
        row_draw_modes.update(fleet.ROW_DRAW_MODES)
        failures += _path_launches(
            "simulator", {k: fleet.LAUNCHES[k] for k in FLEET_KERNELS},
            launches, f"; row_draw by mode {json.dumps(row_draw_modes)}, "
            f"by mode and rows x cols {json.dumps(fleet.ROW_DRAW_SHAPES)}")
    if "serving" in phases:
        serving_kernel_checks(kern)
        failures += [f"kernel {k}" for k in SERVING_KERNELS
                     if not kern[k]["ok"]]
        fleet.reset_launches()
        row, eng, names, prompts = serving_engine(
            fleet, (SERVE_ARCH,) * SERVE_TENANTS, SERVING_KERNELS)
        if not row["ok"]:
            failures.append("full-width serving engine")
        failures += _path_launches("serving", row["launches"], launches)
        rt = eng.tenants[names[0]]
        if not cut_check(rt, prompts[0], SERVE_CUT_LAYERS, rt.cfg.dtype,
                         LOGIT_TOL)["ok"]:
            failures.append("serving cut check")
        if not serving_scenarios(fleet)["ok"]:
            failures.append("serving scenarios on the card")
        engine_device_time(row, eng, names, prompts)
        del eng, rt
        gc.collect()    # the engine's controller refers back to it
    if "recurrent" in phases:
        recurrent_kernel_checks(kern)
        failures += [f"kernel {k}" for k in RECURRENT_KERNELS + SERVING_KERNELS
                     if not kern[k]["ok"]]
        fleet.reset_launches()
        row, eng, names, prompts = serving_engine(fleet, REC_ARCHS,
                                                  REC_PATH_KERNELS)
        if not row["ok"]:
            failures.append("full-width recurrent serving engine")
        failures += _path_launches("recurrent", row["launches"], launches)
        for name, prompt in zip(names, prompts):
            rt = eng.tenants[name]
            keep = (rt.cfg.attn_every if rt.cfg.family == "hybrid"
                    else REC_CUT_LAYERS)
            if not cut_check(rt, prompt, keep, "float32",
                             REC_F32_TOL)["ok"]:
                failures.append(f"{rt.cfg.name} f32 cut check")
            if not served_dtype_cut_check(rt, prompt, keep)["ok"]:
                failures.append(f"{rt.cfg.name} {rt.cfg.dtype} cut check")
        engine_device_time(row, eng, names, prompts)

    record = []
    sources = {name: f"src/repro_torch/csrc/{name}.cu" for name in
               FLEET_KERNELS + SERVING_KERNELS + RECURRENT_KERNELS}
    replaces = {
        "latency_scale": "src/repro/sim/engines/jax_backend.py:151",
        "row_draw": "src/repro/sim/engines/jax_backend.py:124",
        "poisson": "src/repro/sim/engines/jax_backend.py:145",
        "flash_attention": "src/repro/kernels/flash_attention.py:29",
        "paged_attention": "src/repro/kernels/paged_attention.py:34",
        "rwkv6": "src/repro/kernels/rwkv6.py:25",
        "ssd": "src/repro/kernels/ssd.py:23"}
    # a kernel's ``launches`` is the count on the path of the slice that
    # ported it, where that path ran; ``launches_by_path`` has each path
    home = dict.fromkeys(FLEET_KERNELS, "simulator")
    home.update(dict.fromkeys(SERVING_KERNELS, "serving"))
    home.update(dict.fromkeys(RECURRENT_KERNELS, "recurrent"))
    for name, r in kern.items():
        by_path = launches.get(name, {})
        entry = {"name": name, "route": "cuda", "source": sources[name],
                 "replaces": replaces[name],
                 "launches": by_path.get(home[name],
                                         next(iter(by_path.values()), 0)),
                 "launches_by_path": by_path,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "event_ms": r["event_ms"], "ms_source": r["ms_source"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        entry.update({k: r[k] for k in ("splits", "split_sweep_ms")
                      if k in r})
        if name == "row_draw" and row_draw_modes:
            entry["launches_by_mode"] = row_draw_modes
        if "modes" in r:
            entry["modes"] = {m: {k: v[k] for k in (
                "max_abs_err", "ms", "event_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "splits", "split_sweep_ms")
                if k in v} for m, v in r["modes"].items()}
        record.append(entry)
    if failures:
        print("chip_smoke FAILED: " + "; ".join(dict.fromkeys(failures)),
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": record}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
