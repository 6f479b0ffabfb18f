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
  the CPU on cuts of the same weights;
* the MoE, encoder-decoder and vision-stub families (phase
  ``families``): K4/K5 at their shapes against their plain versions,
  full-width olmoe-1b-7b and whisper-small tenants in the engine on the
  card, llava-next-34b at its published widths (4 of 60 layers)
  prefilled from embeddings then decoded, their prefill logits against
  the CPU on cuts of the same weights, and a mixed engine of the
  reduced models whose outcomes on the card equal the CPU's;
* the campaign harness (phase ``campaign``): the cells of
  ``TORCH_GRID`` (the torch engine against batched) and the ci
  campaign's serving cells inline on the card (their launches are the
  ``campaign`` path's) and on the CPU, K4 and K5 against their plain
  versions on copies of the inputs that inline run gave them (the
  reduced tinyllama-1.1b's shapes), then the full ci campaign, full
  mode, fanned out over CAMPAIGN_WORKERS child processes from this
  process, which holds a CUDA context by then: every cell ok, no gate
  failure, the serving cells' records equal to the CPU's;
* training (phase ``train``): full-width tinyllama-1.1b trained
  TRAIN_STEPS steps (seq 1,024, global batch 8 in 2 microbatches, remat
  "selective", AdamW on f32 masters) through ``make_train_step``, with
  no kernel launched (the training route is plain: K4-K7 are
  forward-only), the step's wall, device time, tokens/s, FLOP share
  and peak memory, and where its time goes; a resume from an async
  checkpoint equal to the uninterrupted run; the restored weights
  served in bf16 through K4 and K5 (the ``handoff`` path, its calls
  held against the plain versions) with prefill logits close to the
  training route's; the reduced families' loss and gradients on the
  card against the CPU in f32; and the kernels' refusal of inputs that
  require grad;
* the examples (phase ``examples``): the port's five examples through
  their entry points — quickstart for all ten architectures (K4-K7 on
  the ``examples.quickstart`` path, held against their plain versions
  on the inputs that path gave them), multitenant_serve on a virtual
  clock equal to its CPU run line for line (K4, K5, K6),
  federation_demo on the torch engine within VR_TOL of batched (K2,
  K3), elastic_restart's resume equal, and train_100m at its full size
  cut only in steps (its step time, tokens/s, FLOP share and peak
  memory; no kernel);
* the sharding layer (phase ``mesh``): a one-rank NCCL group, the
  launcher on ``make_host_mesh()`` equal bit for bit to the run with no
  group, MoE ``tp`` under the (1, 1) mesh against the local function,
  ``compressed_allreduce`` against its plain composition; the group
  destroyed;
* the dry-run (phase ``dryrun``): three cells at full width accounted
  on the fake 256-rank (16, 16) mesh on the host (nothing allocated on
  the card, no group left), the one-rank account of the train phase's
  step against that step run on the card (FLOPs and peak memory), and
  the torch engine's row sharding on one card equal to ``shard=False``.

Each path's launch counts are reset just before it and read just after.
At the end the campaign's fork server is stopped and no process this
run started may still be there. Needs one CUDA card; exits non-zero on
any failure.

    python3 chip_smoke.py                 # everything
    python3 chip_smoke.py --phases env,kernels
    python3 chip_smoke.py --phases env,serving
    python3 chip_smoke.py --phases env,recurrent
    python3 chip_smoke.py --phases env,families
    python3 chip_smoke.py --phases env,campaign
    python3 chip_smoke.py --phases env,train
    python3 chip_smoke.py --phases env,examples,mesh
    python3 chip_smoke.py --phases env,dryrun

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
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("env", "kernels", "paper", "mega", "serving", "recurrent",
          "families", "campaign", "train", "examples", "mesh", "dryrun")
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
# families: one full-width olmoe-1b-7b (MoE, 64 experts, top-8) and one
# whisper-small tenant (encoder-decoder, fed zero frames as the engine
# feeds them) in the engine, the same requests; llava-next-34b at its
# published widths with its depth cut to FAM_VISION_LAYERS of 60 (all
# 60, ≈ 69 GB of bf16, would leave the card no room), prefilled from
# seeded embeddings of SERVE_PROMPT rows, then SERVE_NEW decode steps
# at 8 slots. The CPU-vs-card cuts keep FAM_CUT_LAYERS layers (whisper:
# of each stack), in f32 within REC_F32_TOL and in bf16 within
# LOGIT_TOL × max |logit|; olmoe's on a FAM_MOE_CUT_PROMPT-token prompt,
# since its CPU prefill runs every expert over every row (C = T)
FAM_ARCHS = ("olmoe-1b-7b", "whisper-small")
FAM_VISION_ARCH = "llava-next-34b"
FAM_VISION_LAYERS = 4
FAM_VISION_SLOTS = 8
FAM_CUT_LAYERS = 2
FAM_MOE_CUT_PROMPT = 128
# campaign: the ci gate campaign in full mode, as the port's campaign
# CLI runs it by default (two workers)
CAMPAIGN = "ci"
CAMPAIGN_WORKERS = 2
# training: full-width tinyllama-1.1b at seq 1,024, global batch 8 in 2
# microbatches, remat "selective" (the config's), TRAIN_STEPS steps of
# AdamW at a learning rate the Markov source is learned at; the resume
# check trains RESUME_STEPS uninterrupted against half of them, an async
# checkpoint, a restore into a fresh state and the other half (total
# losses within RESUME_RTOL); the card's loss and gradients against the
# CPU's on the reduced families in f32 (within GRAD_TOL norm-relative a
# leaf); the restored weights served in bf16 through K4/K5 (prefill
# logits within LOGIT_TOL × max |logit| of the plain training route)
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_SEQ = 1024
TRAIN_BATCH = 8
TRAIN_MICROBATCHES = 2
TRAIN_STEPS = 10
TRAIN_TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)
TRAIN_MIN_DROP = 0.3
RESUME_STEPS = 6
RESUME_RTOL = 1e-6
TRAIN_CPU_ARCHS = ("tinyllama-1.1b", "olmoe-1b-7b", "rwkv6-3b",
                   "zamba2-2.7b", "whisper-small", "llava-next-34b")
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
#: H100 SXM dense bf16 tensor-core peak (NVIDIA's data sheet, 700 W)
BF16_PEAK_FLOPS = 989e12
# examples: the port's five examples through their entry points on the
# card — quickstart for every arch (QS_STEPS training steps, then prefill
# and 5 greedy decode steps through K4-K7), multitenant_serve on a
# virtual clock (its printout equal to the CPU's), federation_demo on
# the torch engine (|dVR| within VR_TOL of batched), elastic_restart
# (resume equal), train_100m at its full size cut only in steps
# (T100M_STEPS, a checkpoint at 50 and the last, then a resume to
# T100M_RESUME_STEPS)
QS_STEPS = 3
SERVE_TICK_S = 0.25
T100M_STEPS = 60
T100M_RESUME_STEPS = 70
T100M_MIN_DROP = 1.0
# mesh: a one-rank NCCL group on the card; the launcher on the host mesh
# (MESH_STEPS steps) against the run with no group, bit for bit; MoE tp
# under a (1, 1) mesh within MOE_TP_TOL of local (f32)
MESH_STEPS = 3
MOE_TP_TOL = 1e-5
# dryrun: three cells at full width on the fake (16, 16) mesh (the
# hillclimb's: granite at 12 layers), host-only; the one-rank account of
# the train phase's step against that step run on the card (FLOPs
# within DRY_FLOP_RTOL, peak memory within DRY_PEAK_RTOL); the torch
# engine's row sharding on one card against shard=False
DRY_CELLS = (("tinyllama-1.1b", "train_4k", {}),
             ("olmoe-1b-7b", "train_4k", {}),
             ("granite-8b", "decode_32k", {"num_layers": 12}))
DRY_FLOP_RTOL = 0.01
DRY_PEAK_RTOL = 0.25
DRY_SHARD_SCENARIO = "paper_game_32"
ALL_KERNELS = FLEET_KERNELS + SERVING_KERNELS + ("rwkv6", "ssd")


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
    1,025–1,056 — "cross", an encoder-decoder's cross cache: a dense (B,
    512, KH, D) one with every slot attended — "random" distinct pages
    with the identity mode's lengths, or
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
        smax = SERVE_SMAX // 4 if mode == "cross" else SERVE_SMAX
        page, mp = 16, smax // 16
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
        elif mode == "cross":
            lengths_np = np.full(B, smax, np.int32)
        else:
            lengths_np = rng.integers(SERVE_PROMPT + 1,
                                      SERVE_PROMPT + SERVE_NEW + 1,
                                      B).astype(np.int32)
        lengths = torch.from_numpy(lengths_np).to(DEVICE)
        valid = (torch.arange(mp * page, device=DEVICE)[None, :]
                 < lengths[:, None])[:, None, None, :]
        q = rand((B, H, D), qd)
        if mode in ("identity", "cross"):
            label = (f"identity view of a dense ({B}, {smax}, {KH}, {D}) "
                     f"{'cross ' if mode == 'cross' else ''}cache")
            kc, vc = (rand((B, smax, KH, D), pd) for _ in range(2))
            kp, page = att.dense_cache_pages(kc)
            vp, _ = att.dense_cache_pages(vc)
            table = att.identity_page_table(B, smax, page, DEVICE)
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
    shared block once per group; the encoder-decoder's encoder layers
    K4 once, its decoder layers K4 and K5 twice: self and cross
    attention), K6 once per RWKV-6 layer, K7 once per Mamba-2 layer."""
    L = cfg.num_layers
    if cfg.family == "encdec":
        return ({"flash_attention": cfg.num_encoder_layers + 2 * L},
                {"paged_attention": 2 * L})
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
        # a whole decode step, eager, captured or replayed (a capture
        # admits no synchronisation inside the model's decode)
        rt.forward = _timed(rt.forward, walls[name][1])
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
        # the tenant's own time: the walls of its prefills and steps
        own_s = (sum(pre) + sum(dec)) / 1e3
        made = sum(len(r.generated) for r in reqs if r.req.tenant == name)
        per_tenant[name] = {
            "arch": arch, "layers": cfg.num_layers, "prefills": len(pre),
            "decode_steps": len(dec),
            "prefill_ms_per_request": statistics.median(pre),
            "decode_ms_per_step": statistics.median(dec),
            "own_wall_s": own_s, "generated_tokens": made,
            "tokens_per_s_of_own_wall": made / own_s}
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
    engine's wall, and of each tenant's own wall, in which the card had
    nothing to do (the rest is the host dispatching the models' torch
    operations one by one)."""
    import torch

    from repro_torch.serving.engine import prefill_batch

    out = {"tenants": {}}
    busy = 0.0
    B = eng.cfg.slot_cap
    for name, prompt in zip(names, prompts):
        rt = eng.tenants[name]
        batch = prefill_batch(rt.cfg, torch.tensor(
            prompt, dtype=torch.int64, device=DEVICE)[None])
        token = torch.zeros(B, dtype=torch.int64, device=DEVICE)
        pos = torch.full((B,), SERVE_PROMPT, dtype=torch.int64,
                         device=DEVICE)
        pre = graph_ms(lambda: rt.model.prefill_fn(rt.params, batch), n=1)
        dec = graph_ms(lambda: rt.model.decode_fn(rt.params, rt.cache, token,
                                                  pos), n=1)
        t = row["tenants"][name]
        own = t["prefills"] * pre + t["decode_steps"] * dec
        busy += own
        out["tenants"][name] = {
            "arch": t["arch"], "prefill_device_ms": pre,
            "decode_step_device_ms": dec,
            "idle_share_of_own_wall": 1.0 - own / 1e3 / t["own_wall_s"]}
    out["engine_device_busy_s"] = busy / 1e3
    out["idle_share"] = 1.0 - busy / 1e3 / row["engine_wall_s"]
    log(f"[engine] device time {json.dumps(out)}")
    return out


def _cut_batch(cfg, prompt, n: int) -> dict:
    """A cut check's prefill batch on the CPU: the first ``n`` tokens of
    ``prompt``, or for the vision stub ``n`` rows of seeded normal
    embeddings; an encoder-decoder also gets seeded normal frames
    (n // encoder_seq_ratio rows)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(9)

    def normal(rows):
        return torch.from_numpy(rng.standard_normal(
            (1, rows, cfg.d_model)).astype(np.float32))
    batch = ({"embeds": normal(n)} if cfg.frontend == "vision" else
             {"tokens": torch.tensor(prompt[:n], dtype=torch.int64)[None]})
    if cfg.is_encoder_decoder:
        batch["frames"] = normal(max(n // cfg.encoder_seq_ratio, 1))
    return batch


def _cut_logits(rt, keep: int, dtype: str, device: str, batch):
    """Prefill logits (on the CPU, f32) of the first ``keep`` layers of
    a model's full-width weights (``rt``: a tenant runtime or a model;
    for the hybrid family, its shared block and the first ``keep /
    attn_every`` groups; for the encoder-decoder, ``keep`` layers of
    each stack), held in ``dtype``, through the port on ``device``, and
    the seconds the prefill took. The cut is built on the card, where
    drawing its initial weights is quick, and moved."""
    import torch

    from repro_torch.models import build_model

    cfg = rt.cfg
    cut = ({"blocks.mamba.": keep // cfg.attn_every}
           if cfg.family == "hybrid" else {"layers.": keep})
    shape = {"num_layers": keep}
    if cfg.family == "encdec":
        cut["enc_layers."] = keep
        shape["num_encoder_layers"] = keep
    state = {k: v for k, v in rt.params.state_dict().items()
             if not any(k.startswith(p)
                        and int(k[len(p):].split(".")[0]) >= n
                        for p, n in cut.items())}
    model = build_model(dataclasses.replace(cfg, dtype=dtype, **shape),
                        device=DEVICE)
    model.params.load_state_dict(state)
    params = model.params.to(device)
    batch = {k: v.to(device) for k, v in batch.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model.prefill_fn(params, batch)
    if device != "cpu":
        torch.cuda.synchronize()
    s = time.perf_counter() - t0
    if not (bool(torch.isfinite(logits).all())
            and tuple(logits.shape) == (1, cfg.padded_vocab)):
        raise RuntimeError(f"{cfg.name} cut: logits of shape "
                           f"{tuple(logits.shape)} or not finite")
    return logits.float().cpu(), s


def cut_check(rt, prompt, keep: int, dtype: str, tol: float,
              n: int = SERVE_CUT_PROMPT) -> dict:
    """A cut of ``keep`` layers (:func:`_cut_logits`) held in ``dtype``
    on the card and on the CPU, prefilled from ``n`` positions
    (:func:`_cut_batch`): the logits must agree within ``tol`` × max
    |logit|."""
    batch = _cut_batch(rt.cfg, prompt, n)
    gpu, _ = _cut_logits(rt, keep, dtype, DEVICE, batch)
    cpu, cpu_s = _cut_logits(rt, keep, dtype, "cpu", batch)
    err = float((gpu - cpu).abs().max())
    scale = float(cpu.abs().max())
    out = {"arch": rt.cfg.name, "layers": keep, "dtype": dtype,
           "prompt": n, "max_abs_logit_err": err,
           "max_abs_logit": scale, "tolerance": tol * scale,
           "cpu_prefill_s": cpu_s, "ok": err <= tol * scale}
    log(f"[cut check] {json.dumps(out)}")
    return out


def served_dtype_cut_check(rt, prompt, keep: int) -> dict:
    """The same cut in the tenant's served dtype (bf16) on the card and
    on the CPU, each against the CPU's f32 logits: the card may stray
    from f32 at most BF16_NOISE_FACTOR times as far as the CPU does."""
    batch = _cut_batch(rt.cfg, prompt, SERVE_CUT_PROMPT)
    dtype = rt.cfg.dtype
    ref, _ = _cut_logits(rt, keep, "float32", "cpu", batch)
    gpu, _ = _cut_logits(rt, keep, dtype, DEVICE, batch)
    cpu, cpu_s = _cut_logits(rt, keep, dtype, "cpu", batch)
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
            got, _ = _cut_logits(rt, keep, dtype, DEVICE, batch)
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


# ---------------------------------------------------------------- phase 7
def family_kernel_checks(out: dict) -> None:
    """K4 and K5 against their plain versions at the new families'
    shapes: whisper-small's (12 heads of 64, no grouping) — its cross
    attention (SERVE_PROMPT queries over SERVE_PROMPT / 4 keys,
    non-causal, bf16 and f32), its encoder (SERVE_PROMPT / 4 frames,
    non-causal), its decoder's self attention, and decode over every
    slot of the cross cache (bf16 and f32) and over the self cache —
    and at head dim 128 with olmoe-1b-7b's 16 heads (G = 1) and
    llava-next-34b's 56 over 8 (G = 7): causal prefill in bf16 and f32
    and decode at full serving length."""
    Se = SERVE_PROMPT // 4
    flash, paged = attention_cases(
        24, 12, 12, 64,
        ((SERVE_PROMPT, False, 0, "bfloat16", Se),
         (SERVE_PROMPT, False, 0, "float32", Se),
         (Se, False, 0, "bfloat16"), (SERVE_PROMPT, True, 0, "bfloat16")),
        (("cross", "bfloat16"), ("cross", "float32"),
         ("identity", "bfloat16")), tag=" whisper")
    merge_cases(out, "flash_attention", flash)
    merge_cases(out, "paged_attention", paged)
    for seed, H, KH, tag in ((25, 16, 16, " olmoe"), (26, 56, 8, " llava")):
        flash, paged = attention_cases(
            seed, H, KH, 128,
            ((SERVE_PROMPT, True, 0, "bfloat16"),
             (SERVE_PROMPT, True, 0, "float32")),
            (("identity", "bfloat16"),), tag=tag)
        merge_cases(out, "flash_attention", flash)
        merge_cases(out, "paged_attention", paged)


def vision_run(fleet) -> tuple:
    """llava-next-34b at its published widths, FAM_VISION_LAYERS of its
    60 layers, random weights from seed 0, on the card: a prefill from
    SERVE_PROMPT rows of seeded normal embeddings, its cache copied into
    FAM_VISION_SLOTS slots of SERVE_SMAX positions, then SERVE_NEW greedy
    decode steps from tokens at every slot. The prefill must launch K4
    once a layer and each step K5 once a layer, and every logit must be
    finite. Returns (row, model, the decode step's inputs)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(FAM_VISION_ARCH),
                              num_layers=FAM_VISION_LAYERS)
    model = build_model(cfg, device=DEVICE)
    embeds = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, SERVE_PROMPT, cfg.d_model)).astype(np.float32)).to(DEVICE)
    before = {k: fleet.LAUNCHES[k] for k in SERVING_KERNELS}
    pre, dec = [], []
    prefill, decode = _timed(model.prefill_fn, pre), _timed(model.decode_fn,
                                                            dec)
    B, L = FAM_VISION_SLOTS, cfg.num_layers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, one = prefill(model.params, {"embeds": embeds})
    cache = {k: torch.zeros(spec.shape, dtype=spec.dtype, device=DEVICE)
             for k, spec in model.cache_specs(B, SERVE_SMAX).items()}
    for k in cache:                      # the same request in every slot
        cache[k][:, :, :SERVE_PROMPT] = one[k]
    finite = [torch.isfinite(logits).all()]
    token = logits.argmax(-1).expand(B).contiguous()
    for step in range(SERVE_NEW):
        pos = torch.full((B,), SERVE_PROMPT + step, dtype=torch.int64,
                         device=DEVICE)
        logits, cache = decode(model.params, cache, token, pos)
        finite.append(torch.isfinite(logits).all())
        token = logits.argmax(-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: fleet.LAUNCHES[k] - before[k] for k in SERVING_KERNELS}
    expected = {"flash_attention": L, "paged_attention": SERVE_NEW * L}
    ok = (launched == expected and bool(torch.stack(finite).all())
          and tuple(logits.shape) == (B, cfg.padded_vocab))
    row = {"arch": cfg.name, "layers": f"{L} of 60", "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
           "prompt_embeds": SERVE_PROMPT, "slots": B, "decode_steps":
           SERVE_NEW, "launches": launched, "expected_launches": expected,
           "prefill_ms": pre[0], "decode_ms_per_step": statistics.median(dec),
           "wall_s": wall, "decode_tokens": B * SERVE_NEW,
           "decode_tokens_per_s": B * SERVE_NEW / wall,
           "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[vision] {json.dumps(row)} {'ok' if ok else 'FAIL'}")
    row["ok"] = ok
    return row, model, (embeds, cache, token, pos)


def vision_device_time(row, model, inputs) -> dict:
    """Device time of the vision run's prefill and of one decode step
    (:func:`graph_ms`), and the share of its wall the card sat idle."""
    embeds, cache, token, pos = inputs
    pre = graph_ms(lambda: model.prefill_fn(model.params,
                                            {"embeds": embeds}), n=1)
    dec = graph_ms(lambda: model.decode_fn(model.params, cache, token, pos),
                   n=1)
    busy = pre + row["decode_steps"] * dec
    out = {"arch": row["arch"], "prefill_device_ms": pre,
           "decode_step_device_ms": dec, "device_busy_s": busy / 1e3,
           "idle_share": 1.0 - busy / 1e3 / row["wall_s"]}
    log(f"[vision] device time {json.dumps(out)}")
    return out


def moe_prefill_share(rt, prompt, prefill_device_ms: float) -> dict:
    """How much of a full-width MoE prefill's device time its FFNs take:
    one layer's ``moe_ffn`` and its three expert products alone on the
    layer's (1, SERVE_PROMPT, D) input (:func:`graph_ms`), times the
    layers, against the whole prefill's device time. Below 4,096 tokens
    the buffer is dropless (C = T), so the products run every expert
    over every row: E / k times the routed work."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.layers import apply_norm, embed

    cfg, p = rt.cfg, rt.params.layers[0]
    T, D, F = SERVE_PROMPT, cfg.d_model, cfg.d_ff
    E, k = cfg.num_experts, cfg.experts_per_token
    x = apply_norm(p.ln2, embed(rt.params.tok, torch.tensor(
        prompt, dtype=torch.int64, device=DEVICE)[None], cfg), cfg)
    h = torch.randn((E, moe.capacity(cfg, T), D), device=DEVICE,
                    dtype=x.dtype)
    ffn = graph_ms(lambda: moe.moe_ffn(p.moe, x, cfg), n=1)
    prod = graph_ms(lambda: moe.expert_glu(p.moe, h, cfg), n=1)
    L = cfg.num_layers
    out = {"arch": cfg.name, "tokens": T, "capacity": moe.capacity(cfg, T),
           "moe_ffn_ms_per_layer": ffn, "expert_products_ms_per_layer": prod,
           "prefill_device_ms": prefill_device_ms,
           "moe_ffn_share": L * ffn / prefill_device_ms,
           "expert_products_share": L * prod / prefill_device_ms,
           "dropless_tflop": L * 6 * E * T * D * F / 1e12,
           "routed_tflop": L * 6 * k * T * D * F / 1e12}
    log(f"[moe] prefill share {json.dumps(out)}")
    return out


def mixed_engine_outcomes(device: str) -> list:
    """Reduced olmoe-1b-7b and whisper-small tenants in one engine on
    ``device`` on a virtual clock, two requests each, the MoE tenant
    preempted after 3 steps and resumed 3 steps later: each request's
    tenant, generated count, first-token and finish times and phase
    (they depend on the clock and token counts alone)."""
    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.core import Quota, TenantSpec
    from repro_torch.serving import (EngineConfig, MultiTenantEngine,
                                     VirtualClock)

    clock = VirtualClock(0.25)
    eng = MultiTenantEngine(EngineConfig(
        policy="none", slot_cap=2, capacity_slots=4, capacity_pages=64,
        max_seq_len=64, round_interval_steps=10**9), seed=5, clock=clock,
        device=device)
    names = ("moe", "asr")
    for name, arch in zip(names, FAM_ARCHS):
        if not eng.add_tenant(TenantSpec(name=name, slo_latency=60.0),
                              get_reduced(arch)):
            raise RuntimeError(f"{name} not admitted")
    rng = np.random.default_rng(4)
    reqs = [eng.submit(name, [int(x) for x in rng.integers(1, 200, 6 + i)],
                       max_new_tokens=8) for i in range(2) for name in names]
    for step in range(200):
        if step in (3, 6):
            eng.ctrl.actuator.apply_quota(
                "moe", Quota(slots=0 if step == 3 else 2, pages=64))
        if all(r.phase.value == "done" for r in reqs):
            break
        clock.tick()
        eng.step()
    return [(r.req.tenant, len(r.generated), r.first_token_t, r.finish_t,
             r.phase.value) for r in reqs]


def mixed_engine_check() -> dict:
    """:func:`mixed_engine_outcomes` on the card and on the CPU must be
    equal, and every request must complete."""
    import torch

    on_gpu = mixed_engine_outcomes(DEVICE)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # tiny tensors: threads only add overhead
    try:
        on_cpu = mixed_engine_outcomes("cpu")
    finally:
        torch.set_num_threads(threads)
    ok = on_gpu == on_cpu and all(o[1] == 8 and o[4] == "done"
                                  for o in on_gpu)
    out = {"archs": list(FAM_ARCHS), "outcomes": on_gpu,
           "identical_to_cpu": on_gpu == on_cpu, "ok": ok}
    log(f"[families] mixed engine {json.dumps(out)} "
        f"{'ok' if ok else 'FAIL'}")
    return out


# ---------------------------------------------------------------- phase 8
def _cells_by_id(records) -> dict:
    return {r["cell"]: r for r in records}


def _capture_attention(seen: dict):
    """Wrap K4's and K5's wrappers in ``repro_torch.kernels.attention``
    (the models call them through that module) so that ``seen`` keeps
    copies of the inputs of the first call of each kernel at each shape,
    layout, dtype and mask, and for K5 also of the call over the most
    tokens; every call still runs the kernel. Returns the function that
    puts the wrappers back."""
    import torch

    from repro_torch.kernels import attention as att

    orig = {"flash": att.flash_attention, "paged": att.paged_attention}

    def wrap(kind):
        def run(*args, **kw):
            if torch.cuda.is_current_stream_capturing():
                # a decode step captured as a graph: its inputs hold no
                # values yet (the tenant's eager first step was kept)
                return orig[kind](*args, **kw)
            key = (kind, tuple((tuple(a.shape), a.stride(), a.dtype)
                               for a in args), tuple(sorted(kw.items())))
            calls = seen.setdefault(key, [])
            tokens = int(args[4].sum()) if kind == "paged" else 0
            if not calls or tokens > max(t for t, _, _ in calls):
                del calls[1:]       # the first call stays
                calls.append((tokens, tuple(a.clone() for a in args),
                              dict(kw)))
            return orig[kind](*args, **kw)
        return run

    att.flash_attention, att.paged_attention = wrap("flash"), wrap("paged")

    def restore():
        att.flash_attention = orig["flash"]
        att.paged_attention = orig["paged"]
    return restore


def path_attention_checks(out: dict, seen: dict,
                          path: str = "campaign") -> list:
    """K4 and K5 against their plain versions on the inputs a path gave
    them (``seen``, from :func:`_capture_attention`): each captured call
    in its own dtype and in the other one (bf16 <-> f32), within
    ATTN_TOL, timed beside its bound and one SDPA call as in
    :func:`attention_cases`. The cases join ``out``'s kernel records;
    returns the failures."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import attention as att

    cases = {"flash": [], "paged": []}
    captured = [(kind, args, kw) for (kind, _, _), calls in seen.items()
                for _, args, kw in calls]
    for kind, args, kw in captured:
        own = args[0].dtype
        for dt in (own, torch.float32 if own == torch.bfloat16
                   else torch.bfloat16):
            dtype = str(dt).removeprefix("torch.")
            if kind == "flash":
                q, k, v = (a.to(dt) for a in args)
                B, H, S, D = q.shape
                KH, Sk = k.shape[1], k.shape[2]
                causal, window = kw.get("causal", True), kw.get("window", 0)
                qp = torch.arange(S, device=DEVICE)[:, None]
                kp = torch.arange(Sk, device=DEVICE)[None, :]
                band = torch.ones((S, Sk), dtype=torch.bool, device=DEVICE)
                if causal:
                    band &= kp <= qp
                if window:
                    band &= kp > qp - window

                def lib(q=q, k=k, v=v, band=band):
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=band, enable_gqa=True)
                label = (f"{path} path B={B} S={S}"
                         + (f" Sk={Sk}" if Sk != S else "")
                         + f" {'causal' if causal else 'non-causal'}"
                         + (f" window={window}" if window else "")
                         + f" H={H} KH={KH} D={D}")
                bound = att.flash_attention_bound_ms(
                    B, H, KH, S, Sk, D, causal=causal, window=window,
                    itemsize=q.element_size())
                call = (q, k, v)
            else:
                q, kpool, vpool = (a.to(dt) for a in args[:3])
                table, lengths = args[3:]
                B, H, D = q.shape
                KH, _, page, _ = kpool.shape
                mp = table.shape[1]
                kl, vl = (pool[:, table.long()].permute(1, 0, 2, 3, 4)
                          .reshape(B, KH, mp * page, D)
                          for pool in (kpool, vpool))
                valid = (torch.arange(mp * page, device=DEVICE)[None, :]
                         < lengths[:, None])[:, None, None, :]

                def lib(q=q, kl=kl, vl=vl, valid=valid):
                    return F.scaled_dot_product_attention(
                        q[:, :, None], kl, vl, attn_mask=valid,
                        enable_gqa=True)
                label = (f"{path} path B={B} pages {mp}x{page} lengths "
                         f"{','.join(map(str, lengths.tolist()))} "
                         f"H={H} KH={KH} D={D}")
                bound = att.paged_attention_bound_ms(
                    lengths.cpu(), KH, H, D, mp, page,
                    itemsize=kpool.element_size())
                call = (q, kpool, vpool, table, lengths)
            cases[kind].append(_attn_case(att, label, kind, call, kw, dtype,
                                          bound, lib))
    failures = []
    for kind, name in (("flash", "flash_attention"),
                       ("paged", "paged_attention")):
        if not cases[kind]:
            failures.append(f"{path} path: no {name} call captured")
            continue
        merge_cases(out, name, cases[kind])
        failures += [f"kernel {name} on the {path} path's {c['case']} "
                     f"{c['dtype']}" for c in cases[kind] if not c["ok"]]
    return failures


def phase_campaign(fleet, launches: dict, kern: dict) -> list:
    """The campaign path. Inline on the card: the cells of TORCH_GRID
    and the ci campaign's serving cells, with the launch counts set to 0
    just before and read just after; K4 and K5 against their plain
    versions on copies of the inputs that run gave them (their records
    in ``kern`` gain these cases); the same cells inline on the CPU,
    the torch cells within CPU_GPU_VR_TOL and the serving cells' records
    (volatile fields stripped) equal. Then the full ci campaign on the
    card with CAMPAIGN_WORKERS children, started from this process,
    which holds a CUDA context: every cell must end ok with no gate
    failure and no consistency violation, the serving cells' records
    equal to the CPU's and the torch cells within CPU_GPU_VR_TOL of the
    inline run. Returns the failures."""
    import torch

    from repro_torch.campaign import (build_report, expand_campaign,
                                      expand_grid, get_campaign, on_device,
                                      run_cells)
    from repro_torch.campaign.registry import TORCH_GRID
    from repro_torch.campaign.report import strip_volatile

    t_phase = time.perf_counter()
    failures = []
    spec = get_campaign(CAMPAIGN)
    cells, masked, filtered = expand_campaign(spec, verbose=True)
    path = expand_grid(TORCH_GRID)[0] + [c for c in cells
                                         if c.engine == "serving"]
    seen = {}
    restore = _capture_attention(seen)
    try:
        fleet.reset_launches()
        on_gpu = run_cells(on_device(path, DEVICE), workers=0)
        torch.cuda.synchronize()
    finally:
        restore()
    if not torch.cuda.is_initialized():
        failures.append("campaign: the parent holds no CUDA context")
    failures += _path_launches("campaign", {
        k: fleet.LAUNCHES[k] for k in ("row_draw",) + SERVING_KERNELS},
        launches)
    failures += path_attention_checks(kern, seen)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # tiny tensors: threads only add overhead
    try:
        on_cpu = run_cells(on_device(path, "cpu"), workers=0)
    finally:
        torch.set_num_threads(threads)
    for g, c in zip(on_gpu, on_cpu):
        if g["status"] != "ok" or c["status"] != "ok":
            good = False
            what = f"{g['status']} / {c['status']} {g.get('error', '')}"
        elif g["engine"] == "serving":
            good = strip_volatile(g) == strip_volatile(c)
            what = f"VR {g['violation_rate']:.6f} records equal: {good}"
        else:
            d = abs(g["violation_rate"] - c["violation_rate"])
            good = d <= CPU_GPU_VR_TOL
            what = (f"VR cuda {g['violation_rate']:.6f} cpu "
                    f"{c['violation_rate']:.6f} |dVR| {d:.2e}")
        log(f"[campaign] inline {g['cell']}: {what} "
            f"{'ok' if good else 'FAIL'}")
        if not good:
            failures.append(f"campaign cell {g['cell']} cuda vs cpu")

    t0 = time.perf_counter()
    records = run_cells(on_device(cells, DEVICE), workers=CAMPAIGN_WORKERS,
                        cell_timeout_s=spec.cell_timeout_s)
    wall = time.perf_counter() - t0
    report = build_report(spec.name, records, quick=False, masked=masked,
                          filtered=filtered, campaign_wall_s=wall,
                          workers=CAMPAIGN_WORKERS)
    inline_gpu, inline_cpu = _cells_by_id(on_gpu), _cells_by_id(on_cpu)
    fanned = _cells_by_id(records)
    for cell in path:
        r = fanned[cell.cell_id]
        if r["status"] != "ok":
            continue                        # a gate failure below
        if cell.engine == "serving":
            good = strip_volatile(r) == strip_volatile(
                inline_cpu[cell.cell_id])
        else:
            good = abs(r["violation_rate"] - inline_gpu[cell.cell_id][
                "violation_rate"]) <= CPU_GPU_VR_TOL
        if not good:
            failures.append(f"campaign cell {cell.cell_id}: fanned out on "
                            f"the card, not as inline")
    gate = report.gate_failures()
    failures += [f"campaign gate: {f}" for f in gate]
    consistency = report.consistency_violations()
    engines = sorted({r["engine"] for r in records})
    row = {"campaign": spec.name, "quick": False, "cells": len(records),
           "ok": len(report.ok), "engines": engines,
           "workers": CAMPAIGN_WORKERS, "campaign_wall_s": wall,
           "parent_cuda_initialized": torch.cuda.is_initialized(),
           "gate_failures": len(gate),
           "consistency_violations": len(consistency),
           "cell_walls_s": {r["cell"]: r.get("wall_s") for r in records
                            if r["engine"] in ("torch", "serving")},
           "phase_s": time.perf_counter() - t_phase}
    log(f"[campaign] {json.dumps(row)} "
        f"{'ok' if not failures else 'FAIL'}")
    for f in gate:
        log(f"[campaign] gate: {f}")
    return failures


# ---------------------------------------------------------------- training
def _train_setup(cfg, steps: int):
    """The trainable model of ``cfg`` on the card, the train step at
    TRAIN_TC with TRAIN_MICROBATCHES, and ``steps`` batches of the
    port's synthetic pipeline (TRAIN_SEQ × TRAIN_BATCH), made before any
    timing and moved to the card."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import make_pipeline, to_device
    from repro_torch.models import build_model
    from repro_torch.training.train_step import make_train_step

    model = build_model(cfg, device=DEVICE, trainable=True)
    tc = TrainConfig(microbatches=TRAIN_MICROBATCHES, **TRAIN_TC)
    pipe = make_pipeline(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                          "train"), seed=0)
    t0 = time.perf_counter()
    batches = [to_device(pipe.batch(i), DEVICE) for i in range(steps)]
    log(f"[train] {steps} batches of {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
        f"made in {time.perf_counter() - t0:.2f} s (CPU) and moved")
    return model, make_train_step(model, tc), batches


def model_flops_per_token(cfg, params, seq: int = TRAIN_SEQ) -> float:
    """Training FLOPs a token: 6·N for the N weights of ``params`` that
    multiply (every weight but an untied input embedding table, which is
    a lookup) plus the attention scores and their product with V,
    6·L·H·hd·S over the causal half of S = ``seq`` keys (forward
    2·2·H·hd·S/2, backward twice that). Recomputation is not counted."""
    n = sum(p.numel() for p in params.parameters())
    if not cfg.tie_embeddings:
        n -= params.tok.embed.numel()
    return 6 * n + 6 * cfg.num_layers * cfg.q_dim * seq


#: substrings of the names of cuBLAS's and CUTLASS's matrix-product kernels
GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet")


def profile_step(step_fn, state, batch, top: int = 12,
                 tag: str = "train") -> dict:
    """One more train step under torch.profiler (it updates ``state``,
    which the caller then drops): the device time of the step's
    kernels, of the matrix products among them and of the ``top``
    kernels by time, with their counts (logged under ``tag``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step_fn(state, batch)
            torch.cuda.synchronize()
    except (RuntimeError, AssertionError) as e:
        log(f"[{tag}] profile: profiler unavailable ({e})")
        return {}
    ks = [(e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count)
          for e in prof.key_averages()]
    ks = sorted((k for k in ks if k[1] > 0), key=lambda k: -k[1])
    gemms = [k for k in ks if any(g in k[0].lower() for g in GEMM_NAMES)]
    out = {"kernels_ms": sum(k[1] for k in ks),
           "gemm_ms": sum(k[1] for k in gemms),
           # cuBLAS names its f32 products by their operand types
           "gemm_f32_ms": sum(k[1] for k in gemms if "f32f32" in k[0]),
           "launches": sum(k[2] for k in ks),
           "top": [{"name": k[0][:90], "ms": k[1], "count": k[2]}
                   for k in ks[:top]]}
    log(f"[{tag}] profile {json.dumps(out)}")
    return out


def train_full_width(fleet, launches: dict) -> tuple[list, dict, object]:
    """TRAIN_STEPS steps of full-width TRAIN_ARCH through
    ``make_train_step``, the launch counts set to 0 just before and read
    just after (every kernel must stay at 0: the training route is
    plain); per step the loss, lr and grad norm, the wall (host clock
    around the step and a read of its loss) and the device time (CUDA
    events around it); the peak memory. Returns (failures, row, cfg)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.training.train_step import init_train_state

    cfg = get_config(TRAIN_ARCH)
    model, step_fn, batches = _train_setup(cfg, TRAIN_STEPS)
    state = init_train_state(model, params=model.params)
    n_params = sum(p.numel() for p in model.params.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fleet.reset_launches()
    steps = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, m = step_fn(state, batch)
        end.record()
        m = {k: float(v) for k, v in m.items()}
        wall = 1e3 * (time.perf_counter() - t0)
        end.synchronize()
        steps.append(dict(step=i, **m, wall_ms=wall,
                          device_ms=start.elapsed_time(end)))
        log(f"[train] step {i} loss {m['loss']:.4f} total "
            f"{m['total_loss']:.4f} lr {m['lr']:.3e} grad_norm "
            f"{m['grad_norm']:.4f} wall {wall:.1f} ms device "
            f"{steps[-1]['device_ms']:.1f} ms")
    torch.cuda.synchronize()
    counts = dict(fleet.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for k in ALL_KERNELS:
        launches.setdefault(k, {})["train"] = counts[k]
    log(f"[launches] train path: {json.dumps(counts)}")
    failures = [f"train step launched kernel {k} {n} times"
                for k, n in counts.items() if n]
    profile_step(step_fn, state, batches[-1])
    steady = steps[1:]
    wall = statistics.median(s["wall_ms"] for s in steady)
    dev = statistics.median(s["device_ms"] for s in steady)
    flops = model_flops_per_token(cfg, state.params) * tokens
    losses = [s["loss"] for s in steps]
    row = {"arch": cfg.name, "params": n_params, "seq": TRAIN_SEQ,
           "global_batch": TRAIN_BATCH, "microbatches": TRAIN_MICROBATCHES,
           "remat": cfg.remat, "steps": len(steps), "first_loss": losses[0],
           "last_loss": losses[-1], "step_wall_ms": wall,
           "step_device_ms": dev, "first_step_wall_ms": steps[0]["wall_ms"],
           "tokens_per_s": tokens / (wall / 1e3),
           "model_flops_per_step": flops,
           "bf16_peak_share": flops / (wall / 1e3) / BF16_PEAK_FLOPS,
           "max_memory_allocated_gb": peak / 1e9, "card": smi_line()}
    log(f"[train] {json.dumps(row)}")
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"train: a loss is not finite: {losses}")
    if not losses[-1] <= losses[0] - TRAIN_MIN_DROP:
        failures.append(f"train: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                        f"less than {TRAIN_MIN_DROP} down")
    del state, model, batches
    gc.collect()
    torch.cuda.empty_cache()
    return failures, row, cfg


def train_breakdown(cfg, row: dict) -> dict:
    """Where a full-width step's time goes, each piece timed alone with
    CUDA events at the step's shapes (a microbatch: TRAIN_BATCH /
    TRAIN_MICROBATCHES rows of TRAIN_SEQ) and scaled by how often a step
    runs it: the plain f32 chunked attention (forward, and forward plus
    backward: under remat a layer's forward runs twice, L × microbatches
    times), the f32 → bf16 casts of every weight (forward, recompute,
    and the backward's cast of each gradient back, per microbatch), the
    final norm, logits and cross entropy with their backward (per
    microbatch) and the AdamW update (once). The rest of the step's
    device time is the products and the other elementwise work."""
    import torch

    from repro_torch.models.attention import chunked_attention
    from repro_torch.models.layers import apply_norm, cross_entropy, unembed
    from repro_torch.training.optimizer import adamw_update, init_opt_state
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build_model

    B, S, L = TRAIN_BATCH // TRAIN_MICROBATCHES, TRAIN_SEQ, cfg.num_layers
    n_mb = TRAIN_MICROBATCHES
    gen = torch.Generator(device=DEVICE).manual_seed(3)

    def rand(*shape, dtype=torch.bfloat16, grad=True):
        return torch.randn(shape, generator=gen, device=DEVICE).to(
            dtype).requires_grad_(grad)
    q = rand(B, S, cfg.num_heads, cfg.head_dim)
    k = rand(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = rand(B, S, cfg.num_kv_heads, cfg.head_dim)
    go = rand(B, S, cfg.num_heads, cfg.head_dim, grad=False)

    def attn_fwd():
        with torch.no_grad():
            chunked_attention(q, k, v, chunk=cfg.attn_chunk)

    def attn_fwd_bwd():
        o = chunked_attention(q, k, v, chunk=cfg.attn_chunk)
        torch.autograd.grad(o, (q, k, v), go)
    model = build_model(cfg, device=DEVICE, trainable=True)
    weights = list(model.params.parameters())

    def casts():
        for w in weights:
            w.detach().to(torch.bfloat16)
    x = rand(B, S, cfg.d_model)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=DEVICE)

    def logits_loss():
        lg = unembed(model.params.tok, apply_norm(model.params.ln_f, x, cfg),
                     cfg)
        loss, _ = cross_entropy(lg, labels)
        torch.autograd.grad(loss, (x,))
    named = dict(model.params.named_parameters())
    grads = {n: torch.randn_like(t) * 1e-3 for n, t in named.items()}
    opt = init_opt_state(named)
    tc = TrainConfig(**TRAIN_TC)

    def adamw():
        adamw_update(named, grads, opt, tc)
    out = {"attention_fwd_ms": cuda_ms(attn_fwd, reps=5),
           "attention_fwd_bwd_ms": cuda_ms(attn_fwd_bwd, reps=5),
           "weight_casts_ms": cuda_ms(casts, reps=5),
           "logits_loss_fwd_bwd_ms": cuda_ms(logits_loss, reps=5),
           "adamw_ms": cuda_ms(adamw, reps=3)}
    per_step = {
        "attention": L * n_mb * (out["attention_fwd_ms"]
                                 + out["attention_fwd_bwd_ms"]),
        "weight_casts": 3 * n_mb * out["weight_casts_ms"],
        "logits_loss": n_mb * out["logits_loss_fwd_bwd_ms"],
        "adamw": out["adamw_ms"]}
    per_step["rest"] = row["step_device_ms"] - sum(per_step.values())
    out["per_step_ms"] = per_step
    out["share_of_step"] = {k: v / row["step_device_ms"]
                            for k, v in per_step.items()}
    log(f"[train] breakdown {json.dumps(out)}")
    del model, weights, named, grads, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_resume(cfg, ckpt_dir: Path) -> tuple[list, object, object]:
    """RESUME_STEPS uninterrupted steps against half of them, an async
    checkpoint, a restore into a fresh state (other weights) and the
    other half, under deterministic algorithms: the last total losses
    within RESUME_RTOL. Returns (failures, the model, the restored and
    trained state)."""
    import torch

    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.train_step import init_train_state

    failures = []
    half = RESUME_STEPS // 2
    torch.use_deterministic_algorithms(True)
    try:
        model, step_fn, batches = _train_setup(cfg, RESUME_STEPS)
        state = init_train_state(model, seed=0)
        for batch in batches:
            state, m = step_fn(state, batch)
        uninterrupted = float(m["total_loss"])
        del state
        state = init_train_state(model, seed=0)
        for batch in batches[:half]:
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        writer = ckpt.save(str(ckpt_dir), half, state, async_=True)
        host_s = time.perf_counter() - t0
        del state
        fresh = init_train_state(model, seed=1)
        writer.join()
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        start, state = ckpt.restore(str(ckpt_dir), fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for batch in batches[start:]:
            state, m = step_fn(state, batch)
        resumed = float(m["total_loss"])
    finally:
        torch.use_deterministic_algorithms(False)
    size = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
    d = abs(resumed - uninterrupted) / abs(uninterrupted)
    ok = start == half and d <= RESUME_RTOL
    log(f"[train] resume: uninterrupted total_loss {uninterrupted:.7f}, "
        f"resumed from step {start} {resumed:.7f} (rel diff {d:.2e}, tol "
        f"{RESUME_RTOL}); checkpoint {size / 1e9:.2f} GB: host copy "
        f"{host_s:.2f} s, written {write_s:.2f} s after save, restored in "
        f"{restore_s:.2f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("train: resumed run differs from the uninterrupted "
                        "one")
    del batches, step_fn, fresh
    gc.collect()
    return failures, model, state


def train_card_vs_cpu(fleet) -> list:
    """Each reduced family in f32: the same weights (drawn on the CPU,
    carried to the card with ``params_to_jax`` / ``params_from_jax``)
    and the port's own batch, loss and every gradient leaf on the card
    against the CPU; no kernel may launch."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import make_pipeline, to_device
    from repro_torch.models import build_model, params_from_jax, params_to_jax
    from repro_torch.training.train_step import make_loss_and_grad

    failures = []
    for arch in TRAIN_CPU_ARCHS:
        cfg = get_reduced(arch, dtype="float32")
        batch = make_pipeline(cfg, ShapeConfig("t", 32, 4, "train"),
                              seed=0).batch(0)
        out = {}
        for dev in ("cpu", DEVICE):
            model = build_model(cfg, device=dev, trainable=True)
            if dev == "cpu":
                tree = params_to_jax(model.params)
                params = model.params
            else:
                params = params_from_jax(cfg, tree, device=dev,
                                         trainable=True)
            fleet.reset_launches()
            loss, _, grads = make_loss_and_grad(model, TrainConfig())(
                params, to_device(batch, dev))
            torch.cuda.synchronize()
            out[dev] = (float(loss), {k: g.cpu().double()
                                      for k, g in grads.items()})
            if dev != "cpu" and any(fleet.LAUNCHES.values()):
                failures.append(f"train: {arch} gradients launched "
                                f"{fleet.LAUNCHES}")
        (lc, gc_), (lg, gg) = out["cpu"], out[DEVICE]
        errs = {k: float((gg[k] - g).norm() / g.norm().clamp(min=1e-30))
                for k, g in gc_.items()}
        worst = max(errs, key=errs.get)
        dl = abs(lg - lc) / abs(lc)
        ok = dl <= LOSS_RTOL and errs[worst] <= GRAD_TOL
        log(f"[train] card vs cpu {arch} f32: loss {lc:.6f} / {lg:.6f} "
            f"(rel {dl:.2e}), worst gradient leaf {worst} {errs[worst]:.2e} "
            f"of {len(errs)} (tol {GRAD_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"train: {arch} card vs cpu")
    return failures


def train_guard(fleet) -> list:
    """K4, K5, K6 and K7 each given a CUDA input that requires grad must
    raise, and launch nothing."""
    import torch

    from repro_torch.kernels import attention as att
    from repro_torch.kernels.rwkv6 import rwkv6_forward
    from repro_torch.kernels.ssd import ssd_forward

    def g(*shape, dtype=torch.bfloat16, grad=False):
        return torch.randn(shape, device=DEVICE).to(dtype).requires_grad_(
            grad)
    table = torch.arange(4, dtype=torch.int32, device=DEVICE).reshape(1, 4)
    calls = {
        "flash_attention": lambda: att.flash_attention(
            g(1, 4, 64, 64, grad=True), g(1, 4, 64, 64), g(1, 4, 64, 64)),
        "paged_attention": lambda: att.paged_attention(
            g(1, 4, 64), g(4, 4, 16, 64, grad=True), g(4, 4, 16, 64), table,
            torch.full((1,), 60, dtype=torch.int32, device=DEVICE)),
        "rwkv6": lambda: rwkv6_forward(
            g(1, 2, 64, 64, grad=True), g(1, 2, 64, 64), g(1, 2, 64, 64),
            torch.rand((1, 2, 64, 64), device=DEVICE),
            g(2, 64, dtype=torch.float32)),
        "ssd": lambda: ssd_forward(
            g(1, 2, 64, 16, grad=True),
            torch.rand((1, 2, 64), device=DEVICE),
            g(2, dtype=torch.float32), g(1, 64, 16), g(1, 64, 16)),
    }
    failures = []
    for name, call in calls.items():
        fleet.reset_launches()
        try:
            call()
            why = "no error"
        except RuntimeError as e:
            why = str(e) if "forward-only" not in str(e) else None
        torch.cuda.synchronize()
        ok = why is None and not any(fleet.LAUNCHES.values())
        log(f"[train] guard {name}: an input that requires grad "
            f"{'raises' if why is None else 'gave ' + why}"
            f"{'' if ok else ' FAIL'}")
        if not ok:
            failures.append(f"train: {name} guard")
    return failures


def train_handoff(fleet, launches: dict, kern: dict, model,
                  state) -> list:
    """The restored, trained weights as serving weights (``params_to_jax``
    then ``params_from_jax`` in bf16), a SERVE_PROMPT-token prefill and
    SERVE_NEW greedy decode steps through K4 and K5 (the ``handoff``
    path's launch counts, set to 0 just before and read just after);
    the prefill's last logits against the training route's logits
    (``logits_fn`` on the f32 masters, plain attention) at that
    position; K4 and K5 against their plain versions on copies of the
    inputs this path gave them."""
    import torch

    from repro_torch.models import params_from_jax, params_to_jax
    from repro_torch.models.kvcache import grow_cache

    cfg = model.cfg
    t0 = time.perf_counter()
    served = params_from_jax(cfg, params_to_jax(state.params), device=DEVICE)
    log(f"[train] handoff: trained weights to serving bf16 in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, min(cfg.vocab_size, 4096), (1, SERVE_PROMPT),
                           generator=gen).to(DEVICE)
    seen = {}
    restore = _capture_attention(seen)
    try:
        fleet.reset_launches()
        logits, cache = model.prefill_fn(served, {"tokens": tokens})
        cache = grow_cache(cfg, cache, SERVE_PROMPT + SERVE_NEW + 1)
        prefill_logits = logits.float()
        token = logits.argmax(-1)
        pos = torch.full((1,), SERVE_PROMPT, dtype=torch.int64,
                         device=DEVICE)
        finite = bool(torch.isfinite(logits).all())
        for _ in range(SERVE_NEW):
            logits, cache = model.decode_fn(served, cache, token, pos)
            finite &= bool(torch.isfinite(logits).all())
            token, pos = logits.argmax(-1), pos + 1
        torch.cuda.synchronize()
    finally:
        restore()
    failures = _path_launches("handoff", {
        k: fleet.LAUNCHES[k] for k in SERVING_KERNELS}, launches)
    with torch.enable_grad():
        plain = model.logits_fn(state.params, {"tokens": tokens})[:, -1]
    plain = plain.detach().float()
    err = float((prefill_logits - plain).abs().max())
    scale = float(plain.abs().max())
    ok = finite and err <= LOGIT_TOL * scale
    log(f"[train] handoff: prefill {SERVE_PROMPT} + {SERVE_NEW} decode "
        f"steps on K4/K5, logits finite {finite}; last prefill logits vs "
        f"the training route: max err {err:.4g} of max |logit| "
        f"{scale:.4g} (tol {LOGIT_TOL} x) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("train: handoff logits")
    failures += path_attention_checks(kern, seen, path="handoff")
    return failures


def phase_train(fleet, launches: dict, kern: dict) -> list:
    """The training path (see the constants above TRAIN_ARCH). Returns
    the failures."""
    import torch

    t0 = time.perf_counter()
    failures, row, cfg = train_full_width(fleet, launches)
    train_breakdown(cfg, row)
    ckpt_dir = ROOT / "build" / "train_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        f, model, state = train_resume(cfg, ckpt_dir)
        failures += f
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    failures += train_handoff(fleet, launches, kern, model, state)
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    failures += train_card_vs_cpu(fleet)
    failures += train_guard(fleet)
    log(f"[train] phase {time.perf_counter() - t0:.1f} s "
        f"{'ok' if not failures else 'FAIL: ' + '; '.join(failures)}")
    return failures


# ---------------------------------------------------------------- examples
def _capture_recurrent(seen: dict):
    """Wrap K6's and K7's wrappers where the models call them
    (``repro_torch.models.rwkv6`` and ``.mamba2``) so that ``seen`` keeps
    copies of the inputs of the first call at each shape, layout, dtype
    and state; every call still runs the kernel. Returns the function
    that puts the wrappers back."""
    import torch

    import repro_torch.models.mamba2 as m7
    import repro_torch.models.rwkv6 as m6

    orig = {"rwkv6": m6.rwkv6_forward, "ssd": m7.ssd_forward}

    def wrap(kind):
        def run(*args, **kw):
            kw = {k: v for k, v in kw.items() if v is not None}
            key = (kind, tuple((tuple(a.shape), a.stride(), a.dtype)
                               for a in args),
                   tuple(sorted((k, tuple(v.shape) if torch.is_tensor(v)
                                 else v) for k, v in kw.items())))
            if key not in seen:
                seen[key] = (tuple(a.clone() for a in args),
                             {k: v.clone() if torch.is_tensor(v) else v
                              for k, v in kw.items()})
            return orig[kind](*args, **kw)
        return run

    m6.rwkv6_forward, m7.ssd_forward = wrap("rwkv6"), wrap("ssd")

    def restore():
        m6.rwkv6_forward, m7.ssd_forward = orig["rwkv6"], orig["ssd"]
    return restore


def path_recurrent_checks(out: dict, seen: dict, path: str,
                          kinds=("rwkv6", "ssd")) -> list:
    """K6 and K7 against their plain versions (in f64) on the inputs a
    path gave them (``seen``, from :func:`_capture_recurrent`), as
    :func:`_recurrent_case` holds them, timed beside their bounds; the
    cases join ``out``'s kernel records. Each kernel of ``kinds`` must
    have been captured. Returns the failures."""
    from repro_torch.kernels import rwkv6 as k6
    from repro_torch.kernels import ssd as k7

    cases = {"rwkv6": [], "ssd": []}
    for (kind, _, _), (args, kw) in seen.items():
        dtype = str(args[0].dtype).removeprefix("torch.")
        init = "init_state" in kw
        if kind == "rwkv6":
            B, H, T, K = args[0].shape
            label = f"{path} path ({B}, {H}, {T}, {K})"
            bound = k6.rwkv6_bound_ms(B, H, T, K,
                                      itemsize=args[0].element_size(),
                                      init_state=init)
            kernel, plain = k6.rwkv6_forward, k6.rwkv6_forward_plain
        else:
            B, H, T, P = args[0].shape
            N = args[3].shape[-1]
            label = f"{path} path ({B}, {H}, {T}, {P}) N={N}"
            bound = k7.ssd_bound_ms(B, H, T, P, N,
                                    itemsize=args[0].element_size(),
                                    bc_itemsize=args[3].element_size(),
                                    init_state=init)
            kernel, plain = k7.ssd_forward, k7.ssd_forward_plain
        cases[kind].append(_recurrent_case(
            label + (" initial state" if init else ""), dtype, kernel,
            plain, args, kw, bound, long_run=False))
    failures = []
    for name, found in cases.items():
        if not found:
            if name in kinds:
                failures.append(f"{path} path: no {name} call captured")
            continue
        merge_cases(out, name, found)
        failures += [f"kernel {name} on the {path} path's {c['case']} "
                     f"{c['dtype']}" for c in found if not c["ok"]]
    return failures


def _quiet(fn, *args, **kw):
    """``fn``'s result and what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def examples_quickstart(fleet, launches: dict, kern: dict) -> list:
    """``python -m repro_torch.examples.quickstart --arch A --steps
    QS_STEPS`` for every arch on the card: finite losses and a greedy
    continuation of 6 token ids (none for the vision stub); K4-K7 on the
    ``examples.quickstart`` path, held against their plain versions on
    the inputs it gave them."""
    import torch

    from repro_torch.configs import ARCH_IDS, get_reduced
    from repro_torch.examples import quickstart

    failures = []
    seen_att, seen_rec = {}, {}
    restores = [_capture_attention(seen_att), _capture_recurrent(seen_rec)]
    try:
        fleet.reset_launches()
        for arch in ARCH_IDS:
            t0 = time.perf_counter()
            r, _ = _quiet(quickstart.main,
                          ["--arch", arch, "--steps", str(QS_STEPS)])
            cont, vocab = r["continuation"], get_reduced(arch).vocab_size
            ok = (all(math.isfinite(x) for x in r["loss"])
                  and (cont is None if get_reduced(arch).frontend == "vision"
                       else len(cont) == 6
                       and all(0 <= c < vocab for c in cont)))
            log(f"[examples] quickstart {arch}: losses "
                f"{[round(x, 4) for x in r['loss']]}, continuation {cont}, "
                f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"examples: quickstart {arch}")
            del r
        torch.cuda.synchronize()
    finally:
        for restore in restores:
            restore()
    failures += _path_launches("examples.quickstart", {
        k: fleet.LAUNCHES[k] for k in SERVING_KERNELS + RECURRENT_KERNELS},
        launches)
    failures += path_attention_checks(kern, seen_att,
                                      path="examples.quickstart")
    failures += path_recurrent_checks(kern, seen_rec, "examples.quickstart")
    return failures


def _ticking_engine(device: str):
    """The serving engine on a virtual clock that advances SERVE_TICK_S
    before each engine step (the example's engine reads the wall clock,
    which no two runs share)."""
    from repro_torch.serving import MultiTenantEngine, VirtualClock

    class Ticking(MultiTenantEngine):
        def __init__(self, cfg, **kw):
            self.vclock = VirtualClock(SERVE_TICK_S)
            super().__init__(cfg, clock=self.vclock, **kw)

        def step(self):
            self.vclock.tick()
            super().step()
    return Ticking


def examples_multitenant(fleet, launches: dict, kern: dict) -> list:
    """``multitenant_serve`` on the card and on the CPU, both engines on
    a virtual clock: the printouts equal line for line (they depend on
    the clock and the token counts only); K4, K5 and K6 on the
    ``examples.multitenant_serve`` path, held against their plain
    versions on the inputs the card's run gave them (batched prompts,
    slots of different lengths)."""
    import torch

    from repro_torch.examples import multitenant_serve as ms

    orig = ms.MultiTenantEngine
    ms.MultiTenantEngine = _ticking_engine(DEVICE)
    seen_att, seen_rec = {}, {}
    try:
        restores = [_capture_attention(seen_att),
                    _capture_recurrent(seen_rec)]
        try:
            fleet.reset_launches()
            t0 = time.perf_counter()
            _, card = _quiet(ms.run, DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for restore in restores:
                restore()
        counts = {k: fleet.LAUNCHES[k] for k in SERVING_KERNELS + ("rwkv6",)}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            _, cpu = _quiet(ms.run, "cpu")
        finally:
            torch.set_num_threads(threads)
    finally:
        ms.MultiTenantEngine = orig
    failures = _path_launches("examples.multitenant_serve", counts, launches)
    same = card.splitlines() == cpu.splitlines()
    for line in card.splitlines()[-6:]:
        log(f"[examples] multitenant_serve: {line}")
    log(f"[examples] multitenant_serve on the card in {wall:.2f} s, "
        f"{len(card.splitlines())} lines, equal to the CPU's: {same} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        diff = [(a, b) for a, b in zip(card.splitlines(), cpu.splitlines())
                if a != b]
        log(f"[examples] multitenant_serve first difference: {diff[:1]}")
        failures.append("examples: multitenant_serve card vs cpu")
    path = "examples.multitenant_serve"
    failures += path_attention_checks(kern, seen_att, path=path)
    failures += path_recurrent_checks(kern, seen_rec, path, kinds=("rwkv6",))
    return failures


def _capture_fleet(seen: dict):
    """Wrap K1's, K2's and K3's wrappers in ``repro_torch.kernels.fleet``
    (the torch engine calls them through that module) so that ``seen``
    keeps copies of the inputs of the first call at each kernel, mode
    and shape; every call still runs the kernel. Returns the function
    that puts the wrappers back."""
    import torch

    orig = {k: getattr(fleet_mod(), k) for k in FLEET_KERNELS}

    def copy(v):
        return v.clone() if torch.is_tensor(v) else v

    def wrap(kind):
        def run(*args, **kw):
            # shapes and K2's mode; not the chunk word, new every chunk
            key = (kind, tuple(tuple(a.shape) if torch.is_tensor(a)
                               else a if isinstance(a, str) else None
                               for a in args)
                   + tuple(sorted((k, tuple(v.shape)) for k, v in kw.items()
                                  if torch.is_tensor(v))),
                   kw.get("cols"))
            if key not in seen:
                seen[key] = (tuple(copy(a) for a in args),
                             {k: copy(v) for k, v in kw.items()})
            return orig[kind](*args, **kw)
        return run

    for k in FLEET_KERNELS:
        setattr(fleet_mod(), k, wrap(k))

    def restore():
        for k in FLEET_KERNELS:
            setattr(fleet_mod(), k, orig[k])
    return restore


def fleet_mod():
    from repro_torch.kernels import fleet
    return fleet


def path_fleet_checks(out: dict, seen: dict, path: str) -> list:
    """K1, K2 and K3 against their plain versions on the inputs a path
    gave them (``seen``, from :func:`_capture_fleet`), as the kernels
    phase holds them: bit for bit (K2's row sums, in another order,
    within SUM_RTOL), timed by CUDA events beside their bounds; the
    cases join ``out``'s kernel records. Each of the three must have
    been captured. Returns the failures."""
    import torch

    fleet = fleet_mod()
    cases = {k: [] for k in FLEET_KERNELS}
    for (kind, _, _), (args, kw) in seen.items():
        if kind == "latency_scale":
            got = fleet.latency_scale(*args)
            ref = fleet.latency_scale_plain(*args)
            torch.cuda.synchronize()
            T, W = args[2].shape
            mism = int((got != ref).sum())
            pow_cells = int((args[2] / args[3][:, None] > 1.0).sum())
            label, dtype, sum_rel = f"{path} path ({T}, {W})", "float32", 0.0
            bound = fleet.latency_scale_bound_ms(T, W, pow_cells=pow_cells)
            err = float((got - ref).abs().max()) if got.numel() else 0.0

            def plain(args=args):
                return fleet.latency_scale_plain(*args)
        elif kind == "row_draw":
            mode, k0, k1, ch = args
            got = fleet.row_draw(*args, **kw)
            cols = (kw["active"].shape[1] if mode == "dense"
                    else kw["cols"])
            ref = fleet.row_draw_plain(
                mode, k0, k1, ch, cols, kw.get("scale"), kw["sigma"],
                kw.get("slo"), kw.get("active"), kw.get("totals"))
            torch.cuda.synchronize()
            mism, sum_rel = _draw_diff(got, ref)
            lat, rlat = (got, ref) if mode == "jitter" else (got[0], ref[0])
            err = float((lat - rlat).abs().max()) if lat.numel() else 0.0
            label = f"{path} path {mode} ({k0.shape[0]}, {cols})"
            dtype = "float32"
            bound = fleet.row_draw_bound_ms(mode, k0.shape[0], cols)

            def plain(args=args, kw=kw, cols=cols):
                mode, k0, k1, ch = args
                return fleet.row_draw_plain(
                    mode, k0, k1, ch, cols, kw.get("scale"), kw["sigma"],
                    kw.get("slo"), kw.get("active"), kw.get("totals"))
        else:
            k0, k1, ch, lam = args
            got = fleet.poisson(*args)
            ref = fleet.poisson_plain(*args)
            torch.cuda.synchronize()
            mism, sum_rel = int((got != ref).sum()), 0.0
            err = float((got - ref).abs().max()) if got.numel() else 0.0
            label, dtype = f"{path} path {tuple(lam.shape)}", "int32"
            bound = fleet.poisson_bound_ms(lam.cpu().numpy(),
                                           got.cpu().numpy())

            def plain(args=args):
                return fleet.poisson_plain(*args)

        def kernel(kind=kind, args=args, kw=kw):
            return getattr(fleet, kind)(*args, **kw)
        ms = cuda_ms(kernel)
        cases[kind].append(dict(
            case=label, dtype=dtype, max_abs_err=err, mismatches=mism,
            row_sum_max_rel_err=sum_rel,
            tolerance=f"bit for bit (row sums {SUM_RTOL:g})",
            ms=ms, event_ms=ms, ms_source="cuda events",
            plain_ms=cuda_ms(plain, reps=3), bound_ms=bound[0],
            bound_by=bound[1], library_ms=None,
            ok=mism == 0 and sum_rel <= SUM_RTOL))
    failures = []
    for name, found in cases.items():
        if not found:
            failures.append(f"{path} path: no {name} call captured")
            continue
        if name in out:
            out[name].setdefault("modes", {})
        merge_cases(out, name, found)
        failures += [f"kernel {name} on the {path} path's {c['case']}"
                     for c in found if not c["ok"]]
    return failures


def examples_federation(fleet, launches: dict, kern: dict) -> list:
    """``federation_demo --engine torch --quick`` on the card, as a user
    runs it (K2 and K3), and again with the torch engine's opt-in
    ``scale_kernel`` route on its scenario (K1 too; the reference's
    Pallas latency scale is likewise its jax engine's opt-in ``pallas``
    option, which its example passes no flag for), each against
    ``--engine batched --quick``: each policy's VR within VR_TOL. K1-K3
    on the ``examples.federation_demo`` path, held against their plain
    versions on the inputs the two runs gave them."""
    import torch

    from repro_torch.examples import federation_demo

    seen = {}
    fleet.reset_launches()
    t0 = time.perf_counter()
    restore = _capture_fleet(seen)
    scenarios = federation_demo.SCENARIOS
    try:
        res_t, table = _quiet(federation_demo.main,
                              ["--engine", "torch", "--quick"])
        sc = scenarios["paper_game_32"]
        federation_demo.SCENARIOS = {**scenarios, "paper_game_32":
                                     dataclasses.replace(sc, backend_options={
                                         **sc.backend_options,
                                         "scale_kernel": True})}
        res_k, _ = _quiet(federation_demo.main,
                          ["--engine", "torch", "--quick"])
        torch.cuda.synchronize()
    finally:
        federation_demo.SCENARIOS = scenarios
        restore()
    wall = time.perf_counter() - t0
    counts = {k: fleet.LAUNCHES[k] for k in FLEET_KERNELS}
    res_b, _ = _quiet(federation_demo.main, ["--engine", "batched",
                                             "--quick"])
    for line in table.splitlines()[1:8]:
        log(f"[examples] federation_demo torch: {line}")
    failures = _path_launches("examples.federation_demo", counts, launches)
    for tag, res in (("", res_t), (" scale_kernel", res_k)):
        for key, oc in res.outcomes.items():
            d = abs(oc.violation_rate - res_b.outcomes[key].violation_rate)
            ok = d <= VR_TOL
            log(f"[examples] federation_demo{tag} {key}: VR torch "
                f"{oc.violation_rate:.6f} batched "
                f"{res_b.outcomes[key].violation_rate:.6f} |dVR| {d:.2e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"examples: federation_demo{tag} {key} VR")
    log(f"[examples] federation_demo --engine torch --quick, as run and "
        f"with scale_kernel: {wall:.2f} s")
    failures += path_fleet_checks(kern, seen, "examples.federation_demo")
    return failures


def examples_elastic(fleet, launches: dict) -> list:
    """``elastic_restart`` on the card under deterministic algorithms:
    the example itself raises unless the resumed run's last loss equals
    the uninterrupted one (1e-6); here both runs' losses must be equal
    bit for bit. No kernel launches (the training route is plain)."""
    import torch

    from repro_torch.examples import elastic_restart

    torch.use_deterministic_algorithms(True)
    try:
        fleet.reset_launches()
        t0 = time.perf_counter()
        r, text = _quiet(elastic_restart.main, [])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    counts = {k: fleet.LAUNCHES[k] for k in ALL_KERNELS}
    for k, n in counts.items():
        launches.setdefault(k, {})["examples.elastic_restart"] = n
    ok = r["b"] == r["a"] and "BIT-EXACT RESUME" in text
    log(f"[examples] elastic_restart: loss@8 uninterrupted "
        f"{r['ref_loss']:.7f} resumed {r['res_loss']:.7f}, every step "
        f"equal: {r['b'] == r['a']}, {time.perf_counter() - t0:.1f} s, "
        f"launches {json.dumps(counts)} {'ok' if ok else 'FAIL'}")
    failures = [] if ok else ["examples: elastic_restart resume"]
    return failures + [f"elastic_restart launched kernel {k} {n} times"
                       for k, n in counts.items() if n]


def examples_train_100m(fleet, launches: dict) -> tuple[list, dict]:
    """``train_100m`` at its full size (12 layers, d 768, vocab 32,000,
    seq 512, batch 8) for T100M_STEPS steps, then ``--resume`` to
    T100M_RESUME_STEPS: per step the wall (host clock around the step,
    ended by a synchronize) and the span between CUDA events around it,
    tokens/s, the model FLOPs' share of the bf16 peak, peak memory; the
    loss must fall by T100M_MIN_DROP; no kernel launches (the
    ``examples.train_100m`` path: the training route is plain). One more
    step of the trained state under torch.profiler gives the step's
    device time (its kernels' sum; the event span also holds the gaps
    where the card waits for the host) and the busy share, that over the
    median wall. Returns (failures, row)."""
    import torch

    from repro_torch.examples import train_100m
    from repro_torch.models import build_model

    ckpt_dir = ROOT / "build" / "train_100m_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    steps, last = [], {}
    make = train_100m.make_train_step

    def timed(model, tc):
        step = make(model, tc)

        def fn(state, batch):
            last.update(step=step, batch=batch)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = step(state, batch)
            end.record()
            end.synchronize()
            steps.append({"wall_ms": 1e3 * (time.perf_counter() - t0),
                          "device_ms": start.elapsed_time(end)})
            last["state"] = out[0]
            return out
        return fn

    train_100m.make_train_step = timed
    try:
        fleet.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        args = train_100m.parse_args(["--steps", str(T100M_STEPS),
                                      "--ckpt-dir", str(ckpt_dir)])
        first, text = _quiet(train_100m.run, args)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        args = train_100m.parse_args(["--steps", str(T100M_RESUME_STEPS),
                                      "--ckpt-dir", str(ckpt_dir),
                                      "--resume"])
        second, text2 = _quiet(train_100m.run, args)
        torch.cuda.synchronize()
        counts = {k: fleet.LAUNCHES[k] for k in ALL_KERNELS}
        prof = profile_step(last["step"], last["state"], last["batch"],
                            tag="train_100m")
        last.clear()
    finally:
        train_100m.make_train_step = make
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    for k, n in counts.items():
        launches.setdefault(k, {})["examples.train_100m"] = n
    for line in (text + text2).splitlines():
        log(f"[train_100m] {line}")
    cfg = train_100m.config_100m()
    meta = build_model(cfg, device="meta", trainable=True)
    tokens = 8 * 512
    flops = model_flops_per_token(cfg, meta.params, seq=512) * tokens
    steady = steps[1:T100M_STEPS]
    wall = statistics.median(s["wall_ms"] for s in steady)
    span = statistics.median(s["device_ms"] for s in steady)
    dev = prof.get("kernels_ms", float("nan"))
    losses = [s["loss"] for s in first]
    row = {"arch": cfg.name, "params": sum(
        p.numel() for p in meta.params.parameters()), "seq": 512,
        "global_batch": 8, "remat": cfg.remat, "steps": len(first),
        "resumed_steps": len(second), "first_loss": losses[0],
        "last_loss": losses[-1], "resumed_last_loss": second[-1]["loss"],
        "step_wall_ms": wall, "step_device_ms": dev,
        "step_event_span_ms": span,
        "profiled_launches": prof.get("launches"),
        "step_wall_ms_min": min(s["wall_ms"] for s in steady),
        "step_wall_ms_max": max(s["wall_ms"] for s in steady),
        "first_step_wall_ms": steps[0]["wall_ms"],
        "tokens_per_s": tokens / (wall / 1e3),
        "model_flops_per_step": flops,
        "bf16_peak_share": flops / (wall / 1e3) / BF16_PEAK_FLOPS,
        "device_busy_share": dev / wall,
        "max_memory_allocated_gb": peak / 1e9, "run_s": run_s,
        "step_device_ms_each": [round(s["device_ms"], 2) for s in steps],
        "card": smi_line()}
    log(f"[train_100m] {json.dumps(row)}")
    failures = [f"train_100m launched kernel {k} {n} times"
                for k, n in counts.items() if n]
    if not all(math.isfinite(x) for x in losses):
        failures.append("train_100m: a loss is not finite")
    if not losses[-1] <= losses[0] - T100M_MIN_DROP:
        failures.append(f"train_100m: loss {losses[0]:.4f} -> "
                        f"{losses[-1]:.4f}, less than {T100M_MIN_DROP} down")
    if [s["step"] for s in second] != list(range(T100M_STEPS,
                                                 T100M_RESUME_STEPS)):
        failures.append("train_100m: --resume did not start at the "
                        "last checkpoint")
    return failures, row


def phase_examples(fleet, launches: dict, kern: dict) -> list:
    """The port's five examples on the card (see the constants above
    QS_STEPS). Returns the failures."""
    import torch

    t0 = time.perf_counter()
    failures = examples_quickstart(fleet, launches, kern)
    failures += examples_multitenant(fleet, launches, kern)
    failures += examples_federation(fleet, launches, kern)
    failures += examples_elastic(fleet, launches)
    gc.collect()
    torch.cuda.empty_cache()
    f, _ = examples_train_100m(fleet, launches)
    failures += f
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[examples] phase {time.perf_counter() - t0:.1f} s "
        f"{'ok' if not failures else 'FAIL: ' + '; '.join(failures)}")
    return failures


# ---------------------------------------------------------------- mesh
def phase_mesh(fleet, launches: dict) -> list:
    """The sharding layer on a one-rank NCCL group on the card: the
    launcher on ``make_host_mesh()`` against the same run on a mesh with
    no group behind it (the single-card step), every step's metrics equal
    bit for bit under deterministic algorithms; MoE ``tp`` under the
    (1, 1) mesh within MOE_TP_TOL of the local function (reduced
    olmoe-1b-7b and arctic-480b, f32); ``compressed_allreduce`` over the
    group (NCCL's all_to_all and all_gather) equal to its plain
    composition at world 1 (quantise, dequantise, requantise,
    dequantise); the group destroyed at the end. No kernel launches
    (the ``mesh`` path)."""
    import dataclasses as dc

    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch.launch.train as lt
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as meshes
    from repro_torch.models import moe as PM
    from repro_torch.parallel import compression as C
    from repro_torch.parallel.sharding import Mesh, use_mesh

    t0 = time.perf_counter()
    failures = []
    fleet.reset_launches()
    created = meshes.init_process_group(DEVICE)
    try:
        host = meshes.make_host_mesh(DEVICE)
        log(f"[mesh] {host} backend {dist.get_backend()} world "
            f"{dist.get_world_size()}")
        args = lt.parse_args(["--reduced", "--steps", str(MESH_STEPS)])
        torch.use_deterministic_algorithms(True)
        try:
            on_host, _ = _quiet(lt.train, args, host)
            alone, _ = _quiet(lt.train, args, Mesh(
                None, ("data", "model"), np.zeros((1, 1), int)))
        finally:
            torch.use_deterministic_algorithms(False)
        ok = on_host == alone
        log(f"[mesh] launcher on the host mesh {[m['total_loss'] for m in on_host]} "
            f"vs no group {[m['total_loss'] for m in alone]}: equal bit for "
            f"bit {ok} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("mesh: launcher on the host mesh differs")

        for arch in ("olmoe-1b-7b", "arctic-480b"):
            cfg = dc.replace(get_reduced(arch, capacity_factor=8.0),
                             dtype="float32", moe_strategy="tp")
            pm = PM.MoE(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        DEVICE)
            x = torch.randn((2, 16, cfg.d_model), device=DEVICE,
                            generator=torch.Generator(
                                device=DEVICE).manual_seed(1))
            local, aux_l = PM.moe_ffn(pm, x, cfg)
            with use_mesh(host):
                meshed, aux_m = PM.moe_ffn(pm, x, cfg)
            err = float((meshed - local).abs().max())
            aerr = abs(float(aux_m) - float(aux_l))
            ok = (err <= MOE_TP_TOL * (1 + float(local.abs().max()))
                  and aerr <= MOE_TP_TOL * abs(float(aux_l)))
            log(f"[mesh] moe tp {arch} under {host}: max err {err:.3g}, "
                f"aux err {aerr:.3g} (tol {MOE_TP_TOL}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"mesh: moe tp {arch}")

        x = torch.randn(1_000_003, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(2)) * 3
        got = C.compressed_allreduce(x, dist.group.WORLD)
        q, s, _ = C.quantize_int8(torch.nn.functional.pad(
            x, (0, (-x.numel()) % C.BLOCK)))
        part = (q.float() * s[:, None])
        pq, ps, _ = C.quantize_int8(part)
        want = (pq.float() * ps[:, None]).reshape(-1)[:x.numel()]
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        log(f"[mesh] compressed_allreduce over {dist.get_backend()} at world "
            f"1, {x.numel()} values: equal to the plain composition {ok}, "
            f"max err vs x {float((got - x).abs().max()):.3g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("mesh: compressed_allreduce at world 1")
        torch.cuda.synchronize()
    finally:
        if created:
            meshes.destroy_process_group()
    if dist.is_initialized():
        failures.append("mesh: the process group is still up")
    counts = {k: fleet.LAUNCHES[k] for k in ALL_KERNELS}
    for k, n in counts.items():
        launches.setdefault(k, {})["mesh"] = n
    failures += [f"mesh launched kernel {k} {n} times"
                 for k, n in counts.items() if n]
    log(f"[mesh] phase {time.perf_counter() - t0:.1f} s, group destroyed: "
        f"{not dist.is_initialized()} "
        f"{'ok' if not failures else 'FAIL: ' + '; '.join(failures)}")
    return failures


def dryrun_cells(failures: list) -> None:
    """DRY_CELLS on the fake (16, 16) mesh: each row's terms on a
    ``[dryrun]`` line; a status other than ok, an allocation on the card
    or a process group left after the cells is a failure."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import dryrun as D

    before = torch.cuda.memory_allocated()
    for arch, shape, ov in DRY_CELLS:
        t0 = time.perf_counter()
        try:
            r = D.run_cell(arch, shape, False, overrides=ov)
        except Exception as e:  # a cell that raises is a failed cell
            r = {"status": f"error {type(e).__name__}: {e}"}
        depth = f" (L {ov['num_layers']})" if "num_layers" in ov else ""
        if r["status"] != "ok":
            failures.append(f"dryrun {arch} x {shape}: {r['status']}")
            log(f"[dryrun] {arch} x {shape}{depth}: {r['status']} FAIL")
            continue
        mem = r["memory"]
        log(f"[dryrun] {arch} x {shape}{depth} on {r['n_chips']} ranks "
            f"(host-only): compute_s={r['compute_s']!r} "
            f"memory_s={r['memory_s']!r} "
            f"collective_s={r['collective_s']!r} dominant={r['dominant']} "
            f"hlo_flops={r['hlo_flops']!r} hlo_bytes={r['hlo_bytes']!r} "
            f"wire={r['collectives']['wire_bytes_per_chip']!r} "
            f"useful={r['useful_flops_frac']!r} "
            f"peak_bytes={mem['peak_bytes']} "
            f"argument_bytes={mem['argument_bytes']} "
            f"build {r['lower_s']} s, step {r['compile_s']} s, "
            f"wall {time.perf_counter() - t0:.1f} s ok")
    moved = torch.cuda.memory_allocated() - before
    if moved:
        failures.append(f"dryrun cells moved the card's memory by {moved}")
    if dist.is_initialized():
        failures.append("dryrun: a process group outlived the cells")
    log(f"[dryrun] card memory moved by {moved} bytes during the cells; "
        f"group up after them: {dist.is_initialized()}")


def dryrun_cross_check(failures: list) -> None:
    """The one-rank account of the train phase's step (full-width
    TRAIN_ARCH, seq TRAIN_SEQ, batch TRAIN_BATCH in TRAIN_MICROBATCHES,
    remat "selective", no group) against the same step run on the card
    under FlopCounterMode: FLOPs within DRY_FLOP_RTOL, peak memory (less
    what the card held before the state was built) within
    DRY_PEAK_RTOL."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.parallel.sharding import Mesh

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), remat="selective")
    shape = ShapeConfig("train_phase", TRAIN_SEQ, TRAIN_BATCH, "train")
    tc = TrainConfig(microbatches=TRAIN_MICROBATCHES, **TRAIN_TC)
    one = Mesh(None, ("data", "model"), np.zeros((1, 1), int))
    t0 = time.perf_counter()
    fake = D.account_cell(TRAIN_ARCH, shape, one, tc, cfg=cfg)
    t_fake = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn, args, _ = D.build_step(TRAIN_ARCH, shape, one, tc, cfg=cfg,
                                  device=DEVICE)
    t1 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    torch.cuda.synchronize()
    t_real = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    del fn, args
    gc.collect()
    torch.cuda.empty_cache()
    real_flops = fc.get_total_flops()
    f_rel = fake["hlo_flops"] / real_flops - 1
    p_rel = fake["memory"]["peak_bytes"] / peak - 1
    ok = abs(f_rel) <= DRY_FLOP_RTOL and abs(p_rel) <= DRY_PEAK_RTOL
    log(f"[dryrun] cross-check {TRAIN_ARCH} seq {TRAIN_SEQ} batch "
        f"{TRAIN_BATCH} in {TRAIN_MICROBATCHES} microbatches, remat "
        f"selective, one rank: FLOPs accounted {fake['hlo_flops']!r} vs "
        f"the card's step {real_flops!r} (rel {f_rel:+.3g}, tol "
        f"{DRY_FLOP_RTOL}); peak accounted {fake['memory']['peak_bytes']} "
        f"B vs the card's {peak} B (rel {p_rel:+.3g}, tol {DRY_PEAK_RTOL}); "
        f"accounting {t_fake:.1f} s host, card step {t_real:.2f} s under "
        f"FlopCounterMode; {smi_line()} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("dryrun cross-check against the card's step")


def dryrun_shard_check(failures: list) -> None:
    """DRY_SHARD_SCENARIO on the torch engine with ``shard`` True and
    False on this one-card host: the same run bit for bit (one visible
    card: nothing is padded)."""
    import hashlib

    from repro_torch.sim import SCENARIOS, run_scenario
    from repro_torch.sim.engines.torch_backend import visible_devices

    runs = {}
    for shard in (True, False):
        sc = dataclasses.replace(
            SCENARIOS[DRY_SHARD_SCENARIO], engine="torch",
            backend_options={"device": DEVICE, "shard": shard})
        res = run_scenario(sc, quick=True)
        h = hashlib.sha256()
        for key in sorted(res.results):
            for name in sorted(res.results[key].node_results):
                h.update(res.results[key].node_results[name]
                         .latencies.tobytes())
        runs[shard] = (h.hexdigest(), {
            k: (o.violation_rate, o.replaced, o.cloud)
            for k, o in res.outcomes.items()})
    ok = runs[True] == runs[False]
    log(f"[dryrun] torch engine shard=True vs shard=False on "
        f"{DRY_SHARD_SCENARIO} with {len(visible_devices(DEVICE))} visible "
        f"card(s): equal bit for bit {ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("dryrun: shard=True differs from shard=False")


def phase_dryrun(fleet, launches: dict) -> list:
    """The port's dry-run (host-only) and the torch engine's row sharding
    on the card: :func:`dryrun_cells`, :func:`dryrun_cross_check` and
    :func:`dryrun_shard_check`. The cells and the cross-check's train
    step launch no kernel (the ``dryrun`` path)."""
    t0 = time.perf_counter()
    failures = []
    fleet.reset_launches()
    dryrun_cells(failures)
    dryrun_cross_check(failures)
    counts = {k: fleet.LAUNCHES[k] for k in ALL_KERNELS}
    for k, n in counts.items():
        launches.setdefault(k, {})["dryrun"] = n
    failures += [f"dryrun launched kernel {k} {n} times"
                 for k, n in counts.items() if n]
    dryrun_shard_check(failures)
    log(f"[dryrun] phase {time.perf_counter() - t0:.1f} s "
        f"{'ok' if not failures else 'FAIL: ' + '; '.join(failures)}")
    return failures


def left_processes() -> list[str]:
    """Processes descended from this one that still exist (running or
    ended and not yet reaped), read from /proc."""
    procs = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            stat = Path(f"/proc/{d}/stat").read_text()
        except OSError:
            continue                        # ended while we looked
        # "pid (comm) state ppid ...": comm may hold spaces and parens
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        procs[int(d)] = (int(ppid), state, stat[stat.index("(") + 1:
                                                stat.rindex(")")])
    ours, grew = {os.getpid()}, True
    while grew:
        new = {p for p, (pp, _, _) in procs.items()
               if pp in ours and p not in ours}
        ours |= new
        grew = bool(new)
    return [f"{p} {procs[p][2]} ({procs[p][1]})"
            for p in sorted(ours - {os.getpid()})]


def stop_processes() -> list:
    """Stop the campaign's fork server (and the resource tracker it
    brought up), then fail if any process this run started is left."""
    if "repro_torch.campaign.executor" in sys.modules:
        sys.modules["repro_torch.campaign.executor"].shutdown()
    left = left_processes()
    log(f"[processes] left at the end: {left or 'none'}")
    return [f"process left running: {p}" for p in left]


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
    if {"train", "examples", "mesh"} & set(phases):
        # deterministic cuBLAS for the resume and bit-for-bit checks
        # (read when cuBLAS starts, so before any work on the card)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
        del eng, rt
        gc.collect()
    if "families" in phases:
        family_kernel_checks(kern)
        failures += [f"kernel {k}" for k in SERVING_KERNELS
                     if not kern[k]["ok"]]
        fleet.reset_launches()
        row, eng, names, prompts = serving_engine(fleet, FAM_ARCHS,
                                                  SERVING_KERNELS)
        if not row["ok"]:
            failures.append("full-width families engine")
        vrow, vmodel, vinputs = vision_run(fleet)
        if not vrow["ok"]:
            failures.append(f"{FAM_VISION_ARCH} run on the card")
        failures += _path_launches(
            "families", {k: fleet.LAUNCHES[k] for k in SERVING_KERNELS},
            launches)
        vision_device_time(vrow, vmodel, vinputs)
        del vinputs
        # the vision stub prefills from embeddings: it takes no prompt
        cuts = [(eng.tenants[n], p) for n, p in zip(names, prompts)]
        for rt, prompt in cuts + [(vmodel, None)]:
            n = (FAM_MOE_CUT_PROMPT if rt.cfg.family == "moe"
                 else SERVE_CUT_PROMPT)
            for dtype, tol in (("float32", REC_F32_TOL),
                               (rt.cfg.dtype, LOGIT_TOL)):
                if not cut_check(rt, prompt, FAM_CUT_LAYERS, dtype, tol,
                                 n=n)["ok"]:
                    failures.append(f"{rt.cfg.name} {dtype} cut check")
        del vmodel, rt, cuts
        gc.collect()
        dev = engine_device_time(row, eng, names, prompts)
        moe_name = names[FAM_ARCHS.index("olmoe-1b-7b")]
        moe_prefill_share(eng.tenants[moe_name], prompts[names.index(
            moe_name)], dev["tenants"][moe_name]["prefill_device_ms"])
        del eng
        gc.collect()
        if not mixed_engine_check()["ok"]:
            failures.append("mixed families engine, card against CPU")
    if "campaign" in phases:
        failures += phase_campaign(fleet, launches, kern)
    if "train" in phases:
        failures += phase_train(fleet, launches, kern)
    if "examples" in phases:
        failures += phase_examples(fleet, launches, kern)
    if "mesh" in phases:
        failures += phase_mesh(fleet, launches)
    if "dryrun" in phases:
        failures += phase_dryrun(fleet, launches)

    failures += stop_processes()

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
    # ported it, where that path ran (else the most any path made);
    # ``launches_by_path`` has each path (``train``, ``mesh``, ``dryrun``
    # and the training examples: 0 for every kernel)
    home = dict.fromkeys(FLEET_KERNELS, "simulator")
    home.update(dict.fromkeys(SERVING_KERNELS, "serving"))
    home.update(dict.fromkeys(RECURRENT_KERNELS, "recurrent"))
    for name, r in kern.items():
        by_path = launches.get(name, {})
        entry = {"name": name, "route": "cuda", "source": sources[name],
                 "replaces": replaces[name],
                 "launches": by_path.get(home[name],
                                         max(by_path.values(), default=0)),
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
