#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Builds the fleet kernels from ``src/repro_torch/csrc`` with nvcc, holds
each against its plain torch version at the main path's shapes, then
drives ``engine="torch"`` through the paper scenarios and the
mega-scale federations and checks every result against the port's own
batched engine. Needs one CUDA card; exits non-zero on any failure.

    python3 chip_smoke.py                 # everything
    python3 chip_smoke.py --phases env,kernels

The line before the last is the card (``nvidia-smi`` name and power
limit) and, before that, the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("env", "kernels", "paper", "mega")
VR_TOL = 0.02           # engine="torch" vs the port's batched engine
CPU_GPU_VR_TOL = 1e-3   # the same engine on the card and on the CPU
LAT_RTOL = 1e-5         # f32 latency: erfinv/exp implementations
SCALE_RTOL = 1e-6       # f32 division and pow
SUM_RTOL = 1e-5         # f32 row sums in another order
# main-path sizes: the jaxscale stream row (4 × 25,000 tenants) and a
# 4 × 2,500 game federation whose 120 s chunks reach L = 6848 requests
STREAM_TENANTS = 100_000
GAME_TENANTS = 10_000
GAME_L = 6848
CHUNK_S = 120
DEVICE = "cuda"


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
    log(f"kernel build: {secs:.2f} s (nvcc {' '.join(fleet.NVCC_FLAGS)})")
    return {"build_s": secs}


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
    f64_ref = fb.latency_scale(units, 0, CHUNK_S)
    rel64 = float(np.max(np.abs(got.cpu().numpy() - f64_ref) / f64_ref))
    bound, by = fleet.latency_scale_bound_ms(*demand.shape)
    results["latency_scale"] = dict(
        shape=list(demand.shape), max_abs_err=err, max_rel_err=rel,
        max_rel_err_vs_numpy_f64=rel64, mismatches=0,
        **kernel_times(lambda: fleet.latency_scale(*args),
                       "latency_scale_kernel"),
        plain_ms=all_kernels_ms(lambda: fleet.latency_scale_plain(*args)),
        bound_ms=bound, bound_by=by, library_ms=None,
        ok=rel <= SCALE_RTOL and rel64 <= 2e-5)

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
    ref = fleet.row_draw_plain("dense", k0, k1, ch, CHUNK_S, scale, sigma,
                               slo, active, None)
    results["row_draw"] = _row_draw_check(fleet, "dense", got, ref, slo,
                                          active, counts.shape)
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
    ref = fleet.row_draw_plain("fused", gk0, gk1, ch, L, gscale, gsig, gslo,
                               None, totals)
    mask = torch.arange(L, device=DEVICE)[None, :] < totals[:, None]
    fused = _row_draw_check(fleet, "fused", got, ref, gslo, mask, (G, L))
    fused.update(
        **kernel_times(lambda: fleet.row_draw("fused", gk0, gk1, ch,
                                              **fused_kw), "row_draw_kernel"),
        plain_ms=all_kernels_ms(lambda: fleet.row_draw_plain(
            "fused", gk0, gk1, ch, L, gscale, gsig, gslo, None, totals),
            reps=3))
    got = fleet.row_draw("jitter", gk0, gk1, ch, cols=L, sigma=gsig)
    ref = fleet.row_draw_plain("jitter", gk0, gk1, ch, L, None, gsig)
    torch.cuda.synchronize()
    jerr = float(((got - ref).abs() / ref).max())
    bound, by = fleet.row_draw_bound_ms("jitter", G, L)
    jitter = dict(
        shape=[G, L], max_abs_err=float((got - ref).abs().max()),
        max_rel_err=jerr, mismatches=0,
        **kernel_times(lambda: fleet.row_draw("jitter", gk0, gk1, ch,
                                              cols=L, sigma=gsig),
                       "row_draw_kernel"),
        plain_ms=all_kernels_ms(lambda: fleet.row_draw_plain(
            "jitter", gk0, gk1, ch, L, None, gsig), reps=3),
        bound_ms=bound, bound_by=by, ok=jerr <= LAT_RTOL)
    results["row_draw"]["modes"] = {"fused": fused, "jitter": jitter}
    results["row_draw"]["ok"] = (results["row_draw"]["ok"] and fused["ok"]
                                 and jitter["ok"])

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
        library_ms=all_kernels_ms(lambda: torch.poisson(lam), reps=20),
        ok=(mism + mism_big <= 1e-5 * (lam.numel() + lam_big.numel())
            and abs(mean_big - 150.0) < 5 * math.sqrt(150.0 / lam_big.numel())
            and abs(var_big / 150.0 - 1.0) < 0.05))
    for name, r in results.items():
        log(f"[kernel] {name}: " + json.dumps(r))
        rows = [(name, r)] + [(f"{name}/{m}", v)
                              for m, v in r.get("modes", {}).items()]
        for label, v in rows:
            log(f"[kernel] {label} {v['shape']}: max err "
                f"{v['max_abs_err']:.3g}, mismatches {v['mismatches']}, kernel {v['ms']:.4f} ms "
                f"({v['ms_source']}; events {v['event_ms']:.4f} ms), plain "
                f"{v['plain_ms']:.3f} ms, bound {v['bound_ms'] * 1e3:.2f} µs "
                f"({v['bound_by']}) {'ok' if v['ok'] else 'FAIL'}")
    return results


def _row_draw_check(fleet, mode, got, ref, slo, mask, shape) -> dict:
    """Dense/fused outputs against the plain version: latencies within
    LAT_RTOL, flags equal outside the band |lat/slo - 1| <= LAT_RTOL,
    row sums within SUM_RTOL, counts equal up to the band's flags."""
    import torch

    lat, viol, lsum, cnt = got
    rlat, rviol, rlsum, rcnt = ref
    torch.cuda.synchronize()
    rel = ((lat - rlat).abs() / rlat.abs()).max()
    band = (rlat / slo[:, None] - 1.0).abs() <= LAT_RTOL
    flag_mism = int(((viol != rviol) & ~band).sum())
    band_rows = (band & mask).sum(dim=1)
    cnt_bad = int(((cnt - rcnt).abs() > band_rows).sum())
    sum_rel = float(((lsum - rlsum).abs()
                     / rlsum.abs().clamp(min=1e-30)).max())
    bound, by = fleet.row_draw_bound_ms(mode, *shape)
    return dict(shape=list(shape),
                max_abs_err=float((lat - rlat).abs().max()),
                max_rel_err=float(rel), mismatches=flag_mism + cnt_bad,
                flags_in_band=int((viol != rviol).sum()) - flag_mism,
                row_sum_max_rel_err=sum_rel, bound_ms=bound, bound_by=by,
                library_ms=None,
                ok=(float(rel) <= LAT_RTOL and flag_mism == 0
                    and cnt_bad == 0 and sum_rel <= SUM_RTOL))


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


# ------------------------------------------------------------------- main
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
        phase_env(fleet)
    else:
        fleet.build()
    kern = phase_kernels(fleet) if "kernels" in phases else {}
    failures += [f"kernel {k}" for k, r in kern.items() if not r["ok"]]

    main_path = [p for p in ("paper", "mega") if p in phases]
    launches = {}
    if main_path:
        fleet.reset_launches()
        if "paper" in phases and not phase_paper()["ok"]:
            failures.append("paper scenarios")
        if "mega" in phases and not phase_mega()["ok"]:
            failures.append("mega-scale federations")
        torch.cuda.synchronize()
        launches = dict(fleet.LAUNCHES)
        log(f"[launches] main path: {json.dumps(launches)}")
        failures += [f"kernel {k} never launched on the main path"
                     for k, n in launches.items() if n == 0]

    record = []
    sources = {"latency_scale": "src/repro_torch/csrc/latency_scale.cu",
               "row_draw": "src/repro_torch/csrc/row_draw.cu",
               "poisson": "src/repro_torch/csrc/poisson.cu"}
    replaces = {
        "latency_scale": "src/repro/sim/engines/jax_backend.py:151",
        "row_draw": "src/repro/sim/engines/jax_backend.py:124",
        "poisson": "src/repro/sim/engines/jax_backend.py:145"}
    for name, r in kern.items():
        entry = {"name": name, "route": "cuda", "source": sources[name],
                 "replaces": replaces[name],
                 "launches": launches.get(name, 0),
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "event_ms": r["event_ms"], "ms_source": r["ms_source"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if "modes" in r:
            entry["modes"] = {m: {k: v[k] for k in (
                "max_abs_err", "ms", "event_ms", "plain_ms", "bound_ms",
                "bound_by")}
                for m, v in r["modes"].items()}
        record.append(entry)
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": record}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
