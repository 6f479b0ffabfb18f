"""Serving-engine benchmarks (beyond-paper): the federated real-engine
scenario (token-level DYVERSE), controller actuation latency against a
LIVE engine, and engine decode throughput vs tenants.

Every engine runs on ``device`` (default ``"cuda"``: the attention
kernels; ``"cpu"``: their plain torch versions). Without a card
``"cuda"`` raises; nothing falls back to the CPU."""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.core import TenantSpec
from repro_torch.serving import EngineConfig, MultiTenantEngine


def serving_federation(scenario: str = "serving_edge_pair",
                       device: str = "cuda", repeats: int = 2):
    """Token-level DYVERSE end-to-end: the registry serving scenario
    (real engines on a 2-node federation, scheduled node failure) per
    policy. Raises if a run produced a non-finite violation rate or
    completed zero requests — this doubles as the CI health gate for
    the serving control loop. Walls (and tokens/s) are the min over
    ``repeats`` runs: the first run on the card also builds the kernels
    and starts CUDA. Every run's outcomes must be equal, since they
    depend on the virtual clock and token counts alone."""
    from repro_torch.sim.scenario import SCENARIOS, run_scenario
    sc = SCENARIOS[scenario]
    sc = dataclasses.replace(
        sc, backend_options={**sc.backend_options, "device": device})
    runs = [run_scenario(sc) for _ in range(max(repeats, 1))]
    res = runs[0]
    for other in runs[1:]:
        if _outcomes(other) != _outcomes(res):
            raise RuntimeError(f"{scenario}: outcomes differ between "
                               f"repeated runs on {device}")
    rows = []
    for key, out in res.outcomes.items():
        fr = res.results[key]
        if not math.isfinite(out.violation_rate):
            raise RuntimeError(f"{scenario}/{key}: non-finite violation rate")
        if fr.completed <= 0:
            raise RuntimeError(f"{scenario}/{key}: zero Edge-completed "
                               f"requests — engine served nothing")
        wall = min(r.outcomes[key].wall_s for r in runs)
        rows.append({
            "bench": "serving_federation", "scenario": scenario,
            "policy": key, "device": device, "repeats": len(runs),
            "violation_rate": out.violation_rate,
            "total_requests": fr.total_requests,
            "completed": fr.completed,
            "cloud_requests": fr.cloud_requests,
            "tokens": fr.tokens,
            "tokens_per_s": fr.tokens / wall if wall else 0.0,
            "virtual_duration_s": fr.virtual_duration_s,
            "failed_nodes": fr.failed_nodes,
            "failovers": sum(1 for p in fr.placements
                             if p.kind == "failover"),
            "max_round_overhead_s": max(
                (p + s for nr in fr.node_results.values()
                 for p, s in zip(nr.overhead_priority_s,
                                 nr.overhead_scaling_s)), default=0.0),
            "wall_s": wall,
        })
    return rows


def _outcomes(res) -> dict:
    """A scenario result's outcomes without its wall-clock fields."""
    return {k: {f: v for f, v in oc.to_record().items()
                if "wall" not in f and "overhead" not in f}
            for k, oc in res.outcomes.items()}


def engine_throughput(tenant_counts=(1, 2, 4), device: str = "cuda"):
    """Decode throughput (tokens/s across tenants) on CPU-sized models —
    demonstrates continuous batching under multi-tenancy."""
    rows = []
    for n in tenant_counts:
        eng = MultiTenantEngine(EngineConfig(
            policy="none", slot_cap=4, capacity_slots=4 * n,
            capacity_pages=64 * n, max_seq_len=64), device=device)
        for i in range(n):
            eng.add_tenant(TenantSpec(name=f"t{i}", slo_latency=60.0),
                           get_reduced("tinyllama-1.1b"))
        rng = np.random.default_rng(0)
        for i in range(4 * n):
            eng.submit(f"t{i % n}", list(rng.integers(1, 200, 8)),
                       max_new_tokens=8)
        eng.drain(max_steps=10)   # warm-up
        t0 = time.perf_counter()
        for i in range(4 * n):
            eng.submit(f"t{i % n}", list(rng.integers(1, 200, 8)),
                       max_new_tokens=8)
        eng.drain(max_steps=400)
        dt = time.perf_counter() - t0
        toks = sum(len(r.generated) for r in eng.completed)
        rows.append({"bench": "engine_throughput", "tenants": n,
                     "device": device, "tokens": toks,
                     "tokens_per_s": toks / dt, "wall_s": dt})
    return rows


def actuation_latency(device: str = "cuda"):
    """DYVERSE's core overhead claim, against a live engine: quota change
    (vertical scaling) and termination are control-plane-only."""
    eng = MultiTenantEngine(EngineConfig(policy="sps", slot_cap=4,
                                         capacity_slots=16,
                                         capacity_pages=256,
                                         max_seq_len=64,
                                         round_interval_steps=10**9),
                            device=device)
    for i in range(4):
        eng.add_tenant(TenantSpec(name=f"t{i}", slo_latency=1e-4),
                       get_reduced("tinyllama-1.1b"))
    rng = np.random.default_rng(0)
    for i in range(8):
        eng.submit(f"t{i % 4}", list(rng.integers(1, 200, 8)), 4)
    eng.drain(max_steps=100)
    t0 = time.perf_counter()
    report = eng.ctrl.run_round()
    dt = time.perf_counter() - t0
    return [{"bench": "actuation", "what": "full scaling round (4 tenants)",
             "device": device, "ms": dt * 1e3,
             "priority_ms": report.priority_update_s * 1e3,
             "scaling_ms": report.scaling_s * 1e3,
             "actions": len(report.actions)}]
