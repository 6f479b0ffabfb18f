"""End-to-end example (the paper's scenario): a multi-tenant node serving
several model architectures under DYVERSE dynamic vertical scaling (the
JAX package's ``examples/multitenant_serve.py`` on the port).

Three tenants (llama-family chat, MoE code model, RWKV6 summariser) share
one node. The chat tenant gets a flood of requests and starts violating
its SLO; DYVERSE's scaling rounds reallocate slots/pages toward it —
watch the quota snapshots change. A low-priority tenant is eventually
evicted to the Cloud tier when resources run dry. On the card the
tenants prefill and decode through K4/K5 (tinyllama, olmoe) and K6
(rwkv6).

  PYTHONPATH=src python -m repro_torch.examples.multitenant_serve [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.core import PricingModel, TenantSpec
from repro_torch.serving import EngineConfig, MultiTenantEngine


def run(device="cuda"):
    """The demo on ``device``; returns the engine it ran."""
    eng = MultiTenantEngine(EngineConfig(
        policy="sdps", slot_cap=4, capacity_slots=10, capacity_pages=160,
        max_seq_len=64, round_interval_steps=30), device=device)

    tenants = [
        (TenantSpec(name="chat", slo_latency=2.0, users=50, premium=1.0,
                    pricing=PricingModel.HYBRID), "tinyllama-1.1b"),
        (TenantSpec(name="code", slo_latency=8.0, users=10,
                    donation=True), "olmoe-1b-7b"),
        (TenantSpec(name="summarize", slo_latency=8.0, users=2),
         "rwkv6-3b"),
    ]
    for spec, arch in tenants:
        ok = eng.add_tenant(spec, get_reduced(arch))
        print(f"admit {spec.name:10s} ({arch:15s}) -> {ok}")

    rng = np.random.default_rng(0)

    def flood(n_chat, n_code, n_sum, mnt=6):
        for i in range(max(n_chat, n_code, n_sum)):
            if i < n_chat:
                eng.submit("chat", list(rng.integers(1, 200, 8)), mnt)
            if i < n_code:
                eng.submit("code", list(rng.integers(1, 200, 8)), mnt)
            if i < n_sum:
                eng.submit("summarize", list(rng.integers(1, 200, 8)), mnt)

    print("\n--- phase 1: balanced load ---")
    flood(3, 3, 2)
    eng.drain(max_steps=120)
    print("quotas:", {k: v["units"] for k, v in eng.ctrl.snapshot().items()})
    print(f"completed={len(eng.completed)} VR={eng.ctrl.node_violation_rate:.2f}")

    print("\n--- phase 2: chat flood (SLO pressure) + scaling rounds ---")
    for wave in range(3):
        flood(8, 1, 1)
        eng.run(40)          # rounds fire every 30 steps
        snap = eng.ctrl.snapshot()
        print(f"wave {wave}: quotas=" +
              str({k: v['units'] for k, v in snap.items()}) +
              f"  evicted={sorted(set(r.req.tenant for r in eng.cloud_serviced))}")
    eng.drain(max_steps=400)

    print("\n--- summary ---")
    by_tenant = {}
    for r in eng.completed:
        by_tenant.setdefault(r.req.tenant, []).append(r.latency())
    for t, lats in by_tenant.items():
        print(f"{t:10s} served={len(lats):3d}  "
              f"p50={np.median(lats):.2f}s  p95={np.quantile(lats, .95):.2f}s")
    print(f"cloud-serviced={len(eng.cloud_serviced)}  "
          f"edge VR={eng.ctrl.node_violation_rate:.2%}")
    print("scale events:",
          {n: s["scale_count"] for n, s in eng.ctrl.snapshot().items()})
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the tenants' models run (cuda or cpu)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
