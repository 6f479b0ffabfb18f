"""Serving launcher: multi-tenant engine + DYVERSE under a request trace.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --tenants chat:tinyllama-1.1b code:olmoe-1b-7b --policy sdps \
      --requests 24 [--device cpu]

Models are the reduced configs of any of the ten architectures.
``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.core import PricingModel, TenantSpec
from repro_torch.serving import EngineConfig, MultiTenantEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", nargs="+",
                    default=["chat:tinyllama-1.1b", "code:olmoe-1b-7b"],
                    help="name:arch pairs")
    ap.add_argument("--policy", default="sdps",
                    choices=["none", "sps", "wdps", "cdps", "sdps"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slo", type=float, default=5.0)
    ap.add_argument("--round-steps", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="where the models run (cuda or cpu)")
    args = ap.parse_args(argv)

    n = len(args.tenants)
    eng = MultiTenantEngine(EngineConfig(
        policy=args.policy, slot_cap=4, capacity_slots=4 * n,
        capacity_pages=64 * n, max_seq_len=64,
        round_interval_steps=args.round_steps), device=args.device)
    for spec in args.tenants:
        name, arch = spec.split(":")
        assert arch in ARCH_IDS, f"unknown arch {arch}"
        ok = eng.add_tenant(
            TenantSpec(name=name, slo_latency=args.slo,
                       pricing=PricingModel.HYBRID),
            get_reduced(arch))
        print(f"admit {name} ({arch}): {ok}")

    rng = np.random.default_rng(0)
    names = [t.split(":")[0] for t in args.tenants]
    for i in range(args.requests):
        eng.submit(names[i % n], list(rng.integers(1, 200, 8)),
                   max_new_tokens=6)
    eng.drain(max_steps=800)

    print(f"\ncompleted={len(eng.completed)} cloud={len(eng.cloud_serviced)} "
          f"VR={eng.ctrl.node_violation_rate:.2%}")
    for name in names:
        lats = [r.latency() for r in eng.completed if r.req.tenant == name]
        if lats:
            print(f"{name:10s} n={len(lats)} p50={np.median(lats):.2f}s")
    print("quotas:", {k: v["units"] for k, v in eng.ctrl.snapshot().items()})


if __name__ == "__main__":
    main()
