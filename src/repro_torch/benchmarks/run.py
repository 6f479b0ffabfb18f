"""Benchmark runner of the port: one section per paper table/figure.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--quick] \\
      [--only fig2,fig3,...] [--device cuda|cpu]

Prints ``name,us_per_call,derived`` CSV rows (plus figure tables) and
writes results/torch_benchmarks.json. Perf-trajectory sections
(``fedscale``, ``scale``, ``ctrlscale``, ``serving``, ...) additionally
persist a root-level ``BENCH_torch<section>.json`` in full mode (machine
info, the card's name and power limit included, + min-of-N walls +
throughputs) so later changes can diff their numbers against the ones
committed with this tree; the reference's ``BENCH_<section>.json`` files
are never written. ``--device`` (default ``cuda``) is where the torch
engine (``scale``), the serving engines (``serving``, and the serving
scenarios of ``scenarios`` and ``resilience``) and the priority scorer
(``fig2``) run; without a card ``cuda`` raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _csv(name: str, us: float, derived: str):
    print(f"{name},{us:.1f},{derived}")


def _persist_section(section: str, rows, quick: bool) -> None:
    """Root-level BENCH_torch<section>.json (the shared
    :mod:`repro_torch.campaign.benchio` schema): the perf trajectory
    later changes diff against. Quick (CI-sized) runs are not
    comparable walls, so they are never persisted."""
    if quick:
        return
    from repro_torch.campaign.benchio import write_bench

    write_bench(section, rows)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized run: skip the engine microbenches "
                         "and shrink fedscale and scale to tiny smoke "
                         "configs that raise on any engine divergence; "
                         "nothing is persisted")
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device of the torch engine (scale), the serving "
                         "engines (serving, scenarios, resilience) and the "
                         "priority scorer (fig2); default: cuda")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None

    from repro_torch.benchmarks import paper_figs, serving_bench

    results: dict[str, object] = {}
    print("name,us_per_call,derived")

    def want(k):
        return only is None or k in only

    if want("fig2"):
        t0 = time.perf_counter()
        rows = paper_figs.fig2_overhead()
        results["fig2"] = rows
        at32 = [r for r in rows if r["tenants"] == 32]
        for r in at32:
            _csv(f"fig2/{r['workload']}/{r['policy']}",
                 r["per_server_ms"] * 1e3,
                 f"per-server overhead at 32 tenants (paper: sub-second)")
        rows_x = paper_figs.fig2_priority_scaling_to_1024(args.device)
        results["fig2x"] = rows_x
        for r in rows_x:
            _csv(f"fig2x/priority_update/{r['tenants']}",
                 r["score_update_us"], f"{r['us_per_tenant']:.3f} us/tenant (O(N))")

    if want("fig3"):
        rows = paper_figs.fig3_timeline()
        results["fig3"] = rows
        for kind in ("game", "fd"):
            for pol in ("none", "sps", "sdps"):
                tl = [r["violation_rate"] for r in rows
                      if r["workload"] == kind and r["policy"] == pol]
                _csv(f"fig3/{kind}/{pol}", 0.0,
                     "perminute VR: " + " ".join(f"{v:.2f}" for v in tl[::4]))

    if want("fig45"):
        rows = paper_figs.fig45_violation_rates()
        results["fig45"] = rows
        for r in rows:
            if r["tenants"] == 32:
                _csv(f"{r['figure']}/{r['workload']}/slo{r['slo_scale']}/{r['policy']}",
                     0.0, f"VR={r['violation_rate'] * 100:.1f}%")
        claims = paper_figs.check_claims(rows, results.get("fig3", []))
        results["claims"] = claims
        for c in claims:
            _csv(f"claim/{c['claim'][:40]}", 0.0,
                 f"holds={c['holds']} ours={c['ours']} paper={c['paper']}")

    if want("fig67"):
        rows = paper_figs.fig67_latency_distribution()
        results["fig67"] = rows
        for r in rows:
            if r["slo_scale"] == 1.0 and r["band"] == "[0.00,0.80)":
                _csv(f"{r['figure']}/{r['workload']}/{r['policy']}/lowband",
                     0.0, f"{r['fraction'] * 100:.1f}% of requests in lowest band")

    if want("serving"):
        # the federated real-engine scenario runs even in --quick: it IS
        # the health gate for the serving control loop (raises on a
        # non-finite VR or zero Edge-completed requests)
        rows = serving_bench.serving_federation(
            device=args.device, repeats=1 if args.quick else 2)
        results["serving_federation"] = rows
        for r in rows:
            _csv(f"serving/federation/{r['policy']}",
                 r["wall_s"] * 1e6,
                 f"VR={r['violation_rate'] * 100:.1f}% "
                 f"completed={r['completed']} cloud={r['cloud_requests']} "
                 f"{r['tokens_per_s']:.0f} tok/s "
                 f"failovers={r['failovers']} "
                 f"max-ovh={r['max_round_overhead_s'] * 1e3:.2f}ms")
        _persist_section("serving", rows, args.quick)
        if not args.quick:
            rows = serving_bench.actuation_latency(device=args.device)
            results["actuation"] = rows
            for r in rows:
                _csv("serving/actuation_round", r["ms"] * 1e3,
                     f"priority={r['priority_ms']:.3f}ms scaling={r['scaling_ms']:.3f}ms")
            rows = serving_bench.engine_throughput(device=args.device)
            results["engine"] = rows
            for r in rows:
                _csv(f"serving/throughput/{r['tenants']}t", 0.0,
                     f"{r['tokens_per_s']:.1f} tok/s")

    if want("fed"):
        from repro_torch.benchmarks import federation_bench
        sp = federation_bench.engine_speedup()
        results["fed_speedup"] = sp
        _csv("fed/engine_speedup", sp["vector_wall_s"] * 1e6,
             f"vectorized {sp['speedup']:.1f}x / batched "
             f"{sp['batched_speedup_vs_scalar']:.1f}x vs scalar loop "
             f"({sp['batched_steps_per_s']:.0f} vs "
             f"{sp['vector_steps_per_s']:.0f} vs "
             f"{sp['scalar_steps_per_s']:.0f} sim-steps/s, "
             f"identical={sp['bitwise_identical']})")
        rows = federation_bench.federation_sweep()
        results["fed_sweep"] = rows
        for r in rows:
            _csv(f"fed/{r['n_nodes']}node/{r['policy']}",
                 r["max_round_overhead_s"] * 1e6,
                 f"VR={r['violation_rate'] * 100:.1f}% "
                 f"replaced={r['replaced']} cloud={r['cloud']} "
                 f"max-node-overhead={r['max_round_overhead_s'] * 1e3:.2f}ms")

    if want("fedscale"):
        from repro_torch.benchmarks import federation_bench
        rows = federation_bench.fleet_scale_sweep(quick=args.quick)
        results["fedscale"] = rows
        for r in rows:
            _csv(
                f"fedscale/{r['workload']}/{r['n_nodes']}x"
                f"{r['tenants_per_node']}t/ri{r['round_interval']}/"
                f"{r['policy']}",
                r["batched_wall_s"] * 1e6,
                f"{r['tenant_seconds'] / 1e6:.2f}M t-s: batched "
                f"{r['batched_ts_per_s'] / 1e6:.2f}M t-s/s vs vectorized "
                f"{r['vectorized_ts_per_s'] / 1e6:.2f}M t-s/s "
                f"({r['speedup_batched_vs_vectorized']:.1f}x, "
                f"bitwise={r['bitwise_identical']})")
        _persist_section("fedscale", rows, args.quick)

    if want("scale"):
        from repro_torch.benchmarks import federation_bench
        rows = federation_bench.torch_scale_sweep(quick=args.quick,
                                                  device=args.device)
        results["scale"] = rows
        for r in rows:
            _csv(
                f"scale/{r['workload']}/{r['n_nodes']}x"
                f"{r['tenants_per_node']}t/ri{r['round_interval']}/"
                f"{r['policy']}",
                r["torch_wall_s"] * 1e6,
                f"{r['tenant_seconds'] / 1e6:.2f}M t-s: torch "
                f"{r['torch_ts_per_s'] / 1e6:.2f}M t-s/s vs batched "
                f"{r['batched_ts_per_s'] / 1e6:.2f}M t-s/s "
                f"({r['speedup_torch_vs_batched']:.2f}x on "
                f"{r['device']}, dVR={r['vr_delta'] * 100:+.3f}pp)")
        _persist_section("scale", rows, args.quick)

    if want("ctrlscale"):
        from repro_torch.benchmarks import federation_bench
        rows = federation_bench.control_plane_scale(quick=args.quick)
        results["ctrlscale"] = rows
        for r in rows:
            _csv(
                f"ctrlscale/{r['scenario']}/{r['tenants']}t/"
                f"ri{r['round_interval']}",
                r["array_wall_s"] * 1e6,
                f"array {r['array_rounds_per_s']:.0f} rounds/s vs "
                f"reference {r['reference_rounds_per_s']:.0f} rounds/s "
                f"({r['speedup']:.2f}x, "
                f"bitwise={r['bitwise_identical']})")
        _persist_section("ctrlscale", rows, args.quick)

    if want("scenarios"):
        from repro_torch.benchmarks import federation_bench
        rows = federation_bench.scenario_walls(quick=args.quick,
                                               device=args.device)
        results["scenarios"] = rows
        for r in rows:
            _csv(
                f"scenarios/{r['scenario']}",
                r["wall_s"] * 1e6,
                f"{r['tenants']}t×{r['n_nodes']}n/{r['duration_s']}s "
                f"{r['placement']}: VR={r['violation_rate'] * 100:.1f}% "
                f"replaced={r['replaced']} cloud={r['cloud']} "
                f"max-ovh={r['max_round_overhead_s'] * 1e3:.2f}ms")
        _persist_section("scenarios", rows, args.quick)

    if want("forecast"):
        from repro_torch.benchmarks import federation_bench
        rows = federation_bench.forecast_sweep(quick=args.quick,
                                               device=args.device)
        results["forecast"] = rows
        for r in rows:
            _csv(
                f"forecast/{r['scenario']}/{r['scaling_policy']}",
                r["wall_s"] * 1e6,
                f"VR={r['violation_rate'] * 100:.2f}% "
                f"(Δ vs reactive "
                f"{r['vr_delta_vs_reactive'] * 100:+.2f}pp) "
                f"nv-lat={r['nonviolated_latency_s'] * 1e3:.1f}ms "
                f"fc-ovh={r['mean_forecast_overhead_s'] * 1e6:.0f}us "
                f"[{r['forecaster']}]")
        _persist_section("forecast", rows, args.quick)

    if want("resilience"):
        from repro_torch.benchmarks import federation_bench
        rows = federation_bench.resilience_sweep(quick=args.quick,
                                                 device=args.device)
        results["resilience"] = rows
        for r in rows:
            _csv(
                f"resilience/{r['scenario']}/{r['policy']}",
                r["wall_s"] * 1e6,
                f"VR={r['violation_rate'] * 100:.2f}% "
                f"(Δ vs none {r['vr_delta_vs_none'] * 100:+.2f}pp) "
                f"recovered={r['recovered_tenants']} "
                f"cloud={r['cloud']} shed={r['shed']} "
                f"conserved={r['requests_conserved']}")
        _persist_section("resilience", rows, args.quick)

    if want("overhead"):
        from repro_torch.benchmarks import federation_bench
        rows = federation_bench.overhead_sweep(quick=args.quick)
        results["overhead"] = rows
        for r in rows:
            _csv(
                f"overhead/{r['servers']}srv",
                r["per_server_overhead_s"] * 1e6,
                f"round={r['round_overhead_s'] * 1e3:.3f}ms "
                f"(mon={r['monitoring_s'] * 1e3:.3f} "
                f"pri={r['priority_s'] * 1e3:.3f} "
                f"scl={r['scaling_s'] * 1e3:.3f}ms) "
                f"sub-second={r['sub_second']}")
        _persist_section("overhead", rows, args.quick)

    if want("roofline"):
        from repro_torch.benchmarks.roofline_report import roofline_table
        rows = roofline_table()
        results["roofline"] = rows
        ok = [r for r in rows if r.get("status") == "ok"]
        _csv("roofline/cells_ok", 0.0,
             f"{len(ok)} cells with roofline terms (see EXPERIMENTS.md)")

    os.makedirs("results", exist_ok=True)
    with open("results/torch_benchmarks.json", "w") as f:
        json.dump(results, f, indent=2, default=str)
    print("# wrote results/torch_benchmarks.json", file=sys.stderr)


if __name__ == "__main__":
    main()
