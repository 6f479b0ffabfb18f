"""Federation benchmarks: engine trio speedup + multi-node policy sweep
+ fleet-scale (≥1M tenant-second) batched-engine sweep
+ mega-scale torch-vs-batched sweep (``scale``, BENCH_torchscale.json)
+ control-plane-bound tenants × round_interval sweep (``ctrlscale``)
+ named-scenario walls (``scenarios``)
+ reactive vs proactive vs hybrid scaling sweep (``forecast``,
  BENCH_torchforecast.json).

``engine_speedup`` measures all three execution engines on the paper's
32-tenant / 1200 s scenario (identical seeded trace, so the comparison
is pure execution-engine overhead). ``federation_sweep`` runs a 4-node
federation across all five policies and reports per-node round overhead
(the paper's sub-second claim, Fig. 2) plus federation-level violation
rates and placement churn. ``fleet_scale_sweep`` pushes 4-node
federations to ≥1M tenant-seconds and records batched-vs-vectorized
throughput; walls are min-of-``repeats`` because shared-host timing
noise here swings single runs several-fold. ``scenario_walls`` times
every entry of the declarative scenario registry
(:data:`repro_torch.sim.scenario.SCENARIOS`), so scenario-level perf joins
the fedscale/ctrlscale trajectory (BENCH_torchscenarios.json).

Federation experiments are constructed through the declarative
:class:`~repro_torch.sim.scenario.Scenario` API; a default least-loaded spec
compiles to exactly the hand-wired ``FederationConfig`` these benches
used before, so the numbers stay comparable across the refactor.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np

from repro_torch.sim import EdgeNodeSim, SimConfig, paper_capacity_units
from repro_torch.sim.federation import EdgeFederation
from repro_torch.sim.scenario import (FleetSpec, Scenario, TenantClassSpec,
                                      TopologySpec, run_scenario)
from repro_torch.sim.workload import (StreamWorkload, make_game_fleet,
                                      make_stream_fleet)


def _sim(engine: str, tenants: int, duration: int, seed: int) -> EdgeNodeSim:
    rng = np.random.default_rng(42)
    cfg = SimConfig(policy="sdps", duration_s=duration, round_interval=300,
                    capacity_units=paper_capacity_units(tenants), seed=seed,
                    engine=engine)
    return EdgeNodeSim(make_game_fleet(tenants, rng), cfg)


def engine_speedup(tenants: int = 32, duration: int = 1200,
                   seed: int = 7, repeats: int = 2) -> dict:
    """Engine-trio wall clock on the identical seeded trace (min of
    ``repeats`` — this host's timing noise swings single runs)."""
    walls, results = {}, {}
    for engine in ("scalar", "vectorized", "batched"):
        trials = []
        for _ in range(max(repeats, 1)):
            t0 = time.perf_counter()
            results[engine] = _sim(engine, tenants, duration, seed).run()
            trials.append(time.perf_counter() - t0)
        walls[engine] = min(trials)
    steps = duration * tenants          # tenant-seconds simulated
    rs, rv, rb = (results[e] for e in ("scalar", "vectorized", "batched"))
    identical = bool(
        rs.violation_rate == rv.violation_rate == rb.violation_rate
        and rs.per_minute_vr == rv.per_minute_vr == rb.per_minute_vr
        and rs.terminated == rv.terminated == rb.terminated)
    return {
        "tenants": tenants,
        "duration_s": duration,
        "scalar_wall_s": walls["scalar"],
        "vector_wall_s": walls["vectorized"],
        "batched_wall_s": walls["batched"],
        "scalar_steps_per_s": steps / walls["scalar"],
        "vector_steps_per_s": steps / walls["vectorized"],
        "batched_steps_per_s": steps / walls["batched"],
        "speedup": walls["scalar"] / walls["vectorized"],
        "batched_speedup_vs_scalar": walls["scalar"] / walls["batched"],
        "batched_speedup_vs_vectorized": (walls["vectorized"]
                                          / walls["batched"]),
        "bitwise_identical": identical,
    }


def federation_sweep(n_nodes: int = 4, tenants: int = 32,
                     duration: int = 1200, seed: int = 7) -> list[dict]:
    sc = Scenario(
        name="fed_sweep",
        fleet=FleetSpec(classes=(TenantClassSpec("game", tenants),)),
        topology=TopologySpec(n_nodes=n_nodes, headroom=16),
        duration_s=duration, round_interval=300, seed=seed,
        engine="vectorized")
    res = run_scenario(sc)
    return [{
        "policy": policy,
        "n_nodes": n_nodes,
        "tenants": tenants,
        "violation_rate": oc.violation_rate,
        "per_node_vr": oc.per_node_vr,
        "per_node_round_overhead_s": oc.mean_round_overhead_s,
        "max_round_overhead_s": oc.max_round_overhead_s,
        "replaced": oc.replaced,
        "cloud": oc.cloud,
        "wall_s": oc.wall_s,
    } for policy, oc in res.outcomes.items()]


# ---------------------------------------------------------------- fleet scale
def _fleet_fed(workload: str, n_nodes: int, per_node: int, duration: int,
               round_interval: int, policy: str, engine: str,
               seed: int = 7, backend_options: dict | None = None
               ) -> EdgeFederation:
    kind = "stream" if workload == "stream" else "game"
    sc = Scenario(
        name=f"fleet_{workload}",
        fleet=FleetSpec(classes=(
            TenantClassSpec(kind, n_nodes * per_node),)),
        topology=TopologySpec(n_nodes=n_nodes, headroom=16),
        duration_s=duration, round_interval=round_interval, seed=seed,
        engine=engine, backend_options=dict(backend_options or {}))
    # built here, timed by the caller: construction (placement draws)
    # stays outside the measured run() wall, as it always has
    return EdgeFederation(sc.fleet.build(), sc.federation_config(policy))


def _federation_results_identical(a, b) -> bool:
    return bool(
        a.violation_rate == b.violation_rate
        and a.per_node_vr == b.per_node_vr
        and a.total_requests == b.total_requests
        and a.replaced == b.replaced and a.cloud == b.cloud
        and all(np.array_equal(a.node_results[n].latencies,
                               b.node_results[n].latencies)
                and a.node_results[n].per_minute_vr
                == b.node_results[n].per_minute_vr
                for n in a.node_results))


def fleet_scale_sweep(quick: bool = False, repeats: int = 2) -> list[dict]:
    """Batched vs vectorized on 4-node federations swept to ≥1M
    tenant-seconds (32 tenants per node — the paper's per-node fleet).

    The fleets and policies come from the campaign registry's
    ``ENGINE_GRID`` (``ENGINE_GRID_QUICK`` for the CI smoke) — the
    same cells ``repro_torch.benchmarks.campaign`` fans out — paired up here so
    each row keeps the engine-vs-engine schema of the BENCH_torchfedscale
    trajectory. ``policy="none"`` rows isolate pure engine throughput
    (no Procedure-1 rounds); ``sdps`` rows include the controller cost
    both engines share, which compresses the engine gap. Each row
    cross-checks that both engines produced the bitwise-identical
    FederationResult; in quick mode (the CI smoke) a mismatch raises
    instead of just being recorded, so fleet-scale engine regressions
    fail the build.
    """
    from repro_torch.campaign.registry import ENGINE_GRID, ENGINE_GRID_QUICK
    from repro_torch.campaign.spec import expand_grid

    if quick:
        repeats = 1
    cells, _ = expand_grid(ENGINE_GRID_QUICK if quick else ENGINE_GRID)
    pairs: dict = {}
    for cell in cells:
        pairs.setdefault((cell.scenario.name, cell.policy),
                         {})[cell.engine] = cell
    rows = []
    for (_, policy), by_engine in pairs.items():
        sc = next(iter(by_engine.values())).scenario
        ts = sc.fleet.size * sc.duration_s
        row = {
            "workload": sc.fleet.classes[0].kind,
            "n_nodes": sc.topology.n_nodes,
            "tenants_per_node": sc.fleet.size // sc.topology.n_nodes,
            "duration_s": sc.duration_s,
            "round_interval": sc.round_interval, "policy": policy,
            "tenant_seconds": ts,
        }
        results = {}
        for engine in ("vectorized", "batched"):
            csc = by_engine[engine].scenario_with_axes()
            walls = []
            for _ in range(max(repeats, 1)):
                # built here, timed below: construction (placement
                # draws) stays outside the measured run() wall
                fed = EdgeFederation(csc.fleet.build(),
                                     csc.federation_config(policy))
                t0 = time.perf_counter()
                results[engine] = fed.run()
                walls.append(time.perf_counter() - t0)
            row[f"{engine}_wall_s"] = min(walls)
            row[f"{engine}_ts_per_s"] = ts / min(walls)
        row["speedup_batched_vs_vectorized"] = (
            row["vectorized_wall_s"] / row["batched_wall_s"])
        row["bitwise_identical"] = _federation_results_identical(
            results["vectorized"], results["batched"])
        if quick and not row["bitwise_identical"]:
            raise AssertionError(
                f"engine divergence on {row}: batched != vectorized")
        rows.append(row)
    return rows


def torch_scale_sweep(quick: bool = False, repeats: int = 3,
                      vr_tol: float = 0.02, device: str = "cuda"
                      ) -> list[dict]:
    """``scale``: the torch engine (its CUDA kernels on ``device``) vs
    the batched numpy engine on stream-fleet federations swept to
    mega-scale (10^5 tenants, tens of millions of tenant-seconds).

    The torch engine's contract is statistical (counter-based float32
    draws — see repro_torch/sim/engines/torch_backend.py), so instead
    of the fedscale bitwise cross-check every row asserts |ΔVR| ≤
    ``vr_tol`` and finite VRs — in BOTH quick (CI smoke) and full mode,
    so an engine divergence fails the build rather than persisting bad
    rows. Walls are min-of-``repeats``; EdgeFederation construction
    (placement and admission of the fleet) stays outside the measured
    wall, as in fedscale. ``device="cuda"`` without a card raises.
    """
    if quick:
        configs = [("stream", 2, 16, 240, 120)]
        policies: tuple[str, ...] = ("none",)
        repeats = 1
    else:
        configs = [
            # 10^4 tenants × 480 s = 4.8M tenant-seconds
            ("stream", 4, 2500, 480, 240),
            # 10^5 tenants × 240 s = 24M tenant-seconds, policy="none"
            # isolating the engines
            ("stream", 4, 25000, 240, 120),
        ]
        policies = ("none", "sdps")
    options = {"batched": {}, "torch": {"device": device}}
    rows = []
    for workload, n_nodes, per_node, duration, ri in configs:
        ts = n_nodes * per_node * duration
        for policy in policies:
            row = {
                "workload": workload, "n_nodes": n_nodes,
                "tenants_per_node": per_node, "duration_s": duration,
                "round_interval": ri, "policy": policy,
                "tenant_seconds": ts,
                "device": device,
                "torch_dtype": "float32",
            }
            results = {}
            for engine in ("batched", "torch"):
                walls = []
                for _ in range(max(repeats, 1)):
                    fed = _fleet_fed(workload, n_nodes, per_node,
                                     duration, ri, policy, engine,
                                     backend_options=options[engine])
                    gc.collect()   # keep collector pauses off the wall
                    t0 = time.perf_counter()
                    results[engine] = fed.run()
                    walls.append(time.perf_counter() - t0)
                row[f"{engine}_wall_s"] = min(walls)
                row[f"{engine}_ts_per_s"] = ts / min(walls)
            vb = results["batched"].violation_rate
            vt = results["torch"].violation_rate
            if not (math.isfinite(vb) and math.isfinite(vt)):
                raise AssertionError(
                    f"scale non-finite VR on {row}: "
                    f"batched={vb} torch={vt}")
            if abs(vb - vt) > vr_tol:
                raise AssertionError(
                    f"scale VR divergence on {row}: "
                    f"batched={vb:.4f} torch={vt:.4f} (tol {vr_tol})")
            row["batched_vr"] = vb
            row["torch_vr"] = vt
            row["vr_delta"] = vt - vb
            row["speedup_torch_vs_batched"] = (row["batched_wall_s"]
                                               / row["torch_wall_s"])
            rows.append(row)
    return rows


# ------------------------------------------------------------- control plane
def _ctrl_fleet(kind: str, n: int):
    """Three control-plane regimes (fleet, capacity_units, slo_scale):

    * ``idle`` — a dense mostly-idle fleet (0 fps): every round is pure
      control-plane bookkeeping, the EdgeOS-style dense-cheap-node
      regime where per-tenant management cost is the whole story;
    * ``steady`` — every tenant pushes exactly 1 frame/s and sits in the
      (0.8·SLO, SLO] hold band (low jitter, ample capacity), so rounds
      classify the whole fleet but change nothing;
    * ``churn`` — the paper's heterogeneous stream fleet at paper
      capacity: sustained scale-up/scale-down/eviction traffic.
    """
    if kind == "churn":
        return (make_stream_fleet(n, np.random.default_rng(42)),
                paper_capacity_units(n), 1.0)
    fps = 1.0 if kind == "steady" else 0.0
    fleet = [StreamWorkload(name=f"fd-{i}", base_latency=2.13,
                            work_per_request=4.0, unit_rate=0.35,
                            fps=fps, jitter_sigma=0.02)
             for i in range(n)]
    return fleet, n * 17, 0.8 if kind == "steady" else 1.0


def _ctrl_sim(kind: str, n: int, duration: int, ri: int,
              control_plane: str) -> EdgeNodeSim:
    fleet, cap, slo = _ctrl_fleet(kind, n)
    cfg = SimConfig(policy="sdps", duration_s=duration, round_interval=ri,
                    capacity_units=cap, default_units=16, slo_scale=slo,
                    donation_fraction=0.0, seed=7, engine="batched",
                    control_plane=control_plane)
    return EdgeNodeSim(fleet, cfg)


def _ctrl_results_identical(a, b, sa, sb) -> bool:
    return bool(
        a.violation_rate == b.violation_rate
        and a.per_minute_vr == b.per_minute_vr
        and a.terminated == b.terminated
        and a.total_requests == b.total_requests
        and np.array_equal(a.latencies, b.latencies)
        and sa.ctrl.snapshot() == sb.ctrl.snapshot())


def control_plane_scale(quick: bool = False, repeats: int = 5) -> list[dict]:
    """``ctrlscale``: rounds/s of the array-native control plane vs the
    retained reference (pre-array) path, on control-plane-bound
    scenarios — large tenant counts at fine ``round_interval``, where
    Procedure-1 rounds and the Monitor feed dominate the wall clock.

    Every row cross-checks that both control planes produce the bitwise
    identical SimResult and controller snapshot; in quick mode (the CI
    smoke) a mismatch raises, so control-plane divergence fails the
    build.
    """
    if quick:
        configs = [("churn", 64, 40, 1), ("steady", 64, 40, 1)]
        repeats = 1
    else:
        configs = [
            ("idle", 256, 120, 1),
            ("idle", 512, 120, 1),
            ("steady", 512, 120, 1),
            ("churn", 512, 120, 1),
            ("churn", 512, 300, 5),
        ]
    rows = []
    for kind, n, duration, ri in configs:
        row = {"scenario": kind, "tenants": n, "duration_s": duration,
               "round_interval": ri}
        results, sims = {}, {}
        for cp in ("reference", "array"):
            walls = []
            for _ in range(max(repeats, 1)):
                sim = _ctrl_sim(kind, n, duration, ri, cp)
                t0 = time.perf_counter()
                results[cp] = sim.run()
                walls.append(time.perf_counter() - t0)
                sims[cp] = sim
            row[f"{cp}_wall_s"] = min(walls)
            row["rounds"] = sims[cp].ctrl.rounds_run
            row[f"{cp}_rounds_per_s"] = sims[cp].ctrl.rounds_run / min(walls)
        row["speedup"] = row["reference_wall_s"] / row["array_wall_s"]
        row["bitwise_identical"] = _ctrl_results_identical(
            results["reference"], results["array"],
            sims["reference"], sims["array"])
        if quick and not row["bitwise_identical"]:
            raise AssertionError(
                f"control-plane divergence on {row}: array != reference")
        rows.append(row)
    return rows


# ------------------------------------------------------------- forecast
def _nonviolated_latency_s(fed_result) -> float:
    """Mean latency of the requests that met their SLO, over the whole
    federation's user-visible distribution — the quality-of-service
    companion to VR: a policy could trivially cut VR by hurting the
    latency of everything that still complies."""
    lats, slos = [], []
    for r in fed_result.node_results.values():
        if r.latencies.size:
            lats.append(r.latencies)
            slos.append(r.slos)
    if not lats:
        return 0.0
    lat = np.concatenate(lats)
    ok = lat <= np.concatenate(slos)
    return float(lat[ok].mean()) if ok.any() else 0.0


def forecast_sweep(quick: bool = False, repeats: int = 3,
                   device: str = "cuda") -> list[dict]:
    """``forecast``: reactive vs proactive vs hybrid scaling at an equal
    resource budget (same fleet, same topology, same seed) on the two
    proactive registry scenarios. Per row: federation VR, the VR delta
    vs that scenario's reactive baseline (negative = fewer violations),
    mean non-violated latency, forecast overhead, and min-of-``repeats``
    walls. Raises on any non-finite VR — in the CI ``--quick`` smoke a
    broken forecast path fails the build instead of persisting NaN.
    ``device`` is that of any torch or serving cell."""
    from repro_torch.campaign.registry import FORECAST_GRID
    from repro_torch.campaign.spec import expand_grid, on_device

    if quick:
        repeats = 1
    rows = []
    base_vr: dict[str, float] = {}      # per-scenario reactive baseline
    cells = on_device(expand_grid(FORECAST_GRID)[0], device)
    for cell in cells:
        name, spol = cell.scenario.name, cell.scaling_policy
        sc = cell.scenario_with_axes()
        walls, res = [], None
        for _ in range(max(repeats, 1)):
            t0 = time.perf_counter()
            res = run_scenario(sc, policies=(cell.policy,),
                               scaling_policies=(spol,), quick=quick)
            walls.append(time.perf_counter() - t0)
        oc = res.outcomes[cell.policy]
        if not math.isfinite(oc.violation_rate):
            raise AssertionError(
                f"{name}/{spol}: non-finite VR {oc.violation_rate}")
        if spol == "reactive":
            base_vr[name] = oc.violation_rate
        fr = res.results[cell.policy]
        fc_walls = [w for r in fr.node_results.values()
                    for w in r.overhead_forecast_s]
        rows.append({
            "scenario": name,
            "scaling_policy": spol,
            "forecaster": sc.forecaster,
            "tenants": res.scenario.fleet.size,
            "n_nodes": res.scenario.topology.n_nodes,
            "duration_s": res.scenario.duration_s,
            "round_interval": res.scenario.round_interval,
            "violation_rate": oc.violation_rate,
            "vr_delta_vs_reactive": (oc.violation_rate - base_vr[name]
                                     if name in base_vr else 0.0),
            "nonviolated_latency_s": _nonviolated_latency_s(fr),
            "mean_forecast_overhead_s": (sum(fc_walls) / len(fc_walls)
                                         if fc_walls else 0.0),
            "max_round_overhead_s": oc.max_round_overhead_s,
            "replaced": oc.replaced,
            "cloud": oc.cloud,
            "wall_s": min(walls),
        })
    return rows


# ------------------------------------------------------------- scenarios
def scenario_walls(quick: bool = False, repeats: int = 3,
                   device: str = "cuda") -> list[dict]:
    """``scenarios``: min-of-``repeats`` wall clock for every named
    scenario in the declarative registry (primary policy only), so
    scenario-level performance joins the fedscale/ctrlscale trajectory.
    Walls include EdgeFederation construction — placement is part of
    what a scenario runs. Raises on any non-finite violation rate, so
    a broken registry entry fails the build instead of persisting NaN.
    The serving scenarios run on ``device``.
    """
    from repro_torch.campaign.registry import SCENARIO_WALLS_GRID
    from repro_torch.campaign.spec import expand_grid, on_device

    if quick:
        repeats = 1
    rows = []
    cells = on_device(expand_grid(SCENARIO_WALLS_GRID)[0], device)
    for cell in cells:
        name, sc = cell.scenario.name, cell.scenario_with_axes()
        walls, res = [], None
        for _ in range(max(repeats, 1)):
            t0 = time.perf_counter()
            # one scaling policy per wall (the grid pins reactive) so
            # sweep scenarios stay one comparable row; the forecast
            # section owns the reactive-vs-proactive comparison
            res = run_scenario(sc, policies=(cell.policy,),
                               scaling_policies=(cell.scaling_policy,),
                               quick=quick)
            walls.append(time.perf_counter() - t0)
        oc = res.outcomes[cell.policy]
        if not math.isfinite(oc.violation_rate):
            raise AssertionError(
                f"scenario {name}: non-finite VR {oc.violation_rate}")
        run_sc = res.scenario           # the quick() variant when quick
        rows.append({
            "scenario": name,
            "policy": cell.policy,
            "n_nodes": run_sc.topology.n_nodes,
            "tenants": run_sc.fleet.size,
            "duration_s": run_sc.duration_s,
            "tenant_seconds": run_sc.fleet.size * run_sc.duration_s,
            "placement": run_sc.placement,
            "violation_rate": oc.violation_rate,
            "replaced": oc.replaced,
            "cloud": oc.cloud,
            "max_round_overhead_s": oc.max_round_overhead_s,
            "wall_s": min(walls),
        })
    return rows


# ------------------------------------------------------------ resilience
# one source of truth for the chaos list: the campaign registry
from repro_torch.campaign.registry import CHAOS_SCENARIOS  # noqa: E402,F401


def resilience_sweep(quick: bool = False, repeats: int = 2,
                     device: str = "cuda") -> list[dict]:
    """``resilience``: the four chaos scenarios (node flapping, mid-run
    capacity degradation, WAN latency storm, serving timeout/retry with
    load shedding) under every policy they declare, reporting VR, the
    VR delta vs that scenario's ``none`` baseline (negative = dynamic
    scaling absorbs the fault), recovery re-placements, Cloud fallbacks
    and shed counts. Raises on a non-finite VR or a request-conservation
    violation, so a broken fault path fails the CI ``--quick`` smoke
    instead of persisting garbage (BENCH_torchresilience.json). The
    serving scenario runs on ``device``."""
    from repro_torch.campaign.registry import RESILIENCE_GRID
    from repro_torch.campaign.spec import expand_grid, on_device

    if quick:
        repeats = 1
    rows = []
    base_vr: dict[str, float] = {}      # per-scenario `none` baseline
    cells = on_device(expand_grid(RESILIENCE_GRID)[0], device)
    for cell in cells:
        name, pol = cell.scenario.name, cell.policy
        sc = cell.scenario_with_axes()
        walls, res = [], None
        for _ in range(max(repeats, 1)):
            t0 = time.perf_counter()
            res = run_scenario(sc, policies=(pol,),
                               scaling_policies=(cell.scaling_policy,),
                               quick=quick)
            walls.append(time.perf_counter() - t0)
        oc = res.outcomes[pol]
        if not math.isfinite(oc.violation_rate):
            raise AssertionError(
                f"{name}/{pol}: non-finite VR {oc.violation_rate}")
        if oc.requests_conserved is False:
            raise AssertionError(
                f"{name}/{pol}: request conservation violated")
        if pol == "none":
            base_vr[name] = oc.violation_rate
        fr = res.results[pol]
        rows.append({
            "scenario": name,
            "engine": sc.engine,
            "policy": pol,
            "n_nodes": res.scenario.topology.n_nodes,
            "tenants": res.scenario.fleet.size,
            "duration_s": res.scenario.duration_s,
            "violation_rate": oc.violation_rate,
            "vr_delta_vs_none": (oc.violation_rate - base_vr[name]
                                 if name in base_vr else 0.0),
            "nonviolated_latency_s": _nonviolated_latency_s(fr),
            "failed_nodes": len(fr.failed_nodes),
            "recovered_nodes": len(fr.recovered_nodes),
            "recovered_tenants": oc.recovered,
            "replaced": oc.replaced,
            "cloud": oc.cloud,
            "shed": oc.shed,
            "requests_conserved": oc.requests_conserved,
            "wall_s": min(walls),
        })
    return rows


# ------------------------------------------------------------------ overhead
def overhead_sweep(quick: bool = False, repeats: int = 3) -> list[dict]:
    """``overhead``: the paper's overhead-vs-number-of-Edge-servers
    curve (Fig. 2 / the §5 headline "sub-second overhead per Edge
    server when 32 Edge servers are deployed on a single Edge node").

    1→32 simulated Edge servers (tenants) run on ONE vectorized node
    with a :class:`repro_torch.obs.FlightRecorder` attached, so the
    per-round walls come from the recorder's full phase pipeline —
    monitor feed, forecast, priority scoring, classification, eviction
    cascade, actuation — not just the three coarse overhead lists.
    ``per_server_overhead_s`` is (monitoring + priority + forecast +
    scaling) / servers; the run raises on a non-finite value and each
    row carries the paper's ``sub_second`` verdict, so the CI quick
    gate fails if the analogue claim ever breaks
    (BENCH_torchoverhead.json)."""
    from repro_torch.obs import FlightRecorder

    if quick:
        repeats = 1
    duration, ri = (240, 60) if quick else (1200, 300)
    rows = []
    for n in (1, 2, 4, 8, 16, 32):
        best = None
        for _ in range(max(repeats, 1)):
            rec = FlightRecorder()
            cfg = SimConfig(
                policy="sdps", duration_s=duration, round_interval=ri,
                capacity_units=paper_capacity_units(n, headroom=16),
                seed=7, engine="vectorized", recorder=rec)
            res = EdgeNodeSim(
                make_game_fleet(n, np.random.default_rng(42)), cfg).run()
            ph = res.overhead_phases

            def mean(k: str) -> float:
                v = ph.get(k, [])
                return float(np.mean(v)) if v else 0.0

            monitoring = mean("monitor_feed")
            scaling = mean("scaling")       # classification+eviction+
            #                                 actuation live inside it
            total = monitoring + mean("priority") + mean("forecast") \
                + scaling
            if best is None or total < best["round_overhead_s"]:
                best = {
                    "servers": n,
                    "rounds": len(ph.get("scaling", [])),
                    "monitoring_s": monitoring,
                    "priority_s": mean("priority"),
                    "forecast_s": mean("forecast"),
                    "scaling_s": scaling,
                    "classification_s": mean("classification"),
                    "eviction_s": mean("eviction"),
                    "actuation_s": mean("actuation"),
                    "round_overhead_s": total,
                    "per_server_overhead_s": total / n,
                    "sub_second": bool(total / n < 1.0),
                }
        if not math.isfinite(best["per_server_overhead_s"]):
            raise AssertionError(
                f"overhead sweep: non-finite per-server overhead at "
                f"{n} servers")
        rows.append(best)
    if not rows[-1]["sub_second"]:
        raise AssertionError(
            f"paper claim violated: {rows[-1]['per_server_overhead_s']:.3f}"
            f"s per server at 32 servers (must be sub-second)")
    return rows
