"""Federation demo: run any named scenario from the registry (the JAX
package's ``examples/federation_demo.py`` on the port).

  PYTHONPATH=src python -m repro_torch.examples.federation_demo
  [--scenario NAME] [--nodes N] [--tenants N] [--duration S] [--seed S]
  [--engine scalar|vectorized|batched|torch] [--device cuda|cpu]
  [--placement P] [--policy SP] [--forecaster F] [--quick]
  [--list-scenarios] [--campaign NAME] [--list-campaigns]

``--engine torch`` steps the fleets on the card's fleet kernels (K1-K3);
``--device cpu`` runs it on their plain versions. ``--campaign <name>``
runs a whole named sweep from the campaign registry
(``repro_torch.campaign``) instead of a single scenario and prints
the aggregated CampaignReport table; ``--list-campaigns`` lists the
available campaigns. Single-scenario overrides don't apply to
campaigns — their axes are the campaign spec's grids.

``--policy`` overrides the scenario's scaling-policy sweep with a single
ScalingPolicy (``reactive`` | ``proactive`` | ``hybrid``) and
``--forecaster`` picks the forecaster the proactive/hybrid rounds use
(``last_value`` | ``ewma`` | ``linear_trend`` | ``seasonal_naive``) —
e.g. ``--scenario proactive_game_32 --policy proactive --forecaster
linear_trend``. The priority-policy axis is still the scenario's
``policies`` sweep.

The default scenario is ``paper_game_32`` — 4 Edge nodes × 32 iPokeMon
tenants, all five scaling policies, exactly the hand-wired setup this
demo used to construct itself. Each node runs the paper's
DyverseController (Procedures 1–3); the federation tier places tenants
under the scenario's PlacementPolicy, re-places Procedure-3 evictees
onto siblings, and falls back to the Cloud (WAN latency) as a last
resort. Prints the ScenarioResult table: per-policy federation/node
violation rates (Figs. 4/5), latency/SLO bands (Figs. 6/7), placement
churn, and the per-node mean round overhead — the paper's
sub-second-per-round claim (Fig. 2).
"""
import argparse
import dataclasses

from repro_torch.sim.scenario import SCENARIOS, format_registry, run_scenario


def _apply_overrides(sc, args):
    """CLI knobs override the named scenario's spec (only where given)."""
    if args.nodes is not None:
        sc = dataclasses.replace(
            sc, topology=dataclasses.replace(sc.topology, n_nodes=args.nodes))
    if args.tenants is not None:
        classes = sc.fleet.classes
        if len(classes) != 1:
            raise SystemExit("--tenants only applies to single-class "
                             f"scenarios; {sc.name!r} has {len(classes)}")
        sc = dataclasses.replace(sc, fleet=dataclasses.replace(
            sc.fleet,
            classes=(dataclasses.replace(classes[0], count=args.tenants),)))
    if args.duration is not None:
        sc = dataclasses.replace(
            sc, duration_s=args.duration,
            round_interval=min(sc.round_interval, args.duration))
    if args.seed is not None:
        sc = dataclasses.replace(sc, seed=args.seed)
    if args.engine is not None:
        sc = dataclasses.replace(sc, engine=args.engine)
    if args.placement is not None:
        sc = dataclasses.replace(sc, placement=args.placement)
    if args.policy is not None:
        sc = dataclasses.replace(sc, scaling_policies=(args.policy,))
    if args.forecaster is not None:
        sc = dataclasses.replace(sc, forecaster=args.forecaster)
    return sc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="paper_game_32",
                    choices=sorted(SCENARIOS),
                    help="named scenario from the registry")
    ap.add_argument("--list-scenarios", action="store_true",
                    help="list registry entries and exit")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--tenants", type=int, default=None)
    ap.add_argument("--duration", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--engine", default=None,
                    choices=["scalar", "vectorized", "batched", "torch"],
                    help="execution engine (the numpy trio is bitwise "
                         "identical; batched steps the whole federation "
                         "as one matrix per chunk; torch steps it on the "
                         "card's fleet kernels for mega-scale fleets, "
                         "tolerance-equivalent)")
    ap.add_argument("--placement", default=None,
                    choices=["least_loaded", "locality", "price_aware"])
    ap.add_argument("--policy", default=None,
                    choices=["reactive", "proactive", "hybrid"],
                    help="override the scenario's ScalingPolicy sweep "
                         "with one policy (reactive keeps the paper's "
                         "Procedure 2; proactive scales on the forecast "
                         "before violations land)")
    ap.add_argument("--forecaster", default=None,
                    choices=["last_value", "ewma", "linear_trend",
                             "seasonal_naive"],
                    help="forecaster used by proactive/hybrid scaling")
    ap.add_argument("--quick", action="store_true",
                    help="short-duration smoke variant")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="run under the repro_torch.obs flight recorder and "
                         "write a Chrome-trace/Perfetto trace.json "
                         "(load it at ui.perfetto.dev); results are "
                         "bitwise-identical to an untraced run")
    ap.add_argument("--campaign", default=None,
                    help="run a named campaign sweep (repro_torch.campaign) "
                         "and print its report instead of one scenario")
    ap.add_argument("--list-campaigns", action="store_true",
                    help="list campaign registry entries and exit")
    ap.add_argument("--device", default="cuda",
                    help="where the torch engine (and a campaign's torch "
                         "and serving cells) run: cuda or cpu")
    args = ap.parse_args(argv)

    if args.list_scenarios:
        print(format_registry())
        return
    if args.list_campaigns:
        from repro_torch.campaign import format_campaigns
        print(format_campaigns())
        return
    if args.campaign is not None:
        import time

        from repro_torch.campaign import (build_report, expand_campaign,
                                          get_campaign, on_device,
                                          run_cells)
        spec = get_campaign(args.campaign)
        cells, masked, filtered = expand_campaign(spec, verbose=True)
        cells = on_device(cells, args.device)
        t0 = time.perf_counter()
        records = run_cells(cells, quick=args.quick, workers=2,
                            cell_timeout_s=spec.cell_timeout_s)
        report = build_report(
            spec.name, records, quick=args.quick, masked=masked,
            filtered=filtered,
            campaign_wall_s=time.perf_counter() - t0, workers=2)
        print(report.render())
        if report.gate_failures():
            raise SystemExit(1)
        return

    sc = _apply_overrides(SCENARIOS[args.scenario], args)
    if sc.engine == "torch":
        sc = dataclasses.replace(sc, backend_options={
            **sc.backend_options, "device": args.device})
    if args.trace is not None:
        sc = dataclasses.replace(sc, trace=True)
    res = run_scenario(sc, quick=args.quick)
    print(res.table())
    if args.trace is not None:
        res.write_trace(args.trace)
        n = sum(len(r.events) for r in res.results.values())
        print(f"wrote {args.trace}: {n} flight-recorder events "
              f"(open at ui.perfetto.dev or chrome://tracing)")
    return res


if __name__ == "__main__":
    main()
