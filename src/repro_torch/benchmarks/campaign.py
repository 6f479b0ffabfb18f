"""Campaign CLI: run a named sweep, report, persist, and gate.

  PYTHONPATH=src python -m repro_torch.benchmarks.campaign [--quick] \\
      [--campaign ci] [--workers 2] [--device cuda|cpu] [--list] \\
      [--dry-run] [--vr-tol-pp 0.5] [--wall-ratio 1.75] [--no-gate] \\
      [--artifacts DIR]

One command replaces the per-section smoke steps: it expands the named
campaign (default ``ci`` — every registry scenario across the
vectorized/batched/torch/serving engines and both scaling extremes),
fans the cells out over worker processes, prints the aggregated
report, writes ``BENCH_torchcampaign.json`` (the shared
:mod:`repro_torch.campaign.benchio` schema; written in quick mode too — the
CI artifact), and exits non-zero when the gate fails: any
failed/timed-out cell, non-finite VR, request-conservation violation,
engine/control-plane consistency disagreement, or VR/wall regression
beyond tolerance against the previous campaign report and the
per-section ``BENCH_torch*.json`` trajectories. The gate also re-measures
the paper's overhead-per-server curve (1→32 simulated Edge servers,
quick-sized) and fails on a non-finite value, a broken sub-second
claim, or a >2x per-round regression vs ``BENCH_torchoverhead.json``.
``--device`` (default ``cuda``) is where the torch and serving cells
run: it is set on each such cell's scenario, not added as a cell axis,
so cell ids are the reference's with ``jax`` → ``torch``. Without a
card a ``cuda`` cell fails (an ``error`` record); it never falls back
to the CPU.
With ``--artifacts DIR`` every cell runs under the repro_torch.obs flight
recorder and failed/diverged cells keep a per-cell Chrome-trace
``trace.json`` there for upload.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="run an evaluation campaign and gate on regressions")
    ap.add_argument("--campaign", default="ci",
                    help="campaign name (see --list); default: ci")
    ap.add_argument("--quick", action="store_true",
                    help="smoke-sized cells (CI gate); serving cells "
                         "always run full-size")
    ap.add_argument("--workers", type=int, default=2,
                    help="worker processes (<=0 runs cells inline); "
                         "default 2")
    ap.add_argument("--device", default="cuda",
                    help="device of the torch and serving cells "
                         "(default: cuda; cpu runs the kernels' plain "
                         "versions)")
    ap.add_argument("--root", default=".",
                    help="directory holding the BENCH_torch*.json baselines")
    ap.add_argument("--list", action="store_true",
                    help="list campaigns and exit")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the expanded cells (and what was "
                         "masked) without running anything")
    ap.add_argument("--vr-tol-pp", type=float, default=None,
                    help="VR regression tolerance in percentage points "
                         "(default 0.5)")
    ap.add_argument("--wall-ratio", type=float, default=None,
                    help="wall-clock regression ratio (default 1.75)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-cell timeout in seconds (default: the "
                         "campaign spec's cell_timeout_s)")
    ap.add_argument("--no-gate", action="store_true",
                    help="report + persist but always exit 0")
    ap.add_argument("--artifacts", default=None, metavar="DIR",
                    help="trace every cell (repro_torch.obs flight recorder) "
                         "and write a per-cell Chrome-trace trace.json "
                         "under DIR; after gating, traces of passing "
                         "cells are pruned so only failed/diverged "
                         "cells keep theirs")
    args = ap.parse_args(argv)

    from repro_torch.campaign import (Tolerances, build_report, diff_report,
                                      expand_campaign, format_campaigns,
                                      get_campaign, load_section,
                                      on_device, run_cells, write_bench)

    if args.list:
        print(format_campaigns())
        return 0

    spec = get_campaign(args.campaign)
    cells, masked, filtered = expand_campaign(spec, verbose=True)
    cells = on_device(cells, args.device)
    print(f"# campaign {spec.name!r}: {len(cells)} cells "
          f"({len(masked)} masked, {filtered} filtered)", file=sys.stderr)
    if args.dry_run:
        for cell in cells:
            print(cell.cell_id)
        for cell_id, why in masked:
            print(f"# masked {cell_id}: {why}")
        return 0

    done = [0]

    def progress(rec: dict) -> None:
        done[0] += 1
        vr = rec.get("violation_rate")
        tail = (f"VR={vr:.4f}" if vr is not None
                else rec.get("error", ""))
        print(f"# [{done[0]}/{len(cells)}] {rec['cell']}: "
              f"{rec['status']} {tail}", file=sys.stderr)

    t0 = time.perf_counter()
    records = run_cells(
        cells, quick=args.quick, workers=args.workers,
        cell_timeout_s=(args.timeout if args.timeout is not None
                        else spec.cell_timeout_s),
        progress=progress, artifacts_dir=args.artifacts)
    report = build_report(
        spec.name, records, quick=args.quick, masked=masked,
        filtered=filtered, campaign_wall_s=time.perf_counter() - t0,
        workers=args.workers)

    # diff against the PREVIOUS campaign payload before overwriting it
    tol_kw = {}
    if args.vr_tol_pp is not None:
        tol_kw["vr_pp"] = args.vr_tol_pp
    if args.wall_ratio is not None:
        tol_kw["wall_ratio"] = args.wall_ratio
    prev = load_section("campaign", args.root)
    diff = diff_report(report, root=args.root, prev=prev,
                       tol=Tolerances(**tol_kw))

    payload_extra = {k: v for k, v in report.payload().items()
                     if k != "rows"}
    write_bench("campaign", report.records, root=args.root,
                **payload_extra)

    print(report.render())
    print()
    print(diff.render())

    # overhead-per-server gate: re-measure the paper's 1→32-server
    # curve (quick-sized) and fail on a non-finite value, a broken
    # sub-second claim, or a >2x per-round regression against the
    # BENCH_torchoverhead.json baseline, where there is one
    overhead_failures: list[str] = []
    try:
        from repro_torch.benchmarks.federation_bench import overhead_sweep
        orows = overhead_sweep(quick=True)
    except AssertionError as e:
        overhead_failures.append(str(e))
        orows = []
    base = load_section("overhead", args.root)
    if base and orows:
        by_servers = {r.get("servers"): r for r in base["rows"]}
        for r in orows:
            old = (by_servers.get(r["servers"]) or {}) \
                .get("round_overhead_s")
            new = r["round_overhead_s"]
            # sub-200us rounds are timing noise, not a trend
            if old and old >= 2e-4 and new > 2.0 * old:
                overhead_failures.append(
                    f"overhead/{r['servers']}srv: round overhead "
                    f"{old * 1e3:.3f}ms -> {new * 1e3:.3f}ms (> 2.0x)")
    for f in overhead_failures:
        print(f"# OVERHEAD GATE: {f}", file=sys.stderr)

    failures = report.gate_failures()

    if args.artifacts:
        # keep trace.json only for cells implicated in a gate failure
        # or regression — CI uploads the directory as-is
        import shutil

        from repro_torch.campaign import artifact_dir_for
        bad = {r["cell"] for r in report.failed}
        bad |= {f.removeprefix("cell ").split(":", 1)[0].strip()
                for f in failures}
        bad |= {r.split(":", 1)[0] for r in diff.regressions}
        kept = 0
        for rec in report.records:
            cell_dir = artifact_dir_for(rec["cell"], args.artifacts)
            if rec["cell"] in bad:
                kept += 1
            else:
                shutil.rmtree(cell_dir, ignore_errors=True)
        print(f"# kept trace artifacts for {kept} failed/diverged "
              f"cells under {args.artifacts}", file=sys.stderr)

    gate_bad = bool(failures or diff.regressions or overhead_failures)
    if gate_bad:
        print(f"\nCAMPAIGN GATE FAILED: {len(failures)} report "
              f"failures, {len(diff.regressions)} regressions, "
              f"{len(overhead_failures)} overhead regressions",
              file=sys.stderr)
    if args.no_gate:
        return 0
    return 1 if gate_bad else 0


if __name__ == "__main__":
    sys.exit(main())
