"""Find a cell's knee on the card: the highest rate at which the waiting
queue does not grow through a window.

    python3 bench/sweep.py --workload <cell> --rates 4,4.5,5 [--seconds 20]

One set-up, then each rate in turn: the cell's own traffic at that rate
(its warm-up, a window of ``--seconds``), then the engine drained empty
before the next rate. One JSON line a rate: offered and finished
requests, the waiting queue at the window's open and close (requests due
and not yet prefilled), the end-to-end metrics, and each tenant's
latency quartiles, from which the traffic file's SLOs are set."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def queue_at(rec, t: float) -> int:
    first = {}
    for p in rec.prefills:
        first.setdefault(p[3], p[0])
    return sum(1 for r in rec.requests
               if r["due"] <= t and first.get(r["rid"], float("inf")) > t)


def main() -> int:
    import numpy as np
    import torch

    from bench import harness, stats, traffic

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--slo", type=float, default=None,
                    help="every tenant's SLO (s) for the sweep: one below "
                         "the latency keeps each quota at its cap")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    over = None
    if a.slo is not None:
        t = harness.load_spec(ROOT, a.workload)[3]
        over = {"tenants": [{**x, "slo_s": a.slo} for x in t["tenants"]]}
    s = harness.Setup(ROOT, a.workload, a.seed, device="cuda",
                      traffic_over=over)
    base = dict(s.t)
    for i, rate in enumerate(float(x) for x in a.rates.split(",")):
        s.t = {**base, "rate_per_s": rate, "warmup_s": 8.0,
               "drain_limit_s": 40.0}
        ss = np.random.SeedSequence([a.seed, i])
        reqs = traffic.generate(s.t, a.seconds, ss, s.cfg["vocab_size"])
        rec = harness.open_loop(s, reqs, a.seconds)
        s.eng.drain(max_steps=100_000)
        w0, w1 = rec.window
        e2e, counts = stats.end_to_end(
            rec.requests, w0, w1, rec.t_stop,
            stats.tokens_served(rec.prefills, rec.decodes, w0, w1))
        due = [r for r in rec.requests if w0 <= r["due"] < w1]
        lat = {}
        for k, name in enumerate(s.names):
            v = [stats.latency_s(r, rec.t_stop) for r in due
                 if r["tenant"] == k]
            b = stats.percentile_bands(v)
            lat[name] = {"p25": float(np.percentile(v, 25)), "p50": b["p50"],
                         "p75": float(np.percentile(v, 75)), "p95": b["p95"]}
        dec = rec.in_window(rec.decodes)
        steps = rec.in_window(rec.steps)
        print(json.dumps({
            "rate": rate, **counts, **e2e,
            "queue_open": queue_at(rec, w0), "queue_close": queue_at(rec, w1),
            "finished_per_s": counts["finished_in_window"] / a.seconds,
            "decode_step_ms": 1e3 * sum(d[1] - d[0] for d in dec) / max(len(dec), 1),
            "step_ms": 1e3 * sum(b - a for a, b in steps) / max(len(steps), 1),
            "latency_s": lat}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
