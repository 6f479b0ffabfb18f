"""Scheduler: due time to the start of the request's first prefill,
95th percentile over the requests due in the window's untraced part
(one never prefilled waited until the run stopped)."""
from bench.stats import percentile_bands


def read(rec):
    first = {}
    for t0, _, _, rid, _, _ in rec.prefills:
        first.setdefault(rid, t0)
    a, b = rec.host_window()
    waits = [first.get(r["rid"], rec.t_stop) - r["due"]
             for r in rec.requests if a <= r["due"] < b]
    if not waits:
        return None
    return 1e3 * percentile_bands(waits)["p95"]
