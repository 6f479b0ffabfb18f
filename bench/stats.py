"""Window statistics of the benchmark: percentiles and the end-to-end
metrics from per-request records.

:func:`percentile_bands` is a copy of ``repro_torch.obs.metrics.
percentile_bands`` (linear interpolation over the raw sample, which
every percentile here uses), so that the yardstick does not move with
the program."""
from __future__ import annotations

import numpy as np


def percentile_bands(values) -> dict[str, float]:
    """The p50/p95/p99 band summary of a sample, with its count."""
    a = np.asarray(values, dtype=np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)),
            "n": float(a.size)}


def ttft_s(r: dict, t_stop: float) -> float:
    """First token minus due time; a request with no first token (the
    Cloud's, or one that never got one) waited until ``t_stop`` and
    missed every limit."""
    if r["first"] is None or r["cloud"]:
        return max(t_stop - r["due"], 0.0)
    return r["first"] - r["due"]


def tpot_s(r: dict, t_stop: float) -> float:
    """(finish − first token) / (generated − 1); an unfinished request,
    or one with no first token, counts its whole wait until ``t_stop``."""
    if r["finish"] is None or r["first"] is None or r["cloud"]:
        return max(t_stop - r["due"], 0.0)
    return (r["finish"] - r["first"]) / max(r["generated"] - 1, 1)


def latency_s(r: dict, t_stop: float) -> float:
    """Whole latency from due time; unfinished requests waited until
    ``t_stop``. A Cloud-serviced request counts by its own finish, which
    carries the engine's WAN penalty."""
    if r["finish"] is None:
        return max(t_stop - r["due"], 0.0)
    return r["finish"] - r["due"]


def tokens_served(prefills, decodes, w0: float, w1: float) -> int:
    """Tokens the engine served inside [w0, w1): the prompt tokens of
    fresh prefills (each also yields its first token) and one token per
    row of each decode step; a resumed request's re-prefill is work
    done again and is not counted. Spans are counted by their start."""
    fresh = [p for p in prefills if w0 <= p[0] < w1 and not p[5]]
    rows = sum(len(d[3]) for d in decodes if w0 <= d[0] < w1)
    return sum(p[4] + 1 for p in fresh) + rows


def end_to_end(reqs: list[dict], w0: float, w1: float, t_stop: float,
               tokens: int) -> tuple[dict, dict]:
    """The end-to-end metrics of one run and their sample counts.
    ``reqs``: every request offered, each with ``due``, ``first``,
    ``finish``, ``generated``, ``prompt``, ``slo``, ``cloud`` (seconds on
    one clock); the window is [w0, w1), the run stopped waiting at
    ``t_stop``, and the engine served ``tokens`` in the window."""
    due = [r for r in reqs if w0 <= r["due"] < w1]
    done = [r for r in reqs if r["finish"] is not None and not r["cloud"]
            and w0 <= r["finish"] < w1]
    ttft = [ttft_s(r, t_stop) for r in due]
    tpot = [tpot_s(r, t_stop) for r in due]
    met = [latency_s(r, t_stop) <= r["slo"] for r in due]
    metrics = {"tokens_per_s": tokens / (w1 - w0),
               "slo_attainment": sum(met) / len(met)}
    # medians are the cells' metrics; the higher percentiles are printed
    # beside them (at 48 s their spread between runs is 8-70 %, PERF.md)
    for name, v in (("ttft", ttft), ("tpot", tpot)):
        for q in (50, 75, 90, 95, 99):
            metrics[f"{name}_p{q}_ms"] = 1e3 * float(np.percentile(v, q))
    counts = {"due_in_window": len(due), "finished_in_window": len(done),
              "unfinished": sum(r["finish"] is None for r in due),
              "cloud": sum(bool(r["cloud"]) for r in due)}
    return metrics, counts
