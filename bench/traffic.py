"""The one traffic generator: an open loop read from a cell's parameter
file, ``bench/traffic/<cell>.json``.

Arrivals are a Poisson process conditioned on its count: each segment
of the schedule holds ``round(rate × length)`` requests at sorted
uniform times. Lengths are stratified quantiles of a clipped log-normal,
shuffled, and tenants are dealt by their shares, shuffled too. So a
seed changes the order and the timing of the work, never its amount.
Times are seconds from the start of the measured window: the warm-up
runs before 0, the window is [0, seconds), the drain after it.

No request is due in the last ``edge_guard_s`` before either edge of
the window (0 and ``seconds``): each part's requests start their
prefills inside it, so the work a window holds is the same for every
seed, and not a few prompts more or less where arrivals crowd an edge."""
from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist

import numpy as np

_N01 = NormalDist()

# seconds before each edge of the window in which no request is due; a
# traffic file may set its own ``edge_guard_s``
EDGE_GUARD_S = 1.0


def load(root: Path, cell: str) -> dict:
    return json.loads((root / "bench" / "traffic" / f"{cell}.json")
                      .read_text())


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n stratified quantiles of a log-normal (``median``, ``sigma``)
    clipped to [``min``, ``max``], in the order ``rng`` shuffles."""
    u = (np.arange(n) + 0.5) / max(n, 1)
    z = np.array([_N01.inv_cdf(x) for x in u])
    v = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    v = np.clip(np.rint(v), spec["min"], spec["max"]).astype(np.int64)
    return rng.permutation(v)


def deal(shares, n: int, rng: np.random.Generator) -> np.ndarray:
    """n tenant indices in the proportions ``shares`` (largest
    remainders), shuffled."""
    exact = np.asarray(shares, np.float64) * n / sum(shares)
    count = np.floor(exact).astype(np.int64)
    rest = n - int(count.sum())
    count[np.argsort(-(exact - count), kind="stable")[:rest]] += 1
    return rng.permutation(np.repeat(np.arange(len(shares)), count))


def segments(t: dict, seconds: float) -> list[tuple[float, float, list]]:
    """(start, end, shares) of the schedule from −warmup_s to seconds +
    drain_limit_s: one segment per part of the run, cut further at every
    swap of a ``shift`` schedule (its periods start at 0)."""
    parts = [(-t["warmup_s"], 0.0), (0.0, float(seconds)),
             (float(seconds), seconds + t["drain_limit_s"])]
    shares = [x["share"] for x in t["tenants"]]
    shift = t.get("shift")
    if not shift:
        return [(a, b, shares) for a, b in parts]
    p = shift["period_s"]
    out = []
    for a, b in parts:
        k = math.floor(a / p)
        while k * p < b:
            lo, hi = max(a, k * p), min(b, (k + 1) * p)
            if hi > lo:
                out.append((lo, hi, shift["shares"][k % len(shift["shares"])]))
            k += 1
    return out


def generate(t: dict, seconds: float, seed_seq: np.random.SeedSequence,
             vocab: int) -> list[dict]:
    """Every request of one run, in due order: ``due``, ``tenant``
    (index), ``prompt`` (token ids), ``answer`` (tokens to generate)."""
    times_ss, tokens_ss = seed_seq.spawn(2)
    rng = np.random.default_rng(times_ss)
    guard = t.get("edge_guard_s", EDGE_GUARD_S)
    reqs = []
    for a, b, shares in segments(t, seconds):
        n = int(round(t["rate_per_s"] * (b - a)))
        if n == 0:
            continue
        end = b - min(guard, (b - a) / 2) if b in (0.0, seconds) else b
        due = a + (end - a) * np.sort(rng.uniform(size=n))
        plen = lengths(t["prompt"], n, rng)
        alen = lengths(t["answer"], n, rng)
        who = deal(shares, n, rng)
        for i in range(n):
            reqs.append({"due": float(due[i]), "tenant": int(who[i]),
                         "prompt_len": int(plen[i]),
                         "answer": int(alen[i])})
    reqs.sort(key=lambda r: r["due"])
    tok = np.random.default_rng(tokens_ss)
    for r in reqs:
        r["prompt"] = tok.integers(0, vocab, r["prompt_len"]).tolist()
    return reqs
