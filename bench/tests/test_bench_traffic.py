import numpy as np
import pytest

from bench import traffic
from bench.tests.small import ROOT

CELLS = ["olmoe.docqa", "granite.code"]
SHIFT = {"period_s": 15, "shares": [[0.8, 0.2], [0.2, 0.8]]}


def _gen(cell, seed, seconds=48, **over):
    t = {**traffic.load(ROOT, cell), **over}
    return t, traffic.generate(t, seconds, np.random.SeedSequence(seed),
                               1000)


@pytest.mark.parametrize("cell,over", [(c, {}) for c in CELLS]
                         + [("olmoe.docqa", {"shift": SHIFT})])
def test_work_is_fixed_across_seeds(cell, over):
    """Seeds change order and timing, never the amount of work: the same
    count, and the same sums of lengths, in each part of the run."""
    seen = set()
    for seed in (1, 2, 2**31 + 11):
        t, reqs = _gen(cell, seed, **over)
        win = [r for r in reqs if 0 <= r["due"] < 48]
        key = (len(reqs), len(win), sum(r["prompt_len"] for r in win),
               sum(r["answer"] for r in win))
        seen.add(key)
        assert len(win) == sum(
            round(t["rate_per_s"] * (b - a))
            for a, b, _ in traffic.segments(t, 48) if 0 <= a < 48)
        assert abs(len(win) - t["rate_per_s"] * 48) <= 2
    assert len(seen) == 1


@pytest.mark.parametrize("cell,over", [(c, {}) for c in CELLS]
                         + [("olmoe.docqa", {"shift": SHIFT})])
def test_no_request_is_due_just_before_an_edge(cell, over):
    """Every request due before an edge of the window is due at least
    the guard before it, so its prefill starts on its own side."""
    for seed in (1, 2, 2**31 + 11):
        t, reqs = _gen(cell, seed, **over)
        g = traffic.EDGE_GUARD_S
        assert not [r for r in reqs if -g <= r["due"] < 0
                    or 48 - g <= r["due"] < 48]
        assert any(-12 <= r["due"] < 0 for r in reqs)
    _, reqs = _gen(cell, 1, edge_guard_s=0.25, **over)
    assert not [r for r in reqs if 47.75 <= r["due"] < 48]


def test_seed_changes_order_and_timing():
    _, a = _gen("olmoe.docqa", 1)
    _, b = _gen("olmoe.docqa", 2)
    assert [r["due"] for r in a] != [r["due"] for r in b]
    assert [r["prompt_len"] for r in a] != [r["prompt_len"] for r in b]


def test_lengths_stay_in_their_clip():
    t, reqs = _gen("granite.code", 5)
    p, q = t["prompt"], t["answer"]
    assert all(p["min"] <= r["prompt_len"] <= p["max"] for r in reqs)
    assert all(q["min"] <= r["answer"] <= q["max"] for r in reqs)
    assert all(len(r["prompt"]) == r["prompt_len"] for r in reqs)


def test_shift_schedule_swaps_on_time():
    t, reqs = _gen("olmoe.docqa", 3, shift=SHIFT)
    p = t["shift"]["period_s"]
    for k in range(-1, 4):
        part = [r for r in reqs if k * p <= r["due"] < (k + 1) * p]
        if len(part) < 20:
            continue
        heavy = 0 if k % 2 == 0 else 1
        share = np.mean([r["tenant"] == heavy for r in part])
        assert share == pytest.approx(0.8, abs=0.03), (k, share)


def test_steady_cells_split_evenly():
    _, reqs = _gen("olmoe.docqa", 4)
    win = [r for r in reqs if 0 <= r["due"] < 48]
    assert abs(sum(r["tenant"] for r in win) - len(win) / 2) <= 1
