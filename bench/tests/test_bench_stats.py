import numpy as np
import pytest

from bench import stats


def _req(due, first, finish, gen=5, slo=1.0, cloud=False, prompt=10):
    return {"due": due, "first": first, "finish": finish, "generated": gen,
            "slo": slo, "cloud": cloud, "prompt": prompt}


def test_percentiles_are_the_programs_arithmetic():
    from repro_torch.obs.metrics import percentile_bands
    x = np.random.default_rng(0).lognormal(size=257)
    assert stats.percentile_bands(x) == percentile_bands(x)


def test_missing_first_token_or_finish_misses_every_limit():
    t_stop = 100.0
    ok = _req(0.0, 0.1, 0.5)
    no_first = _req(0.0, None, None)
    unfinished = _req(0.0, 0.2, None)
    cloud = _req(0.0, None, 0.25, cloud=True)
    for r in (no_first, unfinished, cloud):
        assert stats.ttft_s(r, t_stop) >= 0.2 or r is unfinished
        assert stats.tpot_s(r, t_stop) == pytest.approx(t_stop)
    assert stats.ttft_s(no_first, t_stop) == pytest.approx(t_stop)
    assert stats.ttft_s(cloud, t_stop) == pytest.approx(t_stop)
    assert stats.latency_s(unfinished, t_stop) == pytest.approx(t_stop)
    m, c = stats.end_to_end([ok, no_first, unfinished], 0.0, 1.0, t_stop, 1)
    assert m["slo_attainment"] == pytest.approx(1 / 3)
    assert c["unfinished"] == 2
    # the Cloud's request counts by its latency, WAN penalty included
    m, _ = stats.end_to_end([cloud], 0.0, 1.0, t_stop, 1)
    assert m["slo_attainment"] == 1.0


def test_tokens_served_in_the_window():
    """Fresh prefills' prompt tokens and their first tokens, one token per
    decode row, by span start; re-prefills are not counted."""
    prefills = [(-0.5, 0.1, "a", 1, 100, False),   # before the window
                (0.2, 0.3, "a", 2, 90, False),
                (0.4, 0.5, "b", 3, 500, True),     # a resumed request
                (1.2, 1.3, "b", 4, 70, False)]     # after it
    decodes = [(0.3, 0.35, "a", [91, 20, 7]), (0.9, 1.1, "b", [501]),
               (1.0, 1.1, "b", [3])]
    assert stats.tokens_served(prefills, decodes, 0.0, 1.0) == 91 + 4
    m, _ = stats.end_to_end([_req(0.5, 0.6, 0.9)], 0.0, 2.0, 2.0, 95)
    assert m["tokens_per_s"] == pytest.approx(47.5)


def test_tails_are_over_all_requests():
    reqs = [_req(i / 100, i / 100 + 0.01 * (i + 1), i / 100 + 1.0)
            for i in range(100)]
    m, _ = stats.end_to_end(reqs, 0.0, 1.0, 10.0, 0)
    for q in (50, 95):
        assert m[f"ttft_p{q}_ms"] == pytest.approx(1e3 * stats.percentile_bands(
            [0.01 * (i + 1) for i in range(100)])[f"p{q}"])
