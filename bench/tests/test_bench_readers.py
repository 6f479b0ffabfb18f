"""The per-layer readers take their numerator and denominator over the
same work: a kernel that the drain launched after the window closed
counts in no roofline, and the host spans' metrics of a traced run read
only the window's part before the profiler started. A cell whose quotas
move checks requests resumed after a preemption."""
import pytest

from bench import harness, modules
from bench.counts.attention import flash_prefill, paged_decode
from bench.counts.peaks import roofline_s
from bench.record import Record
from bench.tests.small import DENSE, ROOT, run
from bench.tracing import Kernel, Trace

CFG = {"name": "c", "arch": "decoder", "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32}


def _rec(kernels, t0=6.0, t1=9.0):
    """A window [0, 9) traced from 6 s, a prefill and a decode step in
    the traced part, and the same again in the drain after 9 s."""
    rec = Record("c", CFG, (0.0, 9.0), 12.0, [],
                 prefills=[(1.0, 1.2, "a", 1, 100, False),
                           (6.5, 6.7, "a", 2, 100, False),
                           (9.5, 9.7, "a", 3, 100, False)],
                 decodes=[(2.0, 2.1, "a", [10, 20]),
                          (7.0, 7.1, "a", [10, 20]),
                          (10.0, 10.1, "a", [10, 20])],
                 rounds=[(3.0, 3.001), (8.0, 8.004)],
                 arch=modules.program(CFG))
    rec.trace = Trace(t0, t1, kernels)
    return rec


def _k(name, launch, dur):
    return Kernel(name, launch + 1e-4, dur, launch)


@pytest.mark.parametrize("metric,kind,at,work", [
    ("flash_roofline", "flash_fwd", (6.6, 9.6),
     flash_prefill(100, 4, 2, 32)),
    ("paged_roofline", "paged_split", (7.05, 10.05),
     paged_decode([10, 20], 4, 2, 32)),
])
def test_drain_kernels_are_not_in_the_roofline(metric, kind, at, work):
    inside, drain = at
    read = harness.load_metric(ROOT, metric)
    # the drain's kernel, launched after the window, is three times as
    # long; it must not lower the share
    rec = _rec([_k(kind, inside, 1e-3), _k(kind, drain, 3e-3),
                _k("other", inside, 5e-3)])
    want = 100.0 * 2 * roofline_s(*work) / 1e-3
    assert read(rec) == pytest.approx(want)


def test_a_reader_with_no_kernel_of_its_own_returns_nothing():
    rec = _rec([_k("flash_fwd", 9.6, 1e-3)])
    assert harness.load_metric(ROOT, "flash_roofline")(rec) is None


def test_host_span_metrics_read_the_untraced_part():
    traced = _rec([])
    assert traced.host_window() == (0.0, 6.0)
    assert harness.load_metric(ROOT, "decode_step_ms")(traced) == \
        pytest.approx(100.0)
    assert harness.load_metric(ROOT, "round_ms")(traced) == \
        pytest.approx(1.0)
    assert harness.load_metric(ROOT, "prefill_ms_per_ktok")(traced) == \
        pytest.approx(2000.0)
    traced.trace.begun = 5.0
    assert traced.host_window() == (0.0, 5.0)
    assert harness.load_metric(ROOT, "round_ms")(traced) == \
        pytest.approx(1.0)
    untraced = _rec([])
    untraced.trace = None
    assert untraced.host_window() == (0.0, 9.0)
    assert harness.load_metric(ROOT, "round_ms")(untraced) == \
        pytest.approx(2.5)


def _preempting(eng):
    """Every third step, take one slot from tenant ``a`` while it decodes
    and give it back on the next step, as DYVERSE rounds that scale it
    down and up: its youngest request is preempted and resumed."""
    from repro_torch.core import Quota
    step, n = eng.step, [0]

    def f():
        n[0] += 1
        tq = eng.sched.tenants["a"]
        pages = tq.quota.pages
        if n[0] % 3 == 0 and tq.active:
            eng.ctrl.actuator.apply_quota(
                "a", Quota(len(tq.active) - 1, pages))
        elif n[0] % 3 == 1:
            eng.ctrl.actuator.apply_quota("a", Quota(3, pages))
        step()
    eng.step = f


def _check(**over):
    return {**harness.load_spec(ROOT, "granite.code")[3]["check"], **over}


def test_resumed_requests_are_checked_where_the_cell_asks():
    out = run("granite.code", 51, cfg=DENSE, fault=_preempting,
              check=_check(min_resumed=1))
    assert out["samples"]["resumed"] > 0
    assert out["checks"]["checked_resumed"]["value"] >= 1
    assert out["correct"], out["checks"]


def test_a_run_with_no_resumed_request_fails_such_a_cell():
    out = run("granite.code", 51, cfg=DENSE, check=_check(min_resumed=1))
    assert out["samples"]["resumed"] == 0
    assert not out["correct"]


@pytest.mark.parametrize("dropped", [0, 2, 5])
def test_clocks_align_when_the_trace_drops_its_first_markers(dropped):
    """The profiler's clock runs 3 ms ahead of the host's and gains
    20 ppm; each marker's launch call takes 2 us inside a 10 us bracket.
    The recorded markers, with the first ``dropped`` missing, still map
    the profiler's clock to the host's within the brackets."""
    from bench.tracing import MARKS, align

    def prof(h):
        return h + 3_000_000 + 2e-5 * (h - 1e9)

    def brackets(t):
        return [(t + i * 50_000, t + i * 50_000 + 10_000)
                for i in range(MARKS)]
    starts, ends = brackets(1e9), brackets(1e9 + 16e9)
    calls = [(prof(a + 4_000), 2_000) for a, _ in starts + ends]
    host_ns, room, first = align(calls[dropped:], starts, ends)
    assert all(r >= 0 for r in room)
    assert first == (starts[dropped][0] if dropped < MARKS else None)
    tol = 10_000 if dropped < MARKS else 10_000 + 2e-5 * 16e9
    for h in (1e9 + 1e6, 1e9 + 8e9, 1e9 + 16e9 + 1e6):
        assert abs(host_ns(prof(h)) - h) <= tol
