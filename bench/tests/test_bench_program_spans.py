"""The program's own spans beside the benchmark's: a flight recorder
attached to the engine after set-up puts each prefill and decode span
inside the benchmark's span of the same call, with walls that agree;
the harness's own attach and detach (a traced run's) hands the events
to the record, where readers take those begun in its host window."""
import pytest

from bench import harness, traffic
from bench.tests.small import DENSE, ROOT, TRAFFIC
from bench.tracing import Trace
from repro_torch.obs import FlightRecorder


def test_program_spans_lie_inside_the_benchmarks_spans():
    import torch
    torch.set_num_threads(2)
    s = harness.Setup(ROOT, "granite.code", 61, device="cpu", cfg_over=DENSE,
                      traffic_over=TRAFFIC)
    obs = FlightRecorder()
    s.eng.attach_recorder(obs)
    reqs = traffic.generate(s.t, 3.0, s.traffic_ss, s.cfg["vocab_size"])
    rec = harness.open_loop(s, reqs, 3.0)
    s.eng.attach_recorder(None)
    assert obs.dropped == 0
    evs = obs.events_list()
    for kind, outer in (("prefill", rec.prefills), ("decode", rec.decodes)):
        inner = [e for e in evs if e.kind == kind]
        assert len(inner) == len(outer) > 0
        for e, (a, b, tenant, *_) in zip(inner, outer):
            assert e.tenant == tenant
            assert a <= e.t - e.detail["dur"] and e.t <= b
        mean_in = sum(e.detail["dur"] for e in inner) / len(inner)
        mean_out = sum(b - a for a, b, *_ in outer) / len(outer)
        assert mean_in == pytest.approx(mean_out, rel=0.05)
    assert [e.detail["rid"] for e in evs if e.kind == "prefill"] == \
        [p[3] for p in rec.prefills]
    # attached after set-up: the warm-up's requests are not recorded
    assert min(e.detail["rid"] for e in evs if e.kind == "serving_admit") \
        == min(r["rs"].req.rid for r in reqs if "rs" in r)


def test_the_harness_hands_the_programs_events_to_the_record():
    import torch
    torch.set_num_threads(2)
    s = harness.Setup(ROOT, "granite.code", 62, device="cpu", cfg_over=DENSE,
                      traffic_over=TRAFFIC)
    reqs = traffic.generate(s.t, 3.0, s.traffic_ss, s.cfg["vocab_size"])
    rec = harness.open_loop(s, reqs, 3.0, events=True)
    assert s.eng.recorder is None and s.eng.ctrl.recorder is None
    assert rec.events_dropped == 0
    kinds = {e.kind for e in rec.events}
    assert {"engine_step", "prefill", "decode"} <= kinds
    decodes = [e for e in rec.events if e.kind == "decode"]
    assert len(decodes) == len(rec.decodes)
    # a traced part from the window's middle: only spans begun before it
    w0, w1 = rec.window
    rec.trace = Trace(0.5 * (w0 + w1), w1, [])
    got = rec.program_spans("decode")
    begun = [e.t - e.detail["dur"] for e in decodes]
    assert got == [e for e, b in zip(decodes, begun)
                   if w0 <= b < rec.trace.t0]
    assert 0 < len(got) < sum(w0 <= b < w1 for b in begun)
    prefills = rec.program_spans("prefill")
    assert prefills and {e.kind for e in prefills} == {"prefill"}
    rec.events_dropped = 1
    assert rec.program_spans("decode") is None
    # an untraced loop attaches nothing: its record has no events
    untraced = harness.open_loop(s, traffic.generate(
        s.t, 1.0, s.traffic_ss, s.cfg["vocab_size"]), 1.0)
    assert untraced.events is None and untraced.program_spans("decode") is None
