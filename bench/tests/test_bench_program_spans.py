"""The program's own spans beside the benchmark's: a flight recorder
attached to the engine after set-up puts each prefill and decode span
inside the benchmark's span of the same call, with walls that agree."""
import pytest

from bench import harness, traffic
from bench.tests.small import DENSE, ROOT, TRAFFIC
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
