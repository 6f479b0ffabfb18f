"""The serving engine's spans in the port's flight recorder (CPU): a
recorder changes no token, quota or round decision; with none, the
engine reads no clock and allocates nothing from ``repro_torch.obs``;
the prefill, decode and round spans nest in their step's span with
their phases inside them; every span and instant of a request shares
its ``rid``; and the Chrome trace keeps the nesting."""
import json
import time
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core import Quota, TenantSpec
from repro_torch.obs import FlightRecorder, write_chrome_trace
from repro_torch.serving import EngineConfig, MultiTenantEngine, VirtualClock
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.request import Phase

PHASES = {"prefill": ("inputs", "forward", "insert", "first"),
          "decode": ("inputs", "forward", "wait", "finish")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(recorder=None):
    clock = VirtualClock(0.05)
    eng = MultiTenantEngine(
        EngineConfig(policy="sdps", slot_cap=3, capacity_slots=6,
                     capacity_pages=96, max_seq_len=64,
                     round_interval_steps=5, default_units=2),
        seed=1, clock=clock, device="cpu", recorder=recorder)
    assert eng.add_tenant(TenantSpec(name="a", slo_latency=0.3, premium=1.0),
                          get_reduced("tinyllama-1.1b"))
    assert eng.add_tenant(TenantSpec(name="b", slo_latency=2.0),
                          get_reduced("granite-8b"))
    return eng, clock


def _drive(recorder=None):
    """Seeded arrivals into both tenants under DYVERSE rounds every five
    steps; every seventh step takes a slot from ``a`` while it decodes
    (its youngest request is preempted) and the next gives it back."""
    eng, clock = _engine(recorder)
    reports, quotas, reqs = [], [], []
    run_round = eng.ctrl.run_round

    def recorded_round():
        r = run_round()
        reports.append((r.actions, r.terminated))
        return r
    eng.ctrl.run_round = recorded_round
    rng = np.random.default_rng(7)
    for i in range(400):
        clock.tick()
        if i < 40 and i % 2 == 0:
            for _ in range(int(rng.integers(1, 3))):
                name = "ab"[int(rng.integers(0, 2))]
                reqs.append(eng.submit(
                    name, rng.integers(1, 200, int(rng.integers(4, 20)))
                    .tolist(), max_new_tokens=int(rng.integers(3, 9))))
        tq = eng.sched.tenants["a"]
        if i % 7 == 3 and tq.active:
            eng.ctrl.actuator.apply_quota(
                "a", Quota(len(tq.active) - 1, tq.quota.pages))
        elif i % 7 == 4:
            eng.ctrl.actuator.apply_quota("a", Quota(3, tq.quota.pages))
        eng.step()
        quotas.append({n: (q.quota.slots, q.quota.pages)
                       for n, q in eng.sched.tenants.items()})
        if i >= 40 and not any(q.active or q.waiting
                               for q in eng.sched.tenants.values()):
            break
    return eng, reports, quotas, reqs


@pytest.fixture(scope="module")
def runs():
    rec = FlightRecorder()
    t0 = time.perf_counter()
    traced = _drive(rec)
    t1 = time.perf_counter()
    return {"plain": _drive(), "traced": traced, "rec": rec,
            "clock": (t0, t1)}


def _spans(rec, kind):
    return [e for e in rec.events_list() if e.kind == kind]


def _start(e):
    return e.t - e.detail["dur"]


def test_a_recorder_changes_no_token_quota_or_decision(runs):
    (pe, prep, pq, preqs), (te, trep, tq, treqs) = \
        runs["plain"], runs["traced"]
    assert [(r.req.rid, r.generated, r.phase, r.first_token_t, r.finish_t)
            for r in preqs] == \
        [(r.req.rid, r.generated, r.phase, r.first_token_t, r.finish_t)
         for r in treqs]
    assert all(r.phase == Phase.DONE for r in treqs)
    assert [r.req.rid for r in pe.completed] == \
        [r.req.rid for r in te.completed]
    assert pq == tq
    assert prep == trep and any(acts for acts, _ in trep)
    assert pe.steps == te.steps


def test_off_path_reads_no_clock_and_allocates_nothing_from_obs(
        monkeypatch):
    eng, clock = _engine()
    eng.submit("a", [3, 4, 5, 6, 7], max_new_tokens=2)
    clock.tick()
    eng.step()                          # warm caches outside the trace

    def no_clock():
        raise AssertionError("the off path read the spans' clock")
    monkeypatch.setattr(engine_mod, "_now", no_clock)
    tracemalloc.start()
    try:
        rs = [eng.submit("ab"[i % 2], [3, 4, 5, 6, 7], max_new_tokens=8)
              for i in range(4)]
        for i in range(12):             # prefills, decodes, two rounds
            if i == 3:                  # a preemption and its resume
                eng.ctrl.actuator.apply_quota("a", Quota(0, 32))
            elif i == 4:
                eng.ctrl.actuator.apply_quota("a", Quota(3, 32))
            clock.tick()
            eng.step()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert eng.ctrl.rounds_run == 2
    assert all(r.phase == Phase.DONE for r in rs)
    obs_allocs = [s for s in snap.statistics("filename")
                  if "repro_torch/obs" in (s.traceback[0].filename or "")]
    assert obs_allocs == []


def test_spans_nest_in_their_step_and_phases_in_their_span(runs):
    rec = runs["rec"]
    t0, t1 = runs["clock"]
    assert rec.dropped == 0
    steps = _spans(rec, "engine_step")
    assert [e.detail["step"] for e in steps] == \
        list(range(runs["traced"][0].steps))
    # stamped on the host clock, not the engine's virtual request clock
    assert all(t0 <= _start(e) and e.t <= t1 for e in steps)
    starts = [_start(e) for e in steps]
    children = [e for e in rec.events_list()
                if e.kind in ("prefill", "decode", "round")]
    assert {e.kind for e in children} == {"prefill", "decode", "round"}
    for e in children:
        i = int(np.searchsorted(starts, _start(e), side="right")) - 1
        assert i >= 0 and e.t <= steps[i].t, e
        d = e.detail
        if e.kind == "round":
            assert d["forecast"] + d["priority"] + d["scaling"] <= d["dur"]
            assert d["classification"] + d["eviction"] + \
                d["actuation"] <= d["scaling"]
        else:
            walls = [d[p] for p in PHASES[e.kind] if p in d]
            assert all(w >= 0 for w in walls)
            assert sum(walls) <= d["dur"]
            assert len(walls) == 4 - (e.kind == "prefill" and d["resumed"])


def test_every_span_and_instant_of_a_request_shares_its_rid(runs):
    evs = runs["rec"].events_list()
    admitted, prefilled, preempted = {}, {}, {}
    resumed = set()
    for i, e in enumerate(evs):
        d = e.detail or {}
        if e.kind == "serving_admit":
            admitted.setdefault(d["rid"], i)
            assert d["wait_s"] >= 0
        elif e.kind == "prefill":
            prefilled.setdefault(d["rid"], i)
            if d["resumed"]:
                assert d["rid"] in preempted
                resumed.add(d["rid"])
        elif e.kind == "serving_preempt":
            preempted.setdefault(d["rid"], i)
            assert d["generated"] >= 1
        elif e.kind == "decode":
            assert d["rows"] == len(d["rids"]) >= 1
            assert d["ctx_sum"] > d["rows"]
            for rid in d["rids"]:
                assert admitted[rid] < prefilled[rid] < i
    assert resumed and resumed == set(preempted)
    traced = runs["traced"][3]
    assert set(prefilled) == {r.req.rid for r in traced}


def test_chrome_trace_keeps_children_inside_their_step(runs, tmp_path):
    path = tmp_path / "trace.json"
    write_chrome_trace(str(path), {"engine": runs["rec"].events_list()})
    doc = json.loads(path.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    steps = sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in xs
                   if e["name"] == "engine_step")
    starts = [s[0] for s in steps]
    eps = 1e-3                          # µs: float rounding of ts − dur
    kids = [e for e in xs if e["name"] != "engine_step"]
    assert kids
    for e in kids:
        i = int(np.searchsorted(starts, e["ts"] + eps, side="right")) - 1
        a, b, tid = steps[i]
        assert tid == e["tid"]
        assert a - eps <= e["ts"] and e["ts"] + e["dur"] <= b + eps
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "i"} >= \
        {"serving_admit", "serving_preempt"}
