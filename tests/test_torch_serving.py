"""The port's multi-tenant serving engine (CPU): the scheduler, the
engine's control loop under DYVERSE, the preemption-resume contract on
weights carried over from the JAX package, and the device rule (the
engine and the serving backend run on "cuda" unless asked for "cpu",
and raise without a card)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import MultiTenantEngine as RefEngine
from repro_torch.configs import get_reduced
from repro_torch.core import Quota, TenantSpec
from repro_torch.serving import (CLOUD_LATENCY_S, EngineConfig,
                                 MultiTenantEngine, VirtualClock)
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.scheduler import QuotaScheduler
from torch_lm_parity import models

ARCH = "tinyllama-1.1b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mk_req(rid, tenant="t", prompt_len=8, max_new=4, t0=0.0):
    return Request(rid=rid, tenant=tenant,
                   prompt=list(range(1, prompt_len + 1)),
                   max_new_tokens=max_new, arrival_t=t0)


# ---------------------------------------------------------------- scheduler
def test_scheduler_respects_slot_quota():
    s = QuotaScheduler(page_size=16)
    s.add_tenant("t", Quota(slots=2, pages=100))
    for i in range(5):
        s.submit(mk_req(i, t0=i))
    assert len(s.admit_waiting("t")) == 2
    assert s.depth("t") == 3


def test_scheduler_respects_page_quota():
    s = QuotaScheduler(page_size=16)
    s.add_tenant("t", Quota(slots=10, pages=2))   # 2 pages = 32 tokens
    s.submit(mk_req(1, prompt_len=20, max_new=4))  # needs 2 pages
    s.submit(mk_req(2, prompt_len=20, max_new=4))
    assert len(s.admit_waiting("t")) == 1          # second doesn't fit


def test_quota_shrink_preempts_youngest():
    s = QuotaScheduler(page_size=16)
    s.add_tenant("t", Quota(slots=3, pages=100))
    rs = [s.submit(mk_req(i, t0=float(i))) for i in range(3)]
    s.admit_waiting("t")
    pre = s.set_quota("t", Quota(slots=1, pages=100))
    assert len(pre) == 2
    assert pre[0].req.arrival_t >= pre[1].req.arrival_t   # youngest first
    assert len(s.active("t")) == 1
    assert s.active("t")[0] is rs[0]                      # oldest survives


def test_remove_tenant_evicts_all():
    s = QuotaScheduler()
    s.add_tenant("t", Quota(slots=2, pages=100))
    for i in range(4):
        s.submit(mk_req(i))
    s.admit_waiting("t")
    out = s.remove_tenant("t")
    assert len(out) == 4
    assert all(r.phase == Phase.EVICTED for r in out)
    assert "t" not in s.tenants


def test_admit_waiting_defers_backoff_without_consuming_slots():
    s = QuotaScheduler(page_size=16)
    s.add_tenant("t", Quota(slots=2, pages=100))
    rs = [s.submit(mk_req(i, t0=float(i))) for i in range(3)]
    rs[0].not_before = 5.0
    got = s.admit_waiting("t", now=1.0)
    assert got == rs[1:]
    assert list(s.tenants["t"].waiting) == [rs[0]]


# ---------------------------------------------------------------- engine
def _cfg(**kw):
    base = dict(policy="none", slot_cap=2, capacity_slots=4,
                capacity_pages=64, max_seq_len=64,
                round_interval_steps=10**9)
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def engine():
    eng = MultiTenantEngine(EngineConfig(policy="none", slot_cap=4,
                                         capacity_slots=8,
                                         capacity_pages=128,
                                         max_seq_len=64), device="cpu")
    assert eng.add_tenant(TenantSpec(name="chat", slo_latency=60.0),
                          get_reduced(ARCH))
    assert eng.add_tenant(TenantSpec(name="code", slo_latency=60.0),
                          get_reduced("granite-8b"))
    return eng


def test_engine_completes_two_tenants(engine):
    rng = np.random.default_rng(0)
    rs = [engine.submit("chat" if i % 2 else "code",
                        list(rng.integers(1, 200, 8)), max_new_tokens=4)
          for i in range(6)]
    engine.drain(max_steps=100)
    assert all(r.phase == Phase.DONE for r in rs)
    assert all(len(r.generated) == 4 for r in rs)
    assert all(r.latency() is not None and r.latency() > 0 for r in rs)


def test_engine_greedy_decode_deterministic(engine):
    out = []
    for _ in range(2):
        r = engine.submit("chat", [5, 6, 7, 8, 9, 10, 11, 12],
                          max_new_tokens=5)
        engine.drain(max_steps=60)
        out.append(tuple(r.generated))
    assert out[0] == out[1]


def test_submit_to_unknown_tenant_goes_to_cloud(engine):
    before = len(engine.cloud_serviced)
    r = engine.submit("nope", [1, 2, 3])
    assert r.phase == Phase.EVICTED
    assert len(engine.cloud_serviced) == before + 1


def test_dyverse_round_scales_up_violating_tenant():
    eng = MultiTenantEngine(_cfg(policy="sps", slot_cap=4, capacity_slots=8,
                                 capacity_pages=128), device="cpu")
    assert eng.add_tenant(TenantSpec(name="hot", slo_latency=1e-4),
                          get_reduced(ARCH))
    for _ in range(4):
        eng.submit("hot", [1, 2, 3, 4], max_new_tokens=2)
    eng.drain(max_steps=60)
    before = eng.ctrl.pool.units("hot")
    eng.ctrl.run_round()
    assert eng.ctrl.pool.units("hot") > before
    assert eng.ctrl.registry["hot"].scale_count == 1


def test_engine_termination_redirects_to_cloud():
    eng = MultiTenantEngine(_cfg(policy="sps", slot_cap=4, capacity_slots=4),
                            device="cpu")
    assert eng.add_tenant(TenantSpec(name="vip", slo_latency=1e-4,
                                     premium=5.0), get_reduced(ARCH))
    assert eng.add_tenant(TenantSpec(name="low", slo_latency=60.0),
                          get_reduced(ARCH))
    for _ in range(3):
        eng.submit("vip", [1, 2, 3], max_new_tokens=2)
        eng.submit("low", [4, 5, 6], max_new_tokens=2)
    eng.drain(max_steps=80)
    eng.submit("low", [7, 8], max_new_tokens=2)   # in-flight during eviction
    eng.ctrl.run_round()
    assert "low" not in eng.ctrl.registry and "low" not in eng.tenants
    assert any(r.req.tenant == "low" for r in eng.cloud_serviced)
    r = eng.submit("vip", [9, 10, 11], max_new_tokens=2)
    eng.drain(max_steps=40)
    assert r.phase == Phase.DONE


# ----------------------------------------------------- preemption regression
def test_preemption_resume_bitwise_identical():
    """A preempted-then-resumed request must produce EXACTLY the token
    stream of an unpreempted run, keep its TTFT and never double-append
    (prompt + generated[:-1] re-prefilled, the last token fed back at the
    restored KV position) — on weights carried from the reference, whose
    own engine gives the same stream."""
    rcfg, _, rparams, pcfg, _, pparams = models(ARCH, "float32", seed=3)

    def fresh():
        clock = VirtualClock(0.25)
        eng = MultiTenantEngine(_cfg(), seed=3, clock=clock, device="cpu")
        assert eng.add_tenant(TenantSpec(name="t", slo_latency=60.0), pcfg)
        eng.tenants["t"].params = pparams
        return eng, clock

    ref, clock = fresh()
    r0 = ref.submit("t", [5, 7, 9, 11], max_new_tokens=8)
    while r0.phase != Phase.DONE:
        clock.tick()
        ref.step()
    want = list(r0.generated)
    assert len(want) == 8

    # the JAX package's engine on the same weights
    rclock = VirtualClock(0.25)
    jeng = RefEngine(RefEngineConfig(**dataclasses.asdict(_cfg())), seed=3,
                     clock=rclock)
    assert jeng.add_tenant(TenantSpec(name="t", slo_latency=60.0), rcfg)
    jeng.tenants["t"].params = rparams
    rj = jeng.submit("t", [5, 7, 9, 11], max_new_tokens=8)
    while rj.phase.value != "done":
        rclock.tick()
        jeng.step()
    assert rj.generated == want

    eng, clock = fresh()
    r1 = eng.submit("t", [5, 7, 9, 11], max_new_tokens=8)
    for _ in range(4):                      # prefill + a few decode steps
        clock.tick()
        eng.step()
    assert r1.phase == Phase.DECODE and 1 < len(r1.generated) < 8
    ttft = r1.first_token_t
    mid = list(r1.generated)
    eng.ctrl.actuator.apply_quota("t", Quota(slots=0, pages=64))
    assert r1.phase == Phase.QUEUED and r1.batch_slot == -1
    assert all(rs is not r1 for rs in eng.tenants["t"].slot_req)
    for _ in range(3):                      # starved: no progress
        clock.tick()
        eng.step()
    assert r1.generated == mid
    eng.ctrl.actuator.apply_quota("t", Quota(slots=2, pages=64))
    while r1.phase != Phase.DONE:
        clock.tick()
        eng.step()
    assert r1.generated == want             # bitwise-identical continuation
    assert r1.first_token_t == ttft         # TTFT survives preemption


def test_pages_never_exceed_quota_during_shrink():
    clock = VirtualClock(0.25)
    eng = MultiTenantEngine(_cfg(slot_cap=4, page_size=4), seed=0,
                            clock=clock, device="cpu")
    assert eng.add_tenant(TenantSpec(name="t", slo_latency=60.0),
                          get_reduced(ARCH))
    eng.ctrl.actuator.apply_quota("t", Quota(slots=4, pages=12))
    rng = np.random.default_rng(0)
    shrink_at = {6: Quota(slots=4, pages=8), 12: Quota(slots=4, pages=5)}
    for step in range(20):
        if step % 2 == 0:
            eng.submit("t", [int(x) for x in rng.integers(1, 200, 6)],
                       max_new_tokens=6)
        if step in shrink_at:
            eng.ctrl.actuator.apply_quota("t", shrink_at[step])
        clock.tick()
        eng.step()
        tq = eng.sched.tenants["t"]
        assert tq.pages_used(eng.cfg.page_size) <= tq.quota.pages
        for rs in tq.active:
            assert rs.context_len <= len(rs.req.prompt) + rs.req.max_new_tokens


def test_eviction_cloud_latency_accounting():
    clock = VirtualClock(0.25)
    eng = MultiTenantEngine(_cfg(slot_cap=1), seed=0, clock=clock,
                            device="cpu")
    assert eng.add_tenant(TenantSpec(name="t", slo_latency=60.0),
                          get_reduced(ARCH))
    rs = [eng.submit("t", [1 + i, 2, 3], max_new_tokens=8) for i in range(3)]
    for _ in range(2):
        clock.tick()
        eng.step()
    assert rs[0].phase == Phase.DECODE
    now = clock()
    eng._evict_tenant("t")
    assert all(r.phase == Phase.EVICTED for r in rs)
    assert all(r.finish_t == now + CLOUD_LATENCY_S for r in rs)
    assert eng.completed == []
    clock.tick()
    eng.step()
    assert eng.completed == []


def test_engine_cache_lives_on_device_and_is_written_in_place():
    eng = MultiTenantEngine(_cfg(), device="cpu")
    assert eng.add_tenant(TenantSpec(name="t", slo_latency=60.0),
                          get_reduced(ARCH))
    rt = eng.tenants["t"]
    k = rt.cache["k"]
    assert k.shape == (2, 2, 64, 2, 16) and k.dtype == torch.bfloat16
    eng.submit("t", [3, 4, 5], max_new_tokens=3)
    eng.drain(max_steps=10)
    assert rt.cache["k"] is k and bool(k[:, 0, :4].any())
    assert not k[:, 0, 5:].any()


# ---------------------------------------------------------------- devices
def test_cuda_requested_without_a_card_raises(monkeypatch):
    from repro_torch.sim import SCENARIOS, run_scenario

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiTenantEngine(_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario("serving_edge_pair")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_scenario(dataclasses.replace(
            SCENARIOS["serving_timeout_retry"],
            backend_options={"device": "cuda:0"}))


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--requests", "4", "--tenants",
          "chat:tinyllama-1.1b"])
    out = capsys.readouterr().out
    assert "completed=4 cloud=0" in out
