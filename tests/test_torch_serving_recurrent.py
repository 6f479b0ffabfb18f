"""The port's serving engine and serving federation with the recurrent
families (RWKV-6 and hybrid Mamba-2 tenants) on the CPU, against the
JAX package: the per-family cache layouts, the preemption-resume
contract on weights carried from the reference (whose own engine must
give the same token stream), a mixed engine, and a serving federation
whose classes name rwkv6-3b and zamba2-2.7b — its outcomes depend on
the virtual clock and token counts alone, so they must equal the
reference's exactly."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.scenario as R
import repro_torch.sim.scenario as P
from repro.configs import get_reduced as ref_reduced
from repro.models.kvcache import grow_cache as ref_grow
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import MultiTenantEngine as RefEngine
from repro.serving.engine import _insert_cache as ref_insert_cache
from repro_torch.configs import get_reduced
from repro_torch.core import Quota, TenantSpec
from repro_torch.models import build_model
from repro_torch.models.kvcache import grow_cache
from repro_torch.serving import EngineConfig, MultiTenantEngine, VirtualClock
from repro_torch.serving.engine import _insert_cache
from repro_torch.serving.request import Phase
from torch_lm_parity import models, t

RECURRENT = ("rwkv6-3b", "zamba2-2.7b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(policy="none", slot_cap=2, capacity_slots=4,
                capacity_pages=64, max_seq_len=64,
                round_interval_steps=10**9)
    base.update(kw)
    return EngineConfig(**base)


# ---------------------------------------------------------------- caches
@pytest.mark.parametrize("arch", RECURRENT)
def test_insert_and_grow_cache_match_reference(arch):
    """A prefill's cache inserted at a slot of the engine's caches (the
    specs' shapes and dtypes), and grown to the engine's length."""
    rcfg, pcfg = ref_reduced(arch), get_reduced(arch)
    specs = build_model(pcfg, device="cpu").cache_specs(3, 12)
    rng = np.random.default_rng(8)
    full = {k: rng.standard_normal(s.shape).astype(np.float32)
            for k, s in specs.items()}
    one = {}
    for k, s in specs.items():
        shape = list(s.shape)
        shape[s.batch_axis] = 1
        if s.seq_axis is not None:
            shape[s.seq_axis] = 5
        one[k] = rng.standard_normal(shape).astype(np.float32)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    want = ref_insert_cache(
        {k: jnp.asarray(a, jdt[specs[k].dtype]) for k, a in full.items()},
        {k: jnp.asarray(a) for k, a in one.items()}, 1, rcfg, 12)
    got = _insert_cache({k: t(a).to(specs[k].dtype) for k, a in full.items()},
                        {k: t(a) for k, a in one.items()}, 1, pcfg, 12)
    for k in specs:
        assert got[k].dtype == specs[k].dtype
        assert np.array_equal(got[k].float().numpy(),
                              np.asarray(want[k], np.float32)), k
    grown = grow_cache(pcfg, {k: t(a) for k, a in one.items()}, 12)
    want = ref_grow(rcfg, {k: jnp.asarray(a) for k, a in one.items()}, 12)
    for k in specs:
        assert np.array_equal(grown[k].numpy(), np.asarray(want[k])), k


# ---------------------------------------------------------------- engine
def test_engine_completes_mixed_tenants():
    """tests/test_serving.py's mixed engine (tinyllama + rwkv6), with a
    zamba2 tenant beside them."""
    eng = MultiTenantEngine(EngineConfig(policy="none", slot_cap=4,
                                         capacity_slots=12,
                                         capacity_pages=192,
                                         max_seq_len=64), device="cpu")
    for name, arch in (("chat", "tinyllama-1.1b"), ("ssm", "rwkv6-3b"),
                       ("hyb", "zamba2-2.7b")):
        assert eng.add_tenant(TenantSpec(name=name, slo_latency=60.0),
                              get_reduced(arch))
    rng = np.random.default_rng(0)
    rs = [eng.submit(("chat", "ssm", "hyb")[i % 3],
                     list(rng.integers(1, 200, 8)), max_new_tokens=4)
          for i in range(9)]
    eng.drain(max_steps=100)
    assert all(r.phase == Phase.DONE for r in rs)
    assert all(len(r.generated) == 4 for r in rs)
    assert all(r.latency() is not None and r.latency() > 0 for r in rs)


@pytest.mark.parametrize("arch", RECURRENT)
def test_preemption_resume_matches_reference(arch):
    """A preempted-then-resumed request continues with EXACTLY the token
    stream of an unpreempted run (prompt + generated[:-1] re-prefilled
    into fresh states, the last token fed back), keeps its TTFT, and
    that stream is the reference engine's on the same weights."""
    rcfg, _, rparams, pcfg, _, pparams = models(arch, "float32", seed=3)
    prompt = [5, 7, 9, 11]

    def fresh():
        clock = VirtualClock(0.25)
        eng = MultiTenantEngine(_cfg(), seed=3, clock=clock, device="cpu")
        assert eng.add_tenant(TenantSpec(name="t", slo_latency=60.0), pcfg)
        eng.tenants["t"].params = pparams
        return eng, clock

    ref, clock = fresh()
    r0 = ref.submit("t", prompt, max_new_tokens=8)
    while r0.phase != Phase.DONE:
        clock.tick()
        ref.step()
    want = list(r0.generated)
    assert len(want) == 8

    rclock = VirtualClock(0.25)
    jeng = RefEngine(RefEngineConfig(**dataclasses.asdict(_cfg())), seed=3,
                     clock=rclock)
    assert jeng.add_tenant(TenantSpec(name="t", slo_latency=60.0), rcfg)
    jeng.tenants["t"].params = rparams
    rj = jeng.submit("t", prompt, max_new_tokens=8)
    while rj.phase.value != "done":
        rclock.tick()
        jeng.step()
    assert rj.generated == want

    eng, clock = fresh()
    r1 = eng.submit("t", prompt, max_new_tokens=8)
    for _ in range(4):                      # prefill + a few decode steps
        clock.tick()
        eng.step()
    assert r1.phase == Phase.DECODE and 1 < len(r1.generated) < 8
    ttft, mid = r1.first_token_t, list(r1.generated)
    eng.ctrl.actuator.apply_quota("t", Quota(slots=0, pages=64))
    assert r1.phase == Phase.QUEUED
    for _ in range(3):                      # starved: no progress
        clock.tick()
        eng.step()
    assert r1.generated == mid
    eng.ctrl.actuator.apply_quota("t", Quota(slots=2, pages=64))
    while r1.phase != Phase.DONE:
        clock.tick()
        eng.step()
    assert r1.generated == want
    assert r1.first_token_t == ttft


def test_serve_launcher_runs_recurrent_tenants(capsys):
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--requests", "4", "--policy", "none",
          "--tenants", "ssm:rwkv6-3b", "hyb:zamba2-2.7b"])
    assert "completed=4 cloud=0" in capsys.readouterr().out


# ---------------------------------------------------------------- federation
def _scenario(mod):
    """Two nodes, an RWKV-6 class and a hybrid class; edge1 fails
    mid-run so the live queues migrate."""
    return mod.Scenario(
        name="serving_recurrent_pair",
        fleet=mod.FleetSpec(classes=(
            mod.TenantClassSpec("game", 2, prefix="ssm"),
            mod.TenantClassSpec("game", 1, prefix="hyb"))),
        topology=mod.TopologySpec(n_nodes=2, capacity_units=6),
        policies=("none", "sdps"),
        default_units=1,
        engine="serving",
        faults=mod.FaultSpec((mod.NodeFailure(t=4, node="edge1"),)),
        serving=mod.ServingSpec(classes=(
            mod.ServingClassSpec(prefix="ssm", arch="rwkv6-3b", rate=0.6,
                                 slo_s=2.0),
            mod.ServingClassSpec(prefix="hyb", arch="zamba2-2.7b",
                                 rate=0.4, slo_s=3.0),
        ), rounds=3, steps_per_round=12))


def test_serving_federation_with_recurrent_classes_equals_reference():
    ref = R.run_scenario(_scenario(R))
    got = P.run_scenario(dataclasses.replace(
        _scenario(P), backend_options={"device": "cpu"}))
    assert got.outcomes.keys() == ref.outcomes.keys()
    for key, rres in ref.results.items():
        gres = got.results[key]
        assert gres.completed > 0
        assert (gres.violation_rate, gres.per_node_vr,
                gres.token_latency_bands) == \
            (rres.violation_rate, rres.per_node_vr, rres.token_latency_bands)
        assert (gres.total_requests, gres.total_violations, gres.submitted,
                gres.completed, gres.cloud_requests, gres.shed, gres.tokens,
                gres.requests_conserved) == \
            (rres.total_requests, rres.total_violations, rres.submitted,
             rres.completed, rres.cloud_requests, rres.shed, rres.tokens,
             rres.requests_conserved)
        assert [(p.t, p.tenant, p.node, p.kind, p.source)
                for p in gres.placements] == \
            [(p.t, p.tenant, p.node, p.kind, p.source)
             for p in rres.placements]
        for node, rn in rres.node_results.items():
            assert np.array_equal(gres.node_results[node].latencies,
                                  rn.latencies), (key, node)
