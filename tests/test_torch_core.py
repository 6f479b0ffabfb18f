"""Port vs reference: the control plane (both control planes), the
priority equations and the scorers.

The controller, monitor, quota and forecast modules are carried over as
numpy, so action streams, pool snapshots and scores must be bitwise
equal to the JAX package's. The torch ``batch_scores`` replaces a jnp
float32 scorer and is held to it, and to the float64 numpy scorer, at
f32 tolerance."""
import numpy as np
import pytest
import torch

import repro.core as R
import repro.sim as RS
import repro_torch.core as P
import repro_torch.sim as PS

CONTROL_PLANES = ("reference", "array")
# batch_scores runs in float32: relative agreement to a few f32 ulp
F32_RTOL = 1e-6


# ----------------------------------------------------- controller level
def _controller(pkg, cp, seed=3, n=24, cap=180, policy="sdps", **kw):
    rng = np.random.default_rng(seed)
    ctrl = pkg.DyverseController(
        pkg.NodeCapacity(cap, cap * 8), pkg.ResourceUnit(1, 8),
        policy=policy, default_units=6, control_plane=cp, **kw)
    pricing = [pkg.PricingModel.PFR, pkg.PricingModel.PFP,
               pkg.PricingModel.HYBRID]
    for i in range(n):
        spec = pkg.TenantSpec(
            name=f"t{i:03d}",
            slo_latency=float(rng.uniform(0.05, 0.3)),
            premium=float(rng.random() < 0.3) * float(rng.uniform(0, 5)),
            donation=bool(rng.random() < 0.4),
            pricing=pricing[int(rng.integers(3))])
        ctrl.admit(spec)
    return ctrl


def _feed(ctrl, seed, r):
    rng = np.random.default_rng((seed, r))
    for name in list(ctrl.registry):
        k = int(rng.integers(0, 60))
        lat = rng.lognormal(np.log(0.1), 0.8, size=k)
        ctrl.monitor.record_batch(
            name, lat, ctrl.registry[name].spec.slo_latency,
            data_mb=float(k) * 0.01)
        ctrl.monitor.set_users(name, int(rng.integers(1, 100)))


def _run_rounds(pkg, cp, rounds=8, **kw):
    ctrl = _controller(pkg, cp, **kw)
    stream = []
    for r in range(rounds):
        _feed(ctrl, 99, r)
        rep = ctrl.run_round()
        stream.append([(a.tenant, a.decision.value, a.units, a.priority,
                        a.terminated_for) for a in rep.actions])
        stream.append(list(rep.terminated))
    return ctrl, stream


@pytest.mark.parametrize("cp", CONTROL_PLANES)
@pytest.mark.parametrize("policy,kw", [
    ("sps", {}), ("sdps", {}), ("sdps", {"normalize_factors": True}),
    ("cdps", {"scaling_policy": "proactive"})])
def test_action_streams_bitwise_equal_to_reference(cp, policy, kw):
    ref, s_ref = _run_rounds(R, cp, policy=policy, **kw)
    got, s_got = _run_rounds(P, cp, policy=policy, **kw)
    assert s_got == s_ref
    assert got.snapshot() == ref.snapshot()
    assert got.monitor.total_requests == ref.monitor.total_requests
    assert got.monitor.total_violations == ref.monitor.total_violations


def _node_fingerprint(pkg, cp, kind, engine):
    rng = np.random.default_rng(5)
    fleet = (pkg.make_game_fleet(16, rng) if kind == "game"
             else pkg.make_stream_fleet(16, rng))
    cfg = pkg.SimConfig(duration_s=90, round_interval=1, capacity_units=200,
                        policy="sdps", engine=engine, control_plane=cp,
                        seed=3)
    res = pkg.EdgeNodeSim(fleet, cfg).run()
    acts = [[(a.tenant, a.decision.value, a.units, a.priority,
              a.terminated_for) for a in rnd] for rnd in res.round_actions]
    return (res.violation_rate, res.per_minute_vr, res.terminated, acts,
            res.latencies.tobytes(), res.total_requests)


@pytest.mark.parametrize("cp", CONTROL_PLANES)
@pytest.mark.parametrize("kind,engine", [("game", "batched"),
                                         ("fd", "scalar")])
def test_node_runs_bitwise_equal_to_reference(cp, kind, engine):
    """A node at 1 s rounds: monitor feeds, priorities, placements of
    quota, terminations and every latency, through both planes."""
    assert (_node_fingerprint(PS, cp, kind, engine)
            == _node_fingerprint(RS, cp, kind, engine))


# ------------------------------------------------------------- scorers
def _states(pkg, pricing_name, n, seed):
    rng = np.random.default_rng(seed)
    pricing = getattr(pkg.PricingModel, pricing_name)
    states = []
    for i in range(n):
        spec = pkg.TenantSpec(name="t", slo_latency=0.1,
                              premium=float(rng.random() < 0.5),
                              pricing=pricing)
        st = pkg.TenantState(spec=spec, ordinal=i + 1,
                             quota=pkg.Quota(4, 32))
        st.age, st.loyalty = int(rng.integers(0, 4)), int(rng.integers(0, 6))
        st.scale_count = int(rng.integers(0, 5))
        st.reward_count = int(rng.integers(0, 3))
        states.append(st)
    return states


def _score_args(pkg, states, seed):
    rng = np.random.default_rng(seed + 1)
    n = len(states)
    return ([st.spec.premium for st in states], [st.ordinal for st in states],
            [st.age for st in states], [st.loyalty for st in states],
            [int(x) for x in rng.integers(0, 2000, n)],
            [int(x) for x in rng.integers(0, 100, n)],
            [float(x) for x in rng.uniform(0.0, 50.0, n)],
            [st.reward_count for st in states],
            [st.scale_count for st in states],
            [st.spec.pricing == pkg.PricingModel.PFP for st in states])


@pytest.mark.parametrize("policy", ("sps", "wdps", "cdps", "sdps"))
@pytest.mark.parametrize("pricing", ("PFR", "PFP", "HYBRID"))
def test_scalar_and_numpy_scores_bitwise_equal(policy, pricing):
    for seed in (12, 99):
        rs, ps = _states(R, pricing, 32, seed), _states(P, pricing, 32, seed)
        ra, pa = _score_args(R, rs, seed), _score_args(P, ps, seed)
        assert ([P.priority_score(policy, st, pa[4][i], pa[5][i], pa[6][i])
                 for i, st in enumerate(ps)]
                == [R.priority_score(policy, st, ra[4][i], ra[5][i],
                                     ra[6][i]) for i, st in enumerate(rs)])
        assert np.array_equal(P.batch_scores_np(policy, *pa),
                              R.batch_scores_np(policy, *ra))
        from repro.core.priority import batch_scores_normalized as rn
        from repro_torch.core.priority import batch_scores_normalized as pn
        assert np.array_equal(pn(policy, *pa), rn(policy, *ra))


@pytest.mark.parametrize("policy", ("sps", "wdps", "cdps", "sdps"))
@pytest.mark.parametrize("pricing", ("PFR", "PFP", "HYBRID"))
def test_torch_batch_scores_match_numpy_and_jnp(policy, pricing):
    states = _states(P, pricing, 48, 7)
    args = _score_args(P, states, 7)
    got = P.batch_scores(policy, *args, device="cpu")
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, P.batch_scores_np(policy, *args),
                               rtol=F32_RTOL)
    rstates = _states(R, pricing, 48, 7)
    jnp_scores = np.asarray(R.batch_scores(policy,
                                           *_score_args(R, rstates, 7)))
    np.testing.assert_allclose(got, jnp_scores, rtol=F32_RTOL)
