"""Port vs reference: the numpy simulator layer, bitwise.

``repro_torch.sim`` carries the workloads, the three numpy engines, the
federation and the scenario registry over unchanged, so every
non-serving registry scenario must give bitwise-identical results in
both packages: violation rates, per-node rates, placements, Cloud
fallbacks and every node's latencies (by sha256)."""
import dataclasses
import hashlib

import numpy as np
import pytest

import repro.sim as R
import repro_torch.sim as P

SIM_SCENARIOS = [n for n, sc in R.SCENARIOS.items() if sc.engine != "serving"]


def _fingerprint(res):
    out = {}
    for key in res.outcomes:
        oc, fr = res.outcomes[key], res.results[key]
        h = hashlib.sha256()
        for name in sorted(fr.node_results):
            h.update(fr.node_results[name].latencies.tobytes())
        out[key] = dict(
            vr=oc.violation_rate, per_node_vr=oc.per_node_vr,
            bands=oc.band_fractions, replaced=oc.replaced, cloud=oc.cloud,
            recovered=oc.recovered,
            placements=[dataclasses.astuple(p) for p in fr.placements],
            replaced_names=fr.replaced, cloud_names=fr.cloud,
            failed=fr.failed_nodes, total=fr.total_requests,
            actions=[[[(a.tenant, a.decision.value, a.units, a.priority,
                        a.terminated_for) for a in rnd]
                      for rnd in nr.round_actions]
                     for _, nr in sorted(fr.node_results.items())],
            lat_sha=h.hexdigest())
    return out


def _both(name, engine, **kw):
    ref = R.run_scenario(dataclasses.replace(R.SCENARIOS[name],
                                             engine=engine, **kw), quick=True)
    got = P.run_scenario(dataclasses.replace(P.SCENARIOS[name],
                                             engine=engine, **kw), quick=True)
    return ref, got


def test_registry_mirrors_reference():
    assert list(P.SCENARIOS) == list(R.SCENARIOS)
    assert len(P.SCENARIOS) == 12
    for name, sc in R.SCENARIOS.items():
        assert P.SCENARIOS[name].description == sc.description


@pytest.mark.parametrize("engine", ["batched", "vectorized"])
@pytest.mark.parametrize("name", SIM_SCENARIOS)
def test_scenario_bitwise_equal_to_reference(name, engine):
    ref, got = _both(name, engine)
    assert _fingerprint(got) == _fingerprint(ref)


@pytest.mark.parametrize("name", ["paper_game_32", "paper_face_detection",
                                  "node_failure_midrun"])
def test_scalar_engine_bitwise_equal_to_reference(name):
    ref, got = _both(name, "scalar", policies=("none", "sdps"))
    assert _fingerprint(got) == _fingerprint(ref)


def test_traced_run_bitwise_equal_to_reference():
    ref, got = _both("flapping_node", "batched", trace=True)
    assert _fingerprint(got) == _fingerprint(ref)
    for key in ref.results:
        ek = [(e.kind, e.t, e.node, e.tenant, e.cause)
              for e in ref.results[key].events if e.kind != "chunk"
              and e.kind != "round"]
        gk = [(e.kind, e.t, e.node, e.tenant, e.cause)
              for e in got.results[key].events if e.kind != "chunk"
              and e.kind != "round"]
        assert gk == ek and gk


def test_serving_scenarios_rejected_by_registry():
    """The serving backend's validation refuses a serving scenario it
    cannot run: one with no ServingSpec, or one whose fleet a class
    spec does not cover (the serving scenarios themselves run, and are
    held to the reference in tests/test_torch_serving_federation.py)."""
    sc = P.SCENARIOS["serving_edge_pair"]
    with pytest.raises(ValueError, match="no ServingSpec"):
        P.run_scenario(dataclasses.replace(sc, serving=None), quick=True)
    bad = dataclasses.replace(sc.serving, classes=sc.serving.classes[:1])
    with pytest.raises(ValueError, match="ServingClassSpec"):
        P.run_scenario(dataclasses.replace(sc, serving=bad), quick=True)


def _mixed_batch(pkg):
    rng = np.random.default_rng(42)
    return pkg.FleetBatch(pkg.make_game_fleet(7, rng)
                          + pkg.make_stream_fleet(5, rng))


def test_jit_scale_path_matches_numpy():
    """The port's ``jit_scale`` path (torch float64 on the named device)
    against numpy ``FleetBatch.latency_scale`` at rtol 1e-12."""
    fb = _mixed_batch(P)
    units = np.array([16, 3, 10 ** 6, 7, 1, 2, 9, 16, 4, 8, 5, 16], np.int64)
    ref = fb.latency_scale(units, 240, 553)
    got = fb.latency_scale(units, 240, 553, device="cpu")
    assert got.dtype == np.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_array_equal(
        ref, _mixed_batch(R).latency_scale(units, 240, 553))


def test_jit_scale_option_runs_batched_engine_on_device():
    sc = dataclasses.replace(P.SCENARIOS["mixed_fleet"], engine="batched",
                             policies=("sdps",))
    plain = P.run_scenario(sc, quick=True)
    jit = P.run_scenario(dataclasses.replace(
        sc, backend_options={"jit_scale": "cpu"}), quick=True)
    assert abs(plain.outcomes["sdps"].violation_rate
               - jit.outcomes["sdps"].violation_rate) < 1e-9
