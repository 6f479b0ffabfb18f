"""engine="torch": registry contract, tolerance equivalence vs the
batched engine and vs the reference's engine="jax", and counter-RNG
invariances. Every run here uses ``device="cpu"``, i.e. the kernels'
plain torch versions, which draw the same bits as the CUDA kernels.

Against batched the contract is statistical (different random bits,
float32 math, dense reductions): |ΔVR| < 0.02, identical discrete
control-plane outcomes, mean latency within 5 %. Against engine="jax"
on stream fleets it is much tighter: the same key words, the same
closed-form arrivals and the same jitter uniforms leave only erfinv/exp
ulps, so |ΔVR| ≤ 1e-3."""
import dataclasses
import hashlib

import numpy as np
import pytest

import repro.sim as R
import repro_torch.sim as P
from repro_torch.sim import (ENGINE_BACKENDS, ENGINES, SCENARIOS, FleetSpec,
                             Scenario, TopologySpec, engine_matrix,
                             resolve_engine, run_scenario)

VR_TOL = 0.02
JAX_STREAM_VR_TOL = 1e-3
CPU = {"device": "cpu"}


def _quick(name, engine, **opts):
    sc = dataclasses.replace(SCENARIOS[name], engine=engine,
                             backend_options=dict(opts))
    return run_scenario(sc, quick=True)


def _torch(name, **opts):
    return _quick(name, "torch", **CPU, **opts)


# ------------------------------------------------------------- registry
def test_registry_contracts():
    assert set(ENGINES) == {"scalar", "vectorized", "batched", "torch"}
    assert set(ENGINE_BACKENDS) == set(ENGINES)
    for name in ("scalar", "vectorized", "batched"):
        b = resolve_engine(name)
        assert (b.contract, b.rng_scheme) == ("bitwise", "numpy-substream")
    b = resolve_engine("torch")
    assert (b.name, b.contract, b.rng_scheme) == (
        "torch", "tolerance", "counter-threefry")
    with pytest.raises(ValueError, match="serving"):
        resolve_engine("serving")


def test_engine_matrix_reflects_registry():
    import repro_torch.sim as sim

    m = engine_matrix()
    for name, b in ENGINE_BACKENDS.items():
        assert name in m and b.contract in m and b.rng_scheme in m
        assert name in sim.__doc__


# ------------------------------------------- tolerance vs batched engine
def _mean_latency(res, key):
    return np.mean(np.concatenate(
        [r.latencies for r in res.results[key].node_results.values()]))


@pytest.mark.parametrize("scenario", ["mixed_fleet", "paper_game_32",
                                      "node_failure_midrun"])
def test_torch_matches_batched_within_tolerance(scenario):
    rb = _quick(scenario, "batched")
    rt = _torch(scenario)
    assert rb.outcomes.keys() == rt.outcomes.keys()
    for k in rb.outcomes:
        ob, ot = rb.outcomes[k], rt.outcomes[k]
        assert abs(ob.violation_rate - ot.violation_rate) < VR_TOL, k
        assert ob.replaced == ot.replaced, k
        assert ob.cloud == ot.cloud, k
        assert rb.results[k].failed_nodes == rt.results[k].failed_nodes
        assert rt.results[k].total_requests > 0
        mb, mt = _mean_latency(rb, k), _mean_latency(rt, k)
        assert abs(mb - mt) / mb < 0.05, k


# ------------------------------------------------ against engine="jax"
@pytest.mark.parametrize("scenario", ["paper_face_detection",
                                      "proactive_face_detection"])
def test_torch_matches_jax_engine_on_stream_fleets(scenario):
    rj = R.run_scenario(dataclasses.replace(R.SCENARIOS[scenario],
                                            engine="jax"), quick=True)
    rt = _torch(scenario)
    assert rj.outcomes.keys() == rt.outcomes.keys()
    for k in rj.outcomes:
        oj, ot = rj.outcomes[k], rt.outcomes[k]
        assert abs(oj.violation_rate - ot.violation_rate) \
            <= JAX_STREAM_VR_TOL, k
        assert (oj.replaced, oj.cloud) == (ot.replaced, ot.cloud), k


def test_torch_matches_jax_engine_on_multi_frame_streams():
    """Streams above 1 fps take the const path (time-invariant scale,
    several requests a second): the fused kernel against _fused_impl."""
    from repro.sim.workload import StreamWorkload as RW
    from repro_torch.sim.workload import StreamWorkload as PW

    def scenario(pkg, cls, **kw):
        rng = np.random.default_rng(4)
        wls = tuple(cls(name=f"fast-{i}", base_latency=2.13,
                        work_per_request=8.0, unit_rate=1.0,
                        fps=float(rng.uniform(1.5, 3.0)))
                    for i in range(12))
        return pkg.Scenario(name="fast_streams",
                            fleet=pkg.FleetSpec(workloads=wls),
                            topology=pkg.TopologySpec(n_nodes=2,
                                                      capacity_units=200),
                            duration_s=240, round_interval=60, **kw)

    rj = R.run_scenario(scenario(R, RW, engine="jax"))
    rt = run_scenario(scenario(P, PW, engine="torch",
                               backend_options=CPU))
    for k in rj.outcomes:
        assert abs(rj.outcomes[k].violation_rate
                   - rt.outcomes[k].violation_rate) <= JAX_STREAM_VR_TOL, k
        assert rt.results[k].total_requests > 12 * 240


def test_scale_kernel_matches_jax_pallas_option():
    rj = R.run_scenario(dataclasses.replace(
        R.SCENARIOS["paper_game_32"], engine="jax",
        backend_options={"pallas": True}), quick=True)
    rt = _torch("paper_game_32", scale_kernel=True)
    for k in rj.outcomes:
        assert abs(rj.outcomes[k].violation_rate
                   - rt.outcomes[k].violation_rate) < VR_TOL, k


# --------------------------------------------------------- determinism
def _lat_digest(res):
    h = hashlib.sha256()
    for key in sorted(res.results):
        for name in sorted(res.results[key].node_results):
            h.update(res.results[key].node_results[name].latencies.tobytes())
    return h.hexdigest()


def test_torch_repeated_runs_bitwise_identical():
    a, b = _torch("mixed_fleet"), _torch("mixed_fleet")
    for k in a.outcomes:
        assert a.outcomes[k].violation_rate == b.outcomes[k].violation_rate
    assert _lat_digest(a) == _lat_digest(b)


def test_torch_invariant_to_rng_workers():
    sc = dataclasses.replace(SCENARIOS["mixed_fleet"], engine="torch",
                             backend_options=CPU, policies=("sdps",))
    a = run_scenario(dataclasses.replace(sc, rng_workers=1), quick=True)
    b = run_scenario(dataclasses.replace(sc, rng_workers=4), quick=True)
    assert _lat_digest(a) == _lat_digest(b)


def test_torch_rejects_opaque_custom_workload():
    from repro_torch.sim.workload import GameWorkload

    @dataclasses.dataclass
    class Mystery(GameWorkload):
        # inherits Poisson arrivals but hides the rate declaration
        batch_arrival_lam = None
        arrival_rng_free = False

    wl = Mystery(name="m0", base_latency=0.1, work_per_request=1.0,
                 unit_rate=2.0)
    sc = Scenario(name="mystery", fleet=FleetSpec(workloads=(wl,)),
                  topology=TopologySpec(n_nodes=1), engine="torch",
                  backend_options=CPU, policies=("none",), duration_s=60,
                  round_interval=60)
    with pytest.raises(ValueError, match="batched"):
        run_scenario(sc)
