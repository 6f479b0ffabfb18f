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
    assert set(ENGINE_BACKENDS) == set(ENGINES) | {"serving"}
    for name in ("scalar", "vectorized", "batched"):
        b = resolve_engine(name)
        assert (b.contract, b.rng_scheme) == ("bitwise", "numpy-substream")
    b = resolve_engine("torch")
    assert (b.name, b.contract, b.rng_scheme) == (
        "torch", "tolerance", "counter-threefry")
    b = resolve_engine("serving")
    assert (b.name, b.contract, b.rng_scheme, b.node_capable) == (
        "serving", "token-level", "engine-owned", False)
    with pytest.raises(ValueError, match="engine"):
        resolve_engine("no-such-engine")


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


# ---------------------------------------------------------- row sharding
def _odd_fleet_scenario(kind):
    """One node of an odd number of tenants (a row is padded on two
    devices): 7 game tenants (Poisson arrivals, the varying-scale path),
    7 slow streams (the dense path) or 7 fast streams (the const
    path)."""
    from repro_torch.sim.workload import (StreamWorkload, make_game_fleet,
                                          make_stream_fleet)

    rng = np.random.default_rng(11)
    if kind == "game":
        wls = tuple(make_game_fleet(7, rng))
    elif kind == "stream":
        wls = tuple(make_stream_fleet(7, rng))
    else:
        wls = tuple(StreamWorkload(name=f"fast-{i}", base_latency=2.13,
                                   work_per_request=8.0, unit_rate=1.0,
                                   fps=float(rng.uniform(1.5, 3.0)))
                    for i in range(7))
    return Scenario(name=f"odd_{kind}", fleet=FleetSpec(workloads=wls),
                    topology=TopologySpec(n_nodes=1, capacity_units=60),
                    engine="torch", duration_s=180, round_interval=60)


@pytest.mark.parametrize("kind,opts", [("game", {}), ("stream", {}),
                                       ("fast", {}),
                                       ("game", {"scale_kernel": True})])
def test_torch_shard_over_two_devices_is_bitwise_one_device(
        kind, opts, monkeypatch):
    """shard=True over two (patched) devices pads the odd fleet to an
    even row count, runs each half on its device and slices the padded
    row away: latencies, violation rates and control outcomes equal the
    unsharded run bit for bit, as the per-row keys promise."""
    import torch

    from repro_torch.sim.engines import torch_backend as tb

    sc = _odd_fleet_scenario(kind)
    one = run_scenario(dataclasses.replace(
        sc, backend_options=dict(CPU, shard=False, **opts)))
    seen = []

    def two_cpus(device):
        seen.append(device)
        return [torch.device("cpu"), torch.device("cpu")]
    monkeypatch.setattr(tb, "visible_devices", two_cpus)
    two = run_scenario(dataclasses.replace(
        sc, backend_options=dict(CPU, **opts)))
    assert seen, "the sharded run never asked for its devices"
    assert one.outcomes.keys() == two.outcomes.keys()
    for k in one.outcomes:
        a, b = one.outcomes[k], two.outcomes[k]
        # every simulated field (the round overheads are wall clocks)
        for f in ("violation_rate", "per_node_vr", "band_fractions",
                  "replaced", "cloud", "recovered", "shed"):
            assert getattr(a, f) == getattr(b, f), (k, f)
        assert one.results[k].total_requests > 0
    assert _lat_digest(one) == _lat_digest(two)


def test_torch_shard_pads_rows_to_the_device_count(monkeypatch):
    import torch

    from repro_torch.sim.engines import torch_backend as tb

    monkeypatch.setattr(tb, "visible_devices", lambda d: [
        torch.device("cpu")] * 3)
    fleet = P.make_game_fleet(7, np.random.default_rng(1))
    node = P.EdgeNodeSim(fleet, P.SimConfig(engine="torch",
                                            backend_options=CPU))
    st = tb.TorchFleetStepper([node])
    st._rebuild()
    assert st._Tp == 9
    assert [(lo, hi) for _, lo, hi in st._shards] == [(0, 3), (3, 6),
                                                      (6, 9)]
    # the padded rows' keys are zeros; the tenants' are the unsharded ones
    keys = np.concatenate([r[0].numpy() for r in st._rows])
    assert np.array_equal(keys[:7].view(np.uint32), st._k0)
    assert not keys[7:].any()
    node1 = P.EdgeNodeSim(fleet, P.SimConfig(
        engine="torch", backend_options=dict(CPU, shard=False)))
    st1 = tb.TorchFleetStepper([node1])
    st1._rebuild()
    assert st1._Tp == 7 and len(st1._shards) == 1
