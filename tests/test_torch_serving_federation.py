"""The port's serving federation against the JAX package's, scenario by
scenario (CPU).

Serving outcomes come from the virtual clock and token counts alone (a
request ends on its token count; every timestamp is the shared
VirtualClock's), never from the models' numbers. So the port, with its
own weights on ``device="cpu"``, must reproduce the reference EXACTLY:
violation rates, request accounting, placements and failovers, every
latency sample and the token-level latency bands — each field that
tests/test_serving_federation.py reads. Each scenario runs once per
package in a module fixture."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.sim.scenario as R
import repro_torch.sim.scenario as P

SCENARIOS = ("serving_edge_pair", "serving_timeout_retry")


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny tensors: threads only add overhead
    try:
        out = {}
        for name in SCENARIOS:
            sc = dataclasses.replace(P.SCENARIOS[name],
                                     backend_options={"device": "cpu"})
            out[name] = (R.run_scenario(name), P.run_scenario(sc))
        return out
    finally:
        torch.set_num_threads(n)


def _placements(res):
    return [(p.t, p.tenant, p.node, p.kind, p.source) for p in res.placements]


def _actions(res):
    return {node: [[(a.tenant, a.decision.name, a.units, a.terminated_for)
                    for a in acts] for acts in nr.round_actions]
            for node, nr in res.node_results.items()}


def _record(oc):
    """The serialized outcome without its wall-clock fields."""
    return {k: v for k, v in oc.to_record().items()
            if "overhead" not in k and "wall" not in k}


FIELDS = {
    "violation_rate": lambda r: r.violation_rate,
    "accounting": lambda r: (r.total_requests, r.total_violations,
                             r.submitted, r.completed, r.cloud_requests,
                             r.shed, r.tokens, r.requests_conserved),
    "virtual_duration": lambda r: r.virtual_duration_s,
    "faults": lambda r: (r.failed_nodes, r.recovered_nodes, r.replaced,
                         r.cloud),
    "placements": _placements,
    "round_actions": _actions,
    "per_node_vr": lambda r: r.per_node_vr,
    "token_latency_bands": lambda r: r.token_latency_bands,
}


@pytest.mark.parametrize("field", sorted(FIELDS))
@pytest.mark.parametrize("name", SCENARIOS)
def test_port_equals_reference(runs, name, field):
    ref, got = runs[name]
    assert got.outcomes.keys() == ref.outcomes.keys()
    for key in ref.outcomes:
        assert FIELDS[field](got.results[key]) == \
            FIELDS[field](ref.results[key]), (name, key, field)


@pytest.mark.parametrize("name", SCENARIOS)
def test_latency_samples_equal_reference(runs, name):
    ref, got = runs[name]
    for key, rres in ref.results.items():
        gres = got.results[key]
        assert gres.node_results.keys() == rres.node_results.keys()
        for node, rn in rres.node_results.items():
            gn = gres.node_results[node]
            assert np.array_equal(gn.latencies, rn.latencies), (key, node)
            assert np.array_equal(gn.slos, rn.slos), (key, node)
            assert (gn.total_requests, gn.total_violations) == \
                (rn.total_requests, rn.total_violations)


@pytest.mark.parametrize("name", SCENARIOS)
def test_outcome_records_equal_reference(runs, name):
    ref, got = runs[name]
    for key, oc in ref.outcomes.items():
        assert _record(got.outcomes[key]) == _record(oc), (name, key)
    # the headline ordering holds in the port too
    vr = {k: o.violation_rate for k, o in got.outcomes.items()}
    assert vr["sdps"] < vr["none"], vr
