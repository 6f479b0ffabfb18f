"""The three bitwise-pinned numpy engines behind the backend registry.

All three realise the identical random trace (per-tenant numpy
Generator substreams, see :func:`repro_torch.sim.engines.base.tenant_stream`)
and evaluate the identical float64 expressions element for element, so
violation rates, per-minute timelines and termination lists are bitwise
equal across them — only wall-clock differs. The heavy lifting stays in
:mod:`repro_torch.sim.edgesim` (``EdgeNodeSim._step_chunk_*``,
``FleetStepper``); these classes are the dispatch seam only, imported
lazily at call time to keep ``repro_torch.sim.engines`` importable before
``repro_torch.sim.edgesim`` finishes loading (edgesim imports the registry at
module level)."""
from __future__ import annotations

from repro_torch.sim.engines.base import EngineBackend


class ScalarBackend(EngineBackend):
    name = "scalar"
    contract = "bitwise"
    rng_scheme = "numpy-substream"
    when_to_use = "reference semantics; tiny fleets, debugging"

    def step_node(self, node, t0: int, t1: int) -> None:
        node._step_chunk_scalar(t0, t1)


class VectorizedBackend(EngineBackend):
    name = "vectorized"
    contract = "bitwise"
    rng_scheme = "numpy-substream"
    when_to_use = "default; O(1) numpy calls per tenant per chunk"

    def step_node(self, node, t0: int, t1: int) -> None:
        node._step_chunk_vectorized(t0, t1)


class BatchedBackend(EngineBackend):
    name = "batched"
    contract = "bitwise"
    rng_scheme = "numpy-substream"
    when_to_use = "large fleets (10^2-10^4 tenants); one stacked matrix per chunk"

    def make_stepper(self, nodes: list):
        from repro_torch.sim.edgesim import FleetStepper

        return FleetStepper(nodes)
