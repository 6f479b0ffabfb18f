"""``engine="serving"``: the REAL multi-tenant LLM engine
(:mod:`repro_torch.serving.federation`) behind the backend registry.

Not node-capable: a serving run owns its own node objects (real engines
with decode slots and KV pools), so ``EdgeNodeSim`` never steps it —
the backend exists to fold the scenario-level special cases (spec
validation, smoke sizing, reported duration, run dispatch) into the
same seam every other engine uses. Heavy imports stay inside the
methods: validating or tabulating a serving scenario loads no model
code, only actually running one pulls the engine in.

Backend option ``device`` (default ``"cuda"``): where every engine's
models and caches live. It is checked before any node is built; without
a card, ``"cuda"`` raises rather than falling back to the CPU."""
from __future__ import annotations

from repro_torch.kernels.fleet import check_device
from repro_torch.sim.engines.base import EngineBackend


class ServingBackend(EngineBackend):
    name = "serving"
    contract = "token-level"
    rng_scheme = "engine-owned"
    node_capable = False
    when_to_use = "real LLM engine under the same control plane"

    def tenant_rng(self, seed: int, name: str) -> tuple:
        raise NotImplementedError(
            "engine='serving' owns its request streams; it has no "
            "per-tenant simulator RNG")

    def validate_scenario(self, scenario) -> None:
        if scenario.serving is None:
            raise ValueError(f"scenario {scenario.name!r} has "
                             f"engine='serving' but no ServingSpec")
        if tuple(scenario.scaling_policies) != ("reactive",):
            raise ValueError("engine='serving' supports only the "
                             "reactive scaling policy for now")
        for wl in scenario.fleet.build():
            scenario.serving.class_for(wl.name)   # raises on no match
        check_device(scenario.backend_options.get("device", "cuda"))

    def scenario_duration(self, scenario) -> float:
        # serving cadence lives in the ServingSpec's virtual clock
        return scenario.serving.duration_virtual_s

    def quick_scenario(self, scenario, round_interval: int, rounds: int):
        # rounds × steps × step_dt is already smoke-sized
        return scenario

    def run_federation(self, fleet, cfg, scenario=None):
        # lazy: pulls the model code only when a serving scenario runs
        from repro_torch.serving.federation import ServingFederation

        if scenario is None or scenario.serving is None:
            raise ValueError("engine='serving' needs a Scenario with a "
                             "ServingSpec")
        return ServingFederation(
            fleet, cfg, scenario.serving,
            device=cfg.backend_options.get("device", "cuda")).run()
