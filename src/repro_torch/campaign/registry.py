"""Named campaigns: the sweep grids the repo's evaluations share.

The grids here are the single declaration of the repo's standing
sweeps — the bench sections
(:mod:`repro_torch.benchmarks.federation_bench`) iterate the SAME grid
cells the campaign CLI (``python -m repro_torch.benchmarks.campaign``)
fans out, so "what does the
scenarios/forecast/resilience sweep cover" has exactly one answer.

``CAMPAIGNS`` maps names (``--campaign <name>`` /
``--list-campaigns``) to :class:`~repro_torch.campaign.spec.CampaignSpec`
instances; ``ci`` is the default gate campaign — every registry
scenario across the vectorized/batched/torch/serving engines, both
scaling-policy extremes (reactive and proactive), both control planes,
and the fedscale engine-pair fleet.
"""
from __future__ import annotations

from repro_torch.campaign.spec import CampaignSpec, SweepGrid
from repro_torch.sim.scenario import (FleetSpec, Scenario, TenantClassSpec,
                                      TopologySpec)

#: the chaos scenarios of the resilience sweep (one source of truth;
#: :mod:`repro_torch.benchmarks.federation_bench` imports this).
CHAOS_SCENARIOS = ("flapping_node", "degraded_node_midrun",
                   "wan_spike_storm", "serving_timeout_retry")


def fleet_scenario(workload: str, n_nodes: int, per_node: int,
                   duration: int, round_interval: int,
                   seed: int = 7) -> Scenario:
    """An inline fedscale fleet: ``n_nodes × per_node`` tenants of one
    workload class at paper capacity (+16u headroom) — the scenario
    form of the tuples ``fleet_scale_sweep`` used to hand-wire."""
    kind = "stream" if workload == "stream" else "game"
    return Scenario(
        name=f"fleet_{workload}_{n_nodes}x{per_node}_ri{round_interval}",
        description=f"fedscale fleet: {n_nodes}×{per_node} {workload} "
                    f"tenants, {duration}s @ {round_interval}s rounds",
        fleet=FleetSpec(classes=(
            TenantClassSpec(kind, n_nodes * per_node),)),
        topology=TopologySpec(n_nodes=n_nodes, headroom=16),
        duration_s=duration, round_interval=round_interval, seed=seed,
        policies=("none", "sdps"))


#: the fedscale configs (workload, n_nodes, per_node, duration, ri) —
#: full mode sweeps ≥1M tenant-seconds, quick is the CI smoke size.
FEDSCALE_CONFIGS = (
    ("stream", 4, 32, 8000, 300),
    ("stream", 4, 32, 8000, 150),
    ("game", 4, 32, 3072, 300),
)
FEDSCALE_QUICK_CONFIGS = (("stream", 2, 8, 600, 300),)

#: every registry scenario × the two array engines + the serving
#: engine × both priority-policy extremes × both scaling extremes
#: (validity masking pairs serving scenarios with the serving engine
#: and collapses inert axes).
MAIN_GRID = SweepGrid(
    scenarios=("*",),
    engines=("vectorized", "batched", "serving"),
    policies=("none", "sdps"),
    scaling_policies=("reactive", "proactive"),
)

#: the torch engine against its batched reference on the streaming
#: paper fleet (the dense fast path the GPU kernels are built for).
TORCH_GRID = SweepGrid(
    scenarios=("paper_face_detection",),
    engines=("batched", "torch"),
    policies=("none", "sdps"),
    scaling_policies=("reactive",),
)

#: array vs reference control plane on the mixed fleet (exact-equality
#: consistency group in the report).
CTRL_GRID = SweepGrid(
    scenarios=("mixed_fleet",),
    engines=("batched",),
    control_planes=("array", "reference"),
    policies=("sdps",),
    scaling_policies=("reactive",),
)

#: reactive vs proactive vs hybrid at an equal budget on the two
#: proactive scenarios (scaling axis inherited from the scenarios'
#: declared three-way sweep) — the ``forecast`` bench section.
FORECAST_GRID = SweepGrid(
    scenarios=("proactive_game_32", "proactive_face_detection"),
    policies=("sdps",),
)

#: the chaos scenarios under every policy they declare — the
#: ``resilience`` bench section.
RESILIENCE_GRID = SweepGrid(scenarios=CHAOS_SCENARIOS)

#: every registry scenario, primary policy, first scaling policy — the
#: ``scenarios`` bench section (scenario walls).
SCENARIO_WALLS_GRID = SweepGrid(
    scenarios=("*",),
    policies=("sdps",),
    scaling_policies=("reactive",),
)

#: batched vs vectorized on the fedscale fleets (``fedscale``).
ENGINE_GRID = SweepGrid(
    scenarios=tuple(fleet_scenario(*c) for c in FEDSCALE_CONFIGS),
    engines=("vectorized", "batched"),
    policies=("none", "sdps"),
    scaling_policies=("reactive",),
)
ENGINE_GRID_QUICK = SweepGrid(
    scenarios=tuple(fleet_scenario(*c) for c in FEDSCALE_QUICK_CONFIGS),
    engines=("vectorized", "batched"),
    policies=("none", "sdps"),
    scaling_policies=("reactive",),
)


CAMPAIGNS: dict[str, CampaignSpec] = {
    "ci": CampaignSpec(
        name="ci",
        description="the gate campaign: every registry scenario × "
                    "vectorized/batched/torch/serving × none/sdps × "
                    "reactive/proactive, plus control-plane, forecast "
                    "and fedscale-pair groups",
        grids=(MAIN_GRID, TORCH_GRID, CTRL_GRID, FORECAST_GRID,
               ENGINE_GRID_QUICK),
    ),
    "registry": CampaignSpec(
        name="registry",
        description="scenario walls: every registry scenario, primary "
                    "policy (the `scenarios` bench section)",
        grids=(SCENARIO_WALLS_GRID,),
    ),
    "forecast": CampaignSpec(
        name="forecast",
        description="reactive vs proactive vs hybrid scaling on the "
                    "proactive scenarios (the `forecast` bench section)",
        grids=(FORECAST_GRID,),
    ),
    "resilience": CampaignSpec(
        name="resilience",
        description="the chaos scenarios under every declared policy "
                    "(the `resilience` bench section)",
        grids=(RESILIENCE_GRID,),
    ),
    "engines": CampaignSpec(
        name="engines",
        description="batched vs vectorized on the fedscale fleets "
                    "(the `fedscale` bench section; full-size)",
        grids=(ENGINE_GRID,),
    ),
}


def campaign_names() -> tuple[str, ...]:
    return tuple(CAMPAIGNS)


def get_campaign(name: str) -> CampaignSpec:
    spec = CAMPAIGNS.get(name)
    if spec is None:
        raise ValueError(f"unknown campaign {name!r}; have "
                         f"{sorted(CAMPAIGNS)}")
    return spec


def format_campaigns() -> str:
    """One line per campaign (the ``--list-campaigns`` output)."""
    return "\n".join(f"{name:<12} {spec.description}"
                     for name, spec in CAMPAIGNS.items())
