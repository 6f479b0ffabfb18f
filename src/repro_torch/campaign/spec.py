"""Campaign specs: typed sweep grids expanded into run cells.

A :class:`SweepGrid` declares one rectangular sweep over the scenario
axes (scenario × engine × control_plane × placement × priority policy ×
scaling policy × forecaster × seed × backend options); a
:class:`CampaignSpec` is a named union of grids plus include/exclude
filters and a per-cell timeout. :func:`expand_campaign` lowers a spec
deterministically into an ordered list of :class:`RunSpec` cells —
grid order, then axis nesting order — applying per-axis validity
masking (see :func:`mask_reason`) and de-duplicating identical cells,
so the same spec always produces the same cell list in the same order.

Axis semantics
==============

Every axis is a tuple; the EMPTY tuple means "inherit from the
scenario" — ``engines=()`` runs each scenario on its own declared
engine, ``policies=()`` sweeps the scenario's own priority-policy
list, ``scaling_policies=()`` its declared scaling sweep, and so on.
``scenarios`` entries are registry names, the literal ``"*"`` (every
:data:`repro_torch.sim.scenario.SCENARIOS` entry at expansion time), or
inline :class:`~repro_torch.sim.scenario.Scenario` objects.

Validity masking
================

Invalid (scenario, axis) combinations are masked out of the grid
instead of failing at run time, and redundant cells (axes that are
inert for a combination) are masked so a grid never runs the same
configuration twice under two labels:

* serving scenarios (a :class:`ServingSpec` attached) run ONLY on the
  ``serving`` engine, and vice versa;
* the serving engine supports only ``reactive`` scaling and the
  ``array`` control plane;
* the ``scale_kernel`` backend option is torch-only, ``device``
  belongs to the torch and serving engines, ``jit_scale`` is
  batched-only;
* under ``reactive`` scaling the forecaster axis is inert (collapsed
  to the grid's first forecaster);
* under the ``none`` priority policy the scaling-policy axis is inert
  (collapsed to the grid's first scaling policy).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.sim.scenario import SCENARIOS, Scenario

#: the engines that take a ``device`` backend option (the rest are
#: numpy on the host).
DEVICE_ENGINES = ("torch", "serving")

#: backend_options keys that are only meaningful on specific engines
#: (the validity-masking table; unknown keys pass through untouched and
#: are the target engine's problem).
OPTION_ENGINES: dict[str, tuple[str, ...]] = {
    "scale_kernel": ("torch",),
    "device": DEVICE_ENGINES,
    "jit_scale": ("batched",),
}

#: the RunSpec axes a filter may name (cell identity, minus options).
FILTER_AXES = ("scenario", "engine", "control_plane", "placement",
               "policy", "scaling_policy", "forecaster", "seed")


@dataclass(frozen=True)
class SweepGrid:
    """One rectangular sweep. Empty axes inherit the scenario's own
    values (see module docstring)."""

    scenarios: tuple = ("*",)           # names | "*" | Scenario objects
    engines: tuple[str, ...] = ()
    control_planes: tuple[str, ...] = ()
    placements: tuple[str, ...] = ()
    policies: tuple[str, ...] = ()      # priority policies (SWEEP_POLICIES)
    scaling_policies: tuple[str, ...] = ()
    forecasters: tuple[str, ...] = ()
    seeds: tuple[int, ...] = ()
    # tuple of option-sets, each a tuple of (key, value) pairs merged
    # into the scenario's backend_options; ((),) = scenario's own only
    backend_options: tuple[tuple, ...] = ((),)


@dataclass(frozen=True)
class CampaignSpec:
    """A named campaign: grids + filters + execution defaults."""

    name: str
    grids: tuple[SweepGrid, ...]
    description: str = ""
    # include: keep cells matching ANY filter (empty = keep all);
    # exclude: then drop cells matching ANY filter. A filter is a
    # mapping of axis name -> value or tuple of values, matching a cell
    # when EVERY named axis's cell value is among the allowed values.
    include: tuple = ()
    exclude: tuple = ()
    cell_timeout_s: float = 900.0


@dataclass(frozen=True)
class RunSpec:
    """One expanded campaign cell: a scenario pinned to one value per
    axis. ``scenario`` is the resolved spec object; cell identity (for
    de-duplication, reports and baselines) is :attr:`key`, which uses
    only the scenario's name."""

    scenario: Scenario
    engine: str
    control_plane: str
    placement: str
    policy: str
    scaling_policy: str
    forecaster: str
    seed: int
    options: tuple = ()                 # extra backend_options pairs

    @property
    def key(self) -> tuple:
        return (self.scenario.name, self.engine, self.control_plane,
                self.placement, self.policy, self.scaling_policy,
                self.forecaster, self.seed, self.options)

    @property
    def cell_id(self) -> str:
        opts = "".join(f"+{k}={v}" for k, v in self.options)
        return (f"{self.scenario.name}/{self.engine}/{self.control_plane}/"
                f"{self.placement}/{self.policy}/{self.scaling_policy}/"
                f"{self.forecaster}/s{self.seed}{opts}")

    def axis_value(self, axis: str):
        if axis == "scenario":
            return self.scenario.name
        return getattr(self, axis)

    def scenario_with_axes(self) -> Scenario:
        """The scenario this cell actually runs: the grid axes applied
        over the registry spec (the scenario.py grid hook)."""
        opts = dict(self.scenario.backend_options)
        opts.update(dict(self.options))
        return dataclasses.replace(
            self.scenario, engine=self.engine,
            control_plane=self.control_plane, placement=self.placement,
            forecaster=self.forecaster, seed=self.seed,
            backend_options=opts)

    def record_stub(self) -> dict:
        """The axes half of this cell's result record (the executor
        fills in status + outcome)."""
        return {
            "cell": self.cell_id,
            "scenario": self.scenario.name,
            "engine": self.engine,
            "control_plane": self.control_plane,
            "placement": self.placement,
            "policy": self.policy,
            "scaling_policy": self.scaling_policy,
            "forecaster": self.forecaster,
            "seed": self.seed,
            "options": [list(kv) for kv in self.options],
        }


def _is_serving_scenario(sc: Scenario) -> bool:
    return sc.serving is not None or sc.engine == "serving"


def mask_reason(sc: Scenario, engine: str, control_plane: str,
                policy: str, scaling_policy: str, forecaster: str,
                options: tuple, *, first_scaling: str,
                first_forecaster: str) -> str | None:
    """Why this (scenario, axis-values) combination is masked out of
    the grid, or ``None`` when the cell is valid and non-redundant."""
    if _is_serving_scenario(sc) and engine != "serving":
        return (f"serving scenario {sc.name!r} only runs on the serving "
                f"engine (not {engine!r})")
    if engine == "serving":
        if sc.serving is None:
            return (f"engine='serving' needs a ServingSpec; scenario "
                    f"{sc.name!r} has none")
        if scaling_policy != "reactive":
            return ("the serving engine supports only reactive scaling "
                    f"(not {scaling_policy!r})")
        if control_plane != "array":
            return ("the serving engine owns its controllers; only the "
                    f"array control plane is valid (not {control_plane!r})")
    for k, _ in options:
        allowed = OPTION_ENGINES.get(k)
        if allowed is not None and engine not in allowed:
            return (f"backend option {k!r} is only valid on "
                    f"{'/'.join(allowed)} (engine is {engine!r})")
    if scaling_policy == "reactive" and forecaster != first_forecaster:
        return (f"forecaster axis is inert under reactive scaling "
                f"(collapsed to {first_forecaster!r})")
    if policy == "none" and scaling_policy != first_scaling:
        return (f"scaling-policy axis is inert under policy='none' "
                f"(collapsed to {first_scaling!r})")
    return None


def _resolve_scenarios(entries: tuple) -> list[Scenario]:
    out: list[Scenario] = []
    for entry in entries:
        if isinstance(entry, Scenario):
            out.append(entry)
        elif entry == "*":
            out.extend(SCENARIOS.values())
        elif entry in SCENARIOS:
            out.append(SCENARIOS[entry])
        else:
            raise ValueError(f"unknown scenario {entry!r}; have "
                             f"{sorted(SCENARIOS)} (or pass a Scenario)")
    return out


def _validate_axes(grid: SweepGrid) -> None:
    """Name-level axis validation — deliberately does NOT resolve engine
    backends (the lazy torch backend must not be imported just to
    expand a grid; full Scenario.validate runs inside each cell's
    worker)."""
    from repro_torch.core.forecast import FORECASTERS, SCALING_POLICIES
    from repro_torch.sim.engines import engine_names
    from repro_torch.sim.federation import PLACEMENTS, SWEEP_POLICIES

    def check(values, universe, what):
        bad = [v for v in values if v not in universe]
        if bad:
            raise ValueError(f"unknown {what} {bad}; have "
                             f"{sorted(universe)}")

    check(grid.engines, engine_names(), "engines")
    check(grid.control_planes, ("array", "reference"), "control planes")
    check(grid.placements, PLACEMENTS, "placements")
    check(grid.policies, SWEEP_POLICIES, "policies")
    check(grid.scaling_policies, SCALING_POLICIES, "scaling policies")
    check(grid.forecasters, FORECASTERS, "forecasters")
    for s in grid.seeds:
        if not isinstance(s, int):
            raise ValueError(f"seeds must be ints, got {s!r}")


def _filter_matches(cell: RunSpec, filt) -> bool:
    for axis, allowed in filt.items():
        if axis not in FILTER_AXES:
            raise ValueError(f"filter names unknown axis {axis!r}; "
                             f"have {FILTER_AXES}")
        vals = allowed if isinstance(allowed, (tuple, list)) else (allowed,)
        if cell.axis_value(axis) not in vals:
            return False
    return True


def expand_grid(grid: SweepGrid) -> tuple[list[RunSpec], list[tuple]]:
    """Deterministic expansion of one grid: (cells, masked) where
    ``masked`` is a list of (cell_id, reason) for every combination the
    validity mask dropped."""
    _validate_axes(grid)
    cells: list[RunSpec] = []
    masked: list[tuple] = []
    for sc in _resolve_scenarios(grid.scenarios):
        engines = grid.engines or (sc.engine,)
        cps = grid.control_planes or (sc.control_plane,)
        placements = grid.placements or (sc.placement,)
        policies = grid.policies or tuple(sc.policies)
        spols = grid.scaling_policies or tuple(sc.scaling_policies)
        fcs = grid.forecasters or (sc.forecaster,)
        seeds = grid.seeds or (sc.seed,)
        opt_sets = grid.backend_options or ((),)
        for engine in engines:
            for cp in cps:
                for pl in placements:
                    for pol in policies:
                        for spol in spols:
                            for fc in fcs:
                                for seed in seeds:
                                    for opts in opt_sets:
                                        opts = tuple(tuple(kv)
                                                     for kv in opts)
                                        cell = RunSpec(
                                            scenario=sc, engine=engine,
                                            control_plane=cp, placement=pl,
                                            policy=pol, scaling_policy=spol,
                                            forecaster=fc, seed=seed,
                                            options=opts)
                                        why = mask_reason(
                                            sc, engine, cp, pol, spol, fc,
                                            opts, first_scaling=spols[0],
                                            first_forecaster=fcs[0])
                                        if why is None:
                                            cells.append(cell)
                                        else:
                                            masked.append(
                                                (cell.cell_id, why))
    return cells, masked


def expand_campaign(spec: CampaignSpec,
                    verbose: bool = False):
    """Expand every grid in order, apply include/exclude filters, and
    de-duplicate identical cells (first occurrence wins). Returns the
    cell list; with ``verbose=True`` returns
    ``(cells, masked, filtered)``."""
    cells: list[RunSpec] = []
    masked: list[tuple] = []
    filtered = 0
    seen: set[tuple] = set()
    for grid in spec.grids:
        gcells, gmasked = expand_grid(grid)
        masked.extend(gmasked)
        for cell in gcells:
            if spec.include and not any(_filter_matches(cell, f)
                                        for f in spec.include):
                filtered += 1
                continue
            if any(_filter_matches(cell, f) for f in spec.exclude):
                filtered += 1
                continue
            if cell.key in seen:
                continue
            seen.add(cell.key)
            cells.append(cell)
    if not cells:
        raise ValueError(
            f"campaign {spec.name!r} expanded to zero cells "
            f"({len(masked)} masked, {filtered} filtered)")
    return (cells, masked, filtered) if verbose else cells


def on_device(cells: list[RunSpec], device: str) -> list[RunSpec]:
    """``cells`` with ``device`` set in the backend options of each
    torch and serving cell's scenario. The device is where a cell runs,
    not what it computes, so it stays out of :attr:`RunSpec.options`:
    cell ids and keys are unchanged and match the reference's."""
    out = []
    for cell in cells:
        if cell.engine in DEVICE_ENGINES:
            sc = cell.scenario
            cell = dataclasses.replace(cell, scenario=dataclasses.replace(
                sc, backend_options={**sc.backend_options,
                                     "device": device}))
        out.append(cell)
    return out
