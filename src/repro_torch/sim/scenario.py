"""Declarative scenario API: typed experiment specs over the federation.

The paper's claims are scenario comparisons — policy × workload × fleet
size (Figs. 4–6) — and every interesting extension (mixed fleets, node
failures, WAN/capacity heterogeneity, placement policies) is another
scenario axis. This module makes the experiment surface declarative:
a :class:`Scenario` is a frozen, typed description of *what* to run,
and :func:`run_scenario` is the single compiler/runner that lowers it
onto the existing :class:`~repro_torch.sim.federation.EdgeFederation`
machinery and returns a uniform :class:`ScenarioResult`.

Schema
======

``Scenario``
    ``name``            registry key / report label.
    ``fleet``           a :class:`FleetSpec`: per-class tenant mixes
                        (``TenantClassSpec(kind, count, seed, ...)`` with
                        kind ``"game"`` (iPokeMon-like) or ``"stream"``
                        (Face-Detection-like)) plus optional explicit
                        :class:`~repro_torch.sim.workload.Workload` instances.
    ``topology``        a :class:`TopologySpec`: node count, per-node
                        capacity units (homogeneous ``capacity_units``,
                        heterogeneous ``node_capacities``, or the paper
                        default scaled from the fleet size + headroom),
                        per-node node↔Cloud WAN latency and per-uR price.
    ``faults``          a :class:`FaultSpec`: scheduled whole-node
                        failures (the node's tenants re-place on the
                        surviving siblings or fall back to the Cloud).
    ``placement``       a :class:`~repro_torch.sim.federation.PlacementPolicy`
                        name — ``least_loaded`` | ``locality`` |
                        ``price_aware``.
    ``policies``        the priority policies swept per run (default:
                        the ``none`` baseline + the four priority
                        policies).
    ``scaling_policies``  the :mod:`repro_torch.core.forecast` ScalingPolicy
                        seam swept per run — ``reactive`` (Procedure 2
                        unchanged, the default), ``proactive``
                        (forecast-driven, scales before violations
                        land) and/or ``hybrid`` (reactive fallback
                        wherever forecast error exceeds
                        ``hybrid_vr_band``). Every combination runs the
                        SAME fleet on the SAME topology, so the sweep
                        compares policies at an equal resource budget;
                        multi-entry sweeps key their outcomes as
                        ``"<policy>/<scaling>"``.
    ``forecaster``      the forecaster the proactive/hybrid runs use —
                        a :data:`repro_torch.core.forecast.FORECASTERS` name:
                        ``last_value`` | ``ewma`` | ``linear_trend`` |
                        ``seasonal_naive``.
    plus the engine / control-plane / cadence / pricing / seed knobs that
    previously had to be hand-wired into ``FederationConfig`` tuples.

Runnable example
================

>>> from repro_torch.sim.scenario import (FleetSpec, Scenario, TenantClassSpec,
...                                 TopologySpec, run_scenario)
>>> sc = Scenario(
...     name="tiny_mixed",
...     fleet=FleetSpec(classes=(TenantClassSpec("game", 4),
...                              TenantClassSpec("stream", 4))),
...     topology=TopologySpec(n_nodes=2, capacity_units=96),
...     duration_s=240, round_interval=120, policies=("none", "sdps"))
>>> res = run_scenario(sc)
>>> sorted(res.outcomes) == ["none", "sdps"]
True
>>> 0.0 <= res.outcomes["sdps"].violation_rate <= 1.0
True

Named paper scenarios live in the :data:`SCENARIOS` registry
(``paper_game_32``, ``paper_face_detection``, ``mixed_fleet``,
``hetero_one_big_many_small``, ``proactive_game_32``,
``proactive_face_detection``, ``node_failure_midrun``,
``serving_edge_pair`` — the latter needs the serving engine, which this
package does not carry yet, so the registry rejects it) and can be run
from the command line — with no ``--scenario`` every entry whose engine
is registered runs, and ``--engine torch`` moves them onto the GPU
engine::

    PYTHONPATH=src python -m repro_torch.sim.scenario --quick
    PYTHONPATH=src python -m repro_torch.sim.scenario --quick --engine torch

Equivalence contract: a default least-loaded/homogeneous ``Scenario``
compiles to exactly the ``FederationConfig`` + ``make_*_fleet`` calls
the benchmarks and demo used to hand-wire, so ``run_scenario`` is
bitwise-identical to the pre-scenario construction path (pinned by
``tests/test_scenario.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import PricingModel
from repro_torch.sim.edgesim import WAN_EXTRA_LATENCY, resolve_engine
from repro_torch.sim.engines import ENGINE_BACKENDS
from repro_torch.sim.federation import (PLACEMENTS, SWEEP_POLICIES,
                                        FederationConfig, FederationResult,
                                        PlacementEvent, paper_capacity_units)
from repro_torch.serving.spec import ServingClassSpec, ServingSpec
from repro_torch.sim.workload import (Workload, make_game_fleet,
                                      make_stream_fleet)

# tenant-class kinds → (builder, default name prefix)
_FLEET_BUILDERS = {
    "game": (make_game_fleet, "game"),
    "stream": (make_stream_fleet, "fd"),
}

# latency bands relative to the SLO (Figs. 6/7): under the dThr=0.8
# scale-down threshold, the (0.8, 1]·SLO donation band, and violating
BANDS = (("[0.00,0.80)", 0.0, 0.8), ("[0.80,1.00)", 0.8, 1.0),
         ("[1.00,inf)", 1.0, math.inf))


# ------------------------------------------------------------------- specs
@dataclass(frozen=True)
class TenantClassSpec:
    """One homogeneous slice of the fleet: ``count`` tenants of ``kind``
    with class parameters drawn from ``seed`` (exactly the
    ``make_*_fleet(count, default_rng(seed))`` draw the hand-wired
    experiments perform). ``prefix`` namespaces tenant names so several
    classes of the same kind can coexist in one fleet."""

    kind: str                          # "game" | "stream"
    count: int
    seed: int = 42
    base_latency: float | None = None  # None → the class's paper default
    prefix: str | None = None          # None → "game" / "fd"

    def build(self) -> list[Workload]:
        if self.kind not in _FLEET_BUILDERS:
            raise ValueError(f"tenant class kind {self.kind!r} not in "
                             f"{sorted(_FLEET_BUILDERS)}")
        if self.count <= 0:
            raise ValueError(f"tenant class count must be > 0")
        builder, default_prefix = _FLEET_BUILDERS[self.kind]
        rng = np.random.default_rng(self.seed)
        kw = {"prefix": self.prefix or default_prefix}
        if self.base_latency is not None:
            kw["base_latency"] = self.base_latency
        return builder(self.count, rng, **kw)


@dataclass(frozen=True)
class FleetSpec:
    """The tenant mix: class slices plus optional explicit Workloads
    (tests and one-off experiments can pin exact tenants)."""

    classes: tuple[TenantClassSpec, ...] = ()
    workloads: tuple[Workload, ...] = ()

    @property
    def size(self) -> int:
        return sum(c.count for c in self.classes) + len(self.workloads)

    def build(self) -> list[Workload]:
        """Fresh Workload instances, class order then explicit order —
        rebuilt per run so no simulator state leaks between policies."""
        fleet: list[Workload] = []
        for c in self.classes:
            fleet.extend(c.build())
        # explicit workloads are stateless during a run, but copy anyway
        # so two runs of the same Scenario can never alias
        fleet.extend(dataclasses.replace(w) for w in self.workloads)
        return fleet


@dataclass(frozen=True)
class TopologySpec:
    """The node fleet: capacities and per-node Cloud-link properties.

    Capacity resolution order: ``node_capacities`` (heterogeneous) else
    ``capacity_units`` (homogeneous) else the paper's §5 capacity scaled
    to the tenant count and split across nodes plus ``headroom``
    (:func:`~repro_torch.sim.federation.paper_capacity_units`)."""

    n_nodes: int = 4
    capacity_units: int | None = None
    node_capacities: tuple[int, ...] | None = None
    headroom: int = 16
    # node↔Cloud WAN round-trip: one float (homogeneous) or per-node
    wan_latency_s: float | tuple[float, ...] = WAN_EXTRA_LATENCY
    unit_price: float | tuple[float, ...] = 1.0

    def _per_node_list(self, v, what: str) -> list | None:
        if isinstance(v, (tuple, list)):
            if len(v) != self.n_nodes:
                raise ValueError(f"{what} has {len(v)} entries for "
                                 f"{self.n_nodes} nodes")
            return list(v)
        return None                     # homogeneous scalar → config default

    def resolve_capacity(self, n_tenants: int) -> tuple[int, list[int] | None]:
        """(homogeneous per-node units, heterogeneous override)."""
        if self.node_capacities is not None:
            caps = self._per_node_list(self.node_capacities,
                                       "node_capacities")
            return caps[0], caps
        if self.capacity_units is not None:
            return self.capacity_units, None
        return paper_capacity_units(n_tenants, self.n_nodes,
                                    self.headroom), None


@dataclass(frozen=True)
class NodeFailure:
    """One fault event. ``node`` names a single node (``"edge1"``) or a
    tuple of nodes — a CORRELATED failure (whole-rack outage): every
    listed node dies at the same chunk boundary and is excluded from
    placement before any of their tenants re-place, so refugees only
    land on true survivors (or the Cloud tier).

    ``recover_t`` (optional) schedules the node's REJOIN: at the first
    chunk boundary ≥ ``recover_t`` the node comes back empty and
    placeable, and the federation drains Cloud-fallback tenants back
    onto the Edge through the active placement policy (Age_s/Loyalty_s
    and RNG streams carried). A flapping node is just repeated
    fail/recover pairs."""

    t: int                              # simulated second (fires at the
    #                                     first chunk boundary ≥ t)
    node: str | tuple[str, ...]         # e.g. "edge1" / ("edge1", "edge2")
    recover_t: int | None = None        # None → permanent failure

    @property
    def node_names(self) -> tuple[str, ...]:
        return (self.node,) if isinstance(self.node, str) \
            else tuple(self.node)


@dataclass(frozen=True)
class NodeDegradation:
    """Capacity degradation over ``[t0, t1)``: the node's capacity
    shrinks to ``capacity_fraction`` of its configured uR units at the
    first chunk boundary ≥ ``t0`` (forcing a real Procedure-2/3
    contraction cascade — lowest-priority tenants terminate and
    re-place as refugees until the surviving capacity covers the
    allocations) and is restored at the first boundary ≥ ``t1``."""

    t0: int
    t1: int
    node: str | tuple[str, ...]
    capacity_fraction: float            # in (0, 1]

    @property
    def node_names(self) -> tuple[str, ...]:
        return (self.node,) if isinstance(self.node, str) \
            else tuple(self.node)


@dataclass(frozen=True)
class WanFault:
    """WAN latency spike over ``[t0, t1)``: the node↔Cloud link of every
    named node carries ``extra_latency_s`` additional round-trip
    latency, threading through ``SimConfig.wan_extra_latency`` (so
    Cloud-serviced requests hosted on that node pay the spike) in every
    engine. Fires/clears at chunk boundaries like the other faults."""

    t0: int
    t1: int
    node: str | tuple[str, ...]
    extra_latency_s: float

    @property
    def node_names(self) -> tuple[str, ...]:
        return (self.node,) if isinstance(self.node, str) \
            else tuple(self.node)


@dataclass(frozen=True)
class FaultSpec:
    """The scenario's scheduled fault events. Validated at construction:
    overlapping same-kind windows on one node (two failures of
    ``edge1``, say) and degradations overlapping a failure window raise
    ``ValueError`` immediately instead of corrupting federation state
    mid-run. (A WAN fault MAY overlap a failure — the spike is simply
    unobservable while the node is dead.)"""

    node_failures: tuple[NodeFailure, ...] = ()
    degradations: tuple[NodeDegradation, ...] = ()
    wan_faults: tuple[WanFault, ...] = ()

    def __post_init__(self):
        fail_w: dict[str, list] = {}
        deg_w: dict[str, list] = {}
        wan_w: dict[str, list] = {}

        def add(windows, name, lo, hi, what):
            for lo2, hi2, what2 in windows.setdefault(name, []):
                if lo < hi2 and lo2 < hi:
                    raise ValueError(
                        f"{what} overlaps {what2} on node {name!r}")
            windows[name].append((lo, hi, what))

        for f in self.node_failures:
            if f.t <= 0:
                raise ValueError(f"node failure at t={f.t} must be > 0")
            if f.recover_t is not None and f.recover_t <= f.t:
                raise ValueError(
                    f"failure of {f.node} at t={f.t}: recover_t="
                    f"{f.recover_t} must be after the failure")
            hi = math.inf if f.recover_t is None else f.recover_t
            span = (f"failure [{f.t}, "
                    + ("∞)" if f.recover_t is None else f"{f.recover_t})"))
            for nm in f.node_names:
                add(fail_w, nm, f.t, hi, span)
        for d in self.degradations:
            if d.t0 <= 0 or d.t1 <= d.t0:
                raise ValueError(f"degradation window [{d.t0}, {d.t1}) "
                                 f"must satisfy 0 < t0 < t1")
            if not 0.0 < d.capacity_fraction <= 1.0:
                raise ValueError(
                    f"degradation capacity_fraction "
                    f"{d.capacity_fraction} must be in (0, 1]")
            span = f"degradation [{d.t0}, {d.t1})"
            for nm in d.node_names:
                add(deg_w, nm, d.t0, d.t1, span)
                for lo2, hi2, what2 in fail_w.get(nm, []):
                    if d.t0 < hi2 and lo2 < d.t1:
                        raise ValueError(
                            f"{span} overlaps {what2} on node {nm!r} — "
                            f"a dead node cannot degrade")
        for w in self.wan_faults:
            if w.t0 <= 0 or w.t1 <= w.t0:
                raise ValueError(f"WAN fault window [{w.t0}, {w.t1}) "
                                 f"must satisfy 0 < t0 < t1")
            if w.extra_latency_s < 0:
                raise ValueError(f"WAN fault extra_latency_s "
                                 f"{w.extra_latency_s} must be >= 0")
            span = f"WAN fault [{w.t0}, {w.t1})"
            for nm in w.node_names:
                add(wan_w, nm, w.t0, w.t1, span)

    @property
    def events(self) -> tuple:
        """Every fault event, all kinds (for name validation etc.)."""
        return self.node_failures + self.degradations + self.wan_faults


@dataclass(frozen=True)
class Scenario:
    """A complete, declarative experiment (see module docstring)."""

    name: str
    fleet: FleetSpec
    topology: TopologySpec = TopologySpec()
    faults: FaultSpec = FaultSpec()
    placement: str = "least_loaded"
    policies: tuple[str, ...] = SWEEP_POLICIES
    # ScalingPolicy seam (repro_torch.core.forecast): each run sweeps the
    # cross product policies × scaling_policies at the same budget —
    # "reactive" is Procedure 2 unchanged, "proactive" scales on the
    # forecast before violations land, "hybrid" falls back to reactive
    # wherever the forecast error exceeds hybrid_vr_band
    scaling_policies: tuple[str, ...] = ("reactive",)
    forecaster: str = "ewma"            # FORECASTERS registry name
    forecast_window: int = 16
    hybrid_vr_band: float = 0.15
    duration_s: int = 1200
    round_interval: int = 300
    default_units: int = 16
    slo_scale: float = 1.0
    donation_fraction: float = 0.3
    pricing: PricingModel = PricingModel.HYBRID
    normalize_factors: bool = False
    engine: str = "batched"
    control_plane: str = "array"
    rng_workers: int = 2
    # engine-specific knobs, forwarded into every node's SimConfig
    # (batched: {"jit_scale": bool | device};
    # torch: {"device": str, "scale_kernel": bool})
    backend_options: dict = field(default_factory=dict)
    seed: int = 7
    description: str = ""
    # engine="serving" only: the real-engine shape (models, arrival
    # rates, virtual-clock cadence) the fleet is served with
    serving: ServingSpec | None = None
    # when True, run_scenario attaches a fresh repro_torch.obs.FlightRecorder
    # to every (policy, scaling) run: events land on each
    # FederationResult.events and ScenarioResult gains working
    # write_trace()/write_events_jsonl() exporters. Tracing is
    # observability-only — it draws no RNG and perturbs no control
    # decision, so results are bitwise-identical either way.
    trace: bool = False

    def validate(self) -> None:
        from repro_torch.core.forecast import FORECASTERS, SCALING_POLICIES
        if self.fleet.size <= 0:
            raise ValueError(f"scenario {self.name!r} has an empty fleet")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement {self.placement!r} not in "
                             f"{sorted(PLACEMENTS)}")
        bad = [p for p in self.policies if p not in SWEEP_POLICIES]
        if bad:
            raise ValueError(f"unknown policies {bad}; have {SWEEP_POLICIES}")
        bad = [p for p in self.scaling_policies if p not in SCALING_POLICIES]
        if bad:
            raise ValueError(f"unknown scaling policies {bad}; "
                             f"have {SCALING_POLICIES}")
        if self.forecaster not in FORECASTERS:
            raise ValueError(f"forecaster {self.forecaster!r} not in "
                             f"{sorted(FORECASTERS)}")
        # engine-specific checks live on the backend (the former
        # engine == "serving" special case folded into the registry)
        resolve_engine(self.engine).validate_scenario(self)
        node_names = {f"edge{i}" for i in range(self.topology.n_nodes)}
        for ev in self.faults.events:
            for nm in ev.node_names:
                if nm not in node_names:
                    raise ValueError(f"fault names unknown node {nm!r}")

    def federation_config(self, policy: str,
                          scaling_policy: str | None = None
                          ) -> FederationConfig:
        """Compile this spec (for one priority policy × scaling policy)
        onto the existing federation machinery. A default least-loaded/
        homogeneous/reactive scenario produces exactly the config the
        pre-scenario experiments hand-wired — that is the bitwise
        contract. ``scaling_policy=None`` takes the spec's first entry
        (``"reactive"`` unless the scenario sweeps forecasts)."""
        topo = self.topology
        cap, caps = topo.resolve_capacity(self.fleet.size)
        return FederationConfig(
            n_nodes=topo.n_nodes,
            duration_s=self.duration_s,
            round_interval=self.round_interval,
            capacity_units=cap,
            node_capacities=caps,
            default_units=self.default_units,
            policy=policy,
            slo_scale=self.slo_scale,
            donation_fraction=self.donation_fraction,
            pricing=self.pricing,
            normalize_factors=self.normalize_factors,
            engine=self.engine,
            control_plane=self.control_plane,
            rng_workers=self.rng_workers,
            backend_options=dict(self.backend_options),
            scaling_policy=(scaling_policy if scaling_policy is not None
                            else self.scaling_policies[0]),
            forecaster=self.forecaster,
            forecast_window=self.forecast_window,
            hybrid_vr_band=self.hybrid_vr_band,
            placement=self.placement,
            node_wan_latency_s=topo._per_node_list(topo.wan_latency_s,
                                                   "wan_latency_s"),
            node_unit_price=topo._per_node_list(topo.unit_price,
                                                "unit_price"),
            node_failures=[(f.t, f.node) if f.recover_t is None
                           else (f.t, f.node, f.recover_t)
                           for f in self.faults.node_failures],
            node_degradations=[(d.t0, d.t1, d.node, d.capacity_fraction)
                               for d in self.faults.degradations],
            wan_faults=[(w.t0, w.t1, w.node, w.extra_latency_s)
                        for w in self.faults.wan_faults],
            seed=self.seed,
        )

    def quick(self, round_interval: int = 60,
              rounds: int = 4) -> "Scenario":
        """A short-duration variant for smoke runs: dispatches to the
        engine backend — simulator engines rescale the cadence to
        ``rounds`` intervals of ``round_interval`` seconds
        (:meth:`_quick_rescale`); the serving engine's cadence lives in
        its ServingSpec virtual clock and is already smoke-sized."""
        return resolve_engine(self.engine).quick_scenario(
            self, round_interval, rounds)

    def _quick_rescale(self, round_interval: int,
                       rounds: int) -> "Scenario":
        """The simulator-engine ``quick`` behaviour: shrink the cadence
        and rescale fault times proportionally (clamped inside the run
        so a mid-session failure stays mid-session)."""
        ri = min(self.round_interval, round_interval)
        dur = rounds * ri
        if dur >= self.duration_s:
            return self
        scale = dur / self.duration_s

        def clamp_t(t: int, recovers: bool) -> int:
            # leave room for the rejoin boundary when the failure has one
            hi = dur - 2 * ri if recovers else dur - ri
            return max(ri, min(hi, round(t * scale)))

        failures = tuple(
            NodeFailure(clamp_t(f.t, f.recover_t is not None), f.node)
            if f.recover_t is None else
            NodeFailure(t := clamp_t(f.t, True), f.node,
                        max(t + ri, min(dur - ri, round(f.recover_t * scale))))
            for f in self.faults.node_failures)
        degradations = tuple(
            NodeDegradation(t0 := clamp_t(d.t0, True),
                            max(t0 + ri, round(d.t1 * scale)),
                            d.node, d.capacity_fraction)
            for d in self.faults.degradations)
        wan_faults = tuple(
            WanFault(t0 := clamp_t(w.t0, True),
                     max(t0 + ri, round(w.t1 * scale)),
                     w.node, w.extra_latency_s)
            for w in self.faults.wan_faults)
        faults = FaultSpec(failures, degradations, wan_faults)
        return dataclasses.replace(self, duration_s=dur, round_interval=ri,
                                   faults=faults)


# ------------------------------------------------------------------ results
@dataclass
class PolicyOutcome:
    """The uniform per-policy summary every scenario reports."""

    policy: str
    violation_rate: float                    # Eq. 1, federation-wide
    per_node_vr: dict[str, float]
    band_fractions: dict[str, float]         # latency/SLO bands (Figs. 6/7)
    mean_round_overhead_s: dict[str, float]  # per node (Fig. 2 claim)
    max_round_overhead_s: float
    replaced: int                            # node→node migrations
    cloud: int                               # tenants that ended on Cloud
    wall_s: float
    scaling_policy: str = "reactive"         # reactive|proactive|hybrid
    recovered: int = 0                       # Cloud→Edge drains after rejoin
    shed: int = 0                            # serving: load-shed requests
    # serving: the PR-6 request-conservation invariant
    # (submitted == completed + cloud + shed), asserted post-run;
    # None on simulator engines (no request ledger)
    requests_conserved: bool | None = None
    # serving: TOKEN-level latency bands per tenant class (measured on
    # real decode timelines) — {class prefix: {p50, p95, p99, n}} —
    # reported alongside the model-based band_fractions above; None on
    # simulator engines (their latencies come from the latency model)
    token_latency_bands: dict[str, dict[str, float]] | None = None
    # the paper's headline metric: mean (priority + scaling + forecast)
    # wall per round, averaged over the federation's Edge servers —
    # uniform across the simulator engines AND engine="serving"
    mean_overhead_per_server_s: float = 0.0

    def to_record(self) -> dict:
        """A flat, JSON-serializable summary row (the campaign harness
        and the BENCH writers consume this)."""
        rec = {
            "policy": self.policy,
            "scaling_policy": self.scaling_policy,
            "violation_rate": self.violation_rate,
            "per_node_vr": dict(self.per_node_vr),
            "band_fractions": dict(self.band_fractions),
            "max_round_overhead_s": self.max_round_overhead_s,
            "mean_round_overhead_s": dict(self.mean_round_overhead_s),
            "mean_overhead_per_server_s": self.mean_overhead_per_server_s,
            "replaced": self.replaced,
            "cloud": self.cloud,
            "recovered": self.recovered,
            "shed": self.shed,
            "requests_conserved": self.requests_conserved,
            "wall_s": self.wall_s,
        }
        if self.token_latency_bands is not None:
            rec["token_latency_bands"] = {
                cls: dict(bands)
                for cls, bands in self.token_latency_bands.items()}
        return rec


@dataclass
class ScenarioResult:
    """Everything :func:`run_scenario` produces: the per-policy summary
    rows (``outcomes``) plus the full per-policy
    :class:`~repro_torch.sim.federation.FederationResult` (``results``) for
    anything the summary doesn't carry. When a scenario sweeps more than
    one scaling policy, the dict keys become ``"<policy>/<scaling>"``
    (e.g. ``"sdps/proactive"``); with the default single
    ``("reactive",)`` sweep they stay the bare policy names."""

    name: str
    scenario: Scenario
    outcomes: dict[str, PolicyOutcome] = field(default_factory=dict)
    results: dict[str, FederationResult] = field(default_factory=dict)

    def placements(self, policy: str) -> list[PlacementEvent]:
        """The placement timeline (admissions, re-placements, failovers,
        Cloud fallbacks) of one policy's run."""
        return self.results[policy].placements

    def events(self, key: str) -> list:
        """One outcome's flight-recorder event stream (empty unless the
        scenario ran with ``trace=True``)."""
        return self.results[key].events

    def write_events_jsonl(self, path) -> None:
        """All traced outcomes' events as JSON Lines, one per line."""
        from repro_torch.obs import write_events_jsonl
        write_events_jsonl(path, [e for res in self.results.values()
                                  for e in res.events])

    def write_trace(self, path) -> None:
        """Export every traced outcome as a Chrome-trace/Perfetto
        ``trace.json``: one process group per outcome key, one thread
        track per node (load it at ui.perfetto.dev or chrome://tracing)."""
        from repro_torch.obs import write_chrome_trace
        write_chrome_trace(path, {k: res.events
                                  for k, res in self.results.items()
                                  if res.events})

    def to_records(self) -> list[dict]:
        """One flat summary row per swept outcome (key included) —
        the serialization seam the campaign harness aggregates."""
        return [dict(key=key, scenario=self.name, **oc.to_record())
                for key, oc in self.outcomes.items()]

    def table(self) -> str:
        sc = self.scenario
        node_names = sorted(next(iter(self.results.values())).node_results)
        cap, caps = sc.topology.resolve_capacity(sc.fleet.size)
        cap_s = ("[" + " ".join(str(c) for c in caps) + "]u" if caps
                 else f"{cap}u×{sc.topology.n_nodes}")
        dur = resolve_engine(sc.engine).scenario_duration(sc)
        lines = [
            f"scenario {self.name}: {sc.topology.n_nodes} nodes ({cap_s}), "
            f"{sc.fleet.size} tenants, {dur:g}s session, "
            f"placement={sc.placement}, engine={sc.engine}"
        ]
        if sc.faults.events:
            parts = [f"{f.node}@{f.t}s" if f.recover_t is None
                     else f"{f.node}@{f.t}s↻{f.recover_t}s"
                     for f in sc.faults.node_failures]
            parts += [f"{d.node}×{d.capacity_fraction:g}[{d.t0},{d.t1})s"
                      for d in sc.faults.degradations]
            parts += [f"{w.node}+{w.extra_latency_s:g}sWAN[{w.t0},{w.t1})s"
                      for w in sc.faults.wan_faults]
            lines.append("faults: " + ", ".join(parts))
        band_hdr = "  ".join(f"{b[:11]:>11}" for b, _, _ in BANDS)
        pw = max(8, *(len(k) for k in self.outcomes)) if self.outcomes else 8
        lines.append(
            f"{'policy':<{pw}} {'fed-VR%':>7}  "
            + "  ".join(f"{n:>7}" for n in node_names)
            + f"  {band_hdr}  {'repl':>5} {'cloud':>5} {'max-ovh':>8}"
            f" {'wall':>7}")
        for key, oc in self.outcomes.items():
            per_node = "  ".join(
                f"{oc.per_node_vr.get(n, 0.0) * 100:6.1f}%"
                for n in node_names)
            bands = "  ".join(f"{oc.band_fractions[b] * 100:10.1f}%"
                              for b, _, _ in BANDS)
            ovh = ("      —" if oc.policy == "none"
                   else f"{oc.max_round_overhead_s * 1e3:6.2f}ms")
            lines.append(
                f"{key:<{pw}} {oc.violation_rate * 100:6.1f}   {per_node}"
                f"  {bands}  {oc.replaced:5d} {oc.cloud:5d} {ovh:>8}"
                f" {oc.wall_s:6.2f}s")
        if any(oc.token_latency_bands for oc in self.outcomes.values()):
            lines.append("token-level latency p50/p95/p99 per tenant "
                         "class (s, real decode timelines):")
            for key, oc in self.outcomes.items():
                if not oc.token_latency_bands:
                    continue
                cells = "  ".join(
                    f"{cls} {b['p50']:.2f}/{b['p95']:.2f}/{b['p99']:.2f}"
                    f" (n={int(b['n'])})"
                    for cls, b in oc.token_latency_bands.items())
                lines.append(f"  {key:<{pw}} {cells}")
        worst = max((oc.max_round_overhead_s
                     for oc in self.outcomes.values()
                     if oc.policy != "none"),
                    default=0.0)
        if worst:
            ok = "ok (paper: sub-second)" if worst < 1.0 else "VIOLATED"
            lines.append(f"max per-node round overhead "
                         f"{worst * 1e3:.2f}ms → {ok}")
        return "\n".join(lines)


def _band_fractions(res: FederationResult) -> dict[str, float]:
    """Latency/SLO band fractions over the whole federation's
    user-visible request distribution (Cloud requests included, with
    their WAN penalty — as in Figs. 6/7)."""
    lats = [r.latencies for r in res.node_results.values()
            if r.latencies.size]
    if not lats:
        return {b: 0.0 for b, _, _ in BANDS}
    lat = np.concatenate(lats)
    slo = np.concatenate([r.slos for r in res.node_results.values()
                          if r.slos.size])
    out = {}
    for b, lo, hi in BANDS:
        sel = lat >= lo * slo
        if hi != math.inf:
            sel &= lat < hi * slo
        out[b] = float(sel.mean())
    return out


def run_scenario(scenario: Scenario | str, *,
                 policies: tuple[str, ...] | None = None,
                 scaling_policies: tuple[str, ...] | None = None,
                 quick: bool = False) -> ScenarioResult:
    """Compile and run a :class:`Scenario` (or a :data:`SCENARIOS` name)
    across its policies × scaling policies (every combination runs the
    SAME fleet on the SAME topology — an equal-resource-budget sweep);
    returns the uniform :class:`ScenarioResult`."""
    if isinstance(scenario, str):
        try:
            scenario = SCENARIOS[scenario]
        except KeyError:
            raise ValueError(f"unknown scenario {scenario!r}; have "
                             f"{sorted(SCENARIOS)}") from None
    if quick:
        scenario = scenario.quick()
    scenario.validate()
    out = ScenarioResult(name=scenario.name, scenario=scenario)
    spols = scaling_policies or scenario.scaling_policies
    for policy in (policies or scenario.policies):
        # the "none" baseline runs no scaling rounds at all — sweeping
        # scaling policies over it would repeat the identical run
        pol_spols = spols if policy != "none" else spols[:1]
        for spol in pol_spols:
            key = (policy if len(spols) == 1 or policy == "none"
                   else f"{policy}/{spol}")
            fleet = scenario.fleet.build()
            cfg = scenario.federation_config(policy, spol)
            if scenario.trace:
                from repro_torch.obs import FlightRecorder
                cfg.recorder = FlightRecorder()
            t0 = time.perf_counter()
            res = resolve_engine(scenario.engine).run_federation(
                fleet, cfg, scenario)
            wall = time.perf_counter() - t0
            over = res.mean_round_overhead_s
            per_server = [nr.mean_overhead_per_server_s
                          for nr in res.node_results.values()]
            out.results[key] = res
            out.outcomes[key] = PolicyOutcome(
                policy=policy,
                violation_rate=res.violation_rate,
                per_node_vr=res.per_node_vr,
                band_fractions=_band_fractions(res),
                mean_round_overhead_s=over,
                max_round_overhead_s=max(over.values(), default=0.0),
                replaced=len(res.replaced),
                cloud=len(res.cloud),
                wall_s=wall,
                scaling_policy=spol,
                recovered=sum(1 for p in res.placements
                              if p.kind == "recover" and p.node is not None),
                shed=getattr(res, "shed", 0),
                requests_conserved=getattr(res, "requests_conserved", None),
                token_latency_bands=getattr(res, "token_latency_bands",
                                            None),
                mean_overhead_per_server_s=(
                    float(np.mean(per_server)) if per_server else 0.0),
            )
    return out


# ----------------------------------------------------------------- registry
SCENARIOS: dict[str, Scenario] = {}


def register_scenario(sc: Scenario) -> Scenario:
    """Add a named scenario to the registry (last registration wins)."""
    SCENARIOS[sc.name] = sc
    return sc


def format_registry() -> str:
    """One line per registry entry (the --list output of both the
    scenario CLI and examples/federation_demo.py)."""
    return "\n".join(f"{name:<28} {sc.description}"
                     for name, sc in SCENARIOS.items())


register_scenario(Scenario(
    name="paper_game_32",
    description="Paper §5 iPokeMon setup federated: 32 game tenants on "
                "4 least-loaded nodes at paper capacity (+16u headroom).",
    fleet=FleetSpec(classes=(TenantClassSpec("game", 32),)),
    topology=TopologySpec(n_nodes=4, headroom=16),
))

register_scenario(Scenario(
    name="paper_face_detection",
    description="Paper §5 Face Detection setup federated: 32 streaming "
                "tenants (0.1–1 fps) on 4 nodes at paper capacity.",
    fleet=FleetSpec(classes=(TenantClassSpec("stream", 32),)),
    topology=TopologySpec(n_nodes=4, headroom=16),
))

register_scenario(Scenario(
    name="mixed_fleet",
    description="Mixed multi-tenancy: 16 game + 16 stream tenants share "
                "the same 4 nodes, so both workload classes contend on "
                "every node (ROADMAP: mixed game+stream fleets).",
    fleet=FleetSpec(classes=(TenantClassSpec("game", 16),
                             TenantClassSpec("stream", 16))),
    topology=TopologySpec(n_nodes=4, headroom=16),
))

register_scenario(Scenario(
    name="hetero_one_big_many_small",
    description="EdgeOS-style asymmetric fleet: one big node + three "
                "dense cheap nodes, same total capacity as the "
                "homogeneous paper split (552u); price-aware placement "
                "favours the cheap small nodes first.",
    fleet=FleetSpec(classes=(TenantClassSpec("game", 32),)),
    topology=TopologySpec(n_nodes=4,
                          node_capacities=(300, 84, 84, 84),
                          unit_price=(2.0, 1.0, 1.0, 1.0)),
    placement="price_aware",
))

register_scenario(Scenario(
    name="proactive_game_32",
    description="Forecast-driven scaling on the paper game fleet: "
                "reactive vs proactive vs hybrid (sdps) at the same "
                "budget; 60 s rounds so the 300 s burst cycle spans 5 "
                "rounds and the seasonal_naive forecaster pre-scales "
                "into each peak it has already seen once.",
    fleet=FleetSpec(classes=(TenantClassSpec("game", 32),)),
    topology=TopologySpec(n_nodes=4, headroom=16),
    policies=("sdps",),
    scaling_policies=("reactive", "proactive", "hybrid"),
    forecaster="seasonal_naive",
    round_interval=60,
))

register_scenario(Scenario(
    name="proactive_face_detection",
    description="Forecast-driven scaling on the paper streaming fleet "
                "(0.1-1 fps Face Detection): reactive vs proactive vs "
                "hybrid (sdps) at the same budget, 60 s rounds — here "
                "seasonal_naive anticipates the controller's own "
                "scale-down/scale-up limit cycle rather than the "
                "(time-invariant) demand.",
    fleet=FleetSpec(classes=(TenantClassSpec("stream", 32),)),
    topology=TopologySpec(n_nodes=4, headroom=16),
    policies=("sdps",),
    scaling_policies=("reactive", "proactive", "hybrid"),
    forecaster="seasonal_naive",
    round_interval=60,
))

register_scenario(Scenario(
    name="serving_edge_pair",
    description="REAL engine federation: 4 LLM tenants (2 hot @0.7 "
                "req/step, 2 tail @0.15) on 2 nodes of 8u; sdps moves "
                "actual decode-slot/KV-page quotas (1→4 slots for the "
                "hot tenants); edge1 dies at virtual t=8s and its live "
                "queues migrate to edge0 or the Cloud tier.",
    fleet=FleetSpec(classes=(TenantClassSpec("game", 2, prefix="hot"),
                             TenantClassSpec("game", 2, prefix="tail"))),
    topology=TopologySpec(n_nodes=2, capacity_units=8),
    policies=("none", "sdps"),
    default_units=1,
    engine="serving",
    faults=FaultSpec((NodeFailure(t=8, node="edge1"),)),
    serving=ServingSpec(classes=(
        ServingClassSpec(prefix="hot", rate=0.7, slo_s=2.0),
        ServingClassSpec(prefix="tail", rate=0.15, slo_s=4.0),
    ), rounds=6),
))

register_scenario(Scenario(
    name="node_failure_midrun",
    description="Fault injection: edge1 dies at t=600 (mid-session); "
                "its whole fleet re-places on the surviving siblings "
                "(48u headroom each absorbs a few refugees) or falls "
                "back to the Cloud over heterogeneous WAN links.",
    fleet=FleetSpec(classes=(TenantClassSpec("game", 32),)),
    topology=TopologySpec(n_nodes=4, headroom=48,
                          wan_latency_s=(0.06, 0.12, 0.12, 0.24)),
    faults=FaultSpec((NodeFailure(t=600, node="edge1"),)),
))

register_scenario(Scenario(
    name="flapping_node",
    description="Chaos: edge1 flaps twice (dies 240s, rejoins 480s; "
                "dies again 720s, rejoins 960s). Refugees spill to "
                "Cloud under tight paper capacity; each rejoin drains "
                "them back onto the Edge through the placement policy.",
    fleet=FleetSpec(classes=(TenantClassSpec("game", 32),)),
    topology=TopologySpec(n_nodes=4, headroom=16),
    policies=("none", "sdps"),
    round_interval=120,
    faults=FaultSpec((NodeFailure(t=240, node="edge1", recover_t=480),
                      NodeFailure(t=720, node="edge1", recover_t=960))),
))

register_scenario(Scenario(
    name="degraded_node_midrun",
    description="Chaos: edge1 halves its capacity over [300,900)s — a "
                "real Procedure-2/3 contraction cascade terminates the "
                "lowest-priority tenants, who re-place as refugees; "
                "full capacity restores at 900s.",
    fleet=FleetSpec(classes=(TenantClassSpec("game", 32),)),
    topology=TopologySpec(n_nodes=4, headroom=16),
    policies=("none", "sdps"),
    faults=FaultSpec(degradations=(
        NodeDegradation(t0=300, t1=900, node="edge1",
                        capacity_fraction=0.5),)),
))

register_scenario(Scenario(
    name="wan_spike_storm",
    description="Chaos: edge1 dies 240s→720s pushing refugees onto the "
                "Cloud tier over survivors' WAN links, which then spike "
                "+0.25s over [360,720)s — Cloud-serviced requests pay "
                "the storm until the node rejoins and drains them back.",
    fleet=FleetSpec(classes=(TenantClassSpec("game", 32),)),
    topology=TopologySpec(n_nodes=4, headroom=8),
    policies=("none", "sdps"),
    round_interval=120,
    faults=FaultSpec(
        node_failures=(NodeFailure(t=240, node="edge1", recover_t=720),),
        wan_faults=(WanFault(t0=360, t1=720,
                             node=("edge0", "edge2", "edge3"),
                             extra_latency_s=0.25),)),
))

register_scenario(Scenario(
    name="serving_timeout_retry",
    description="REAL engine chaos: the serving_edge_pair fleet with "
                "per-request timeouts (4s, capped-backoff retry, then "
                "Cloud) and queue-depth load shedding; edge1 dies at "
                "virtual t=8s and rejoins at t=16s, draining its "
                "Cloud-fallback tenants back onto the Edge.",
    fleet=FleetSpec(classes=(TenantClassSpec("game", 2, prefix="hot"),
                             TenantClassSpec("game", 2, prefix="tail"))),
    topology=TopologySpec(n_nodes=2, capacity_units=8),
    policies=("none", "sdps"),
    default_units=1,
    engine="serving",
    faults=FaultSpec((NodeFailure(t=8, node="edge1", recover_t=16),)),
    serving=ServingSpec(classes=(
        ServingClassSpec(prefix="hot", rate=0.7, slo_s=2.0),
        ServingClassSpec(prefix="tail", rate=0.15, slo_s=4.0),
    ), rounds=6, timeout_s=4.0, retry_limit=1, backoff_base_s=0.5,
        backoff_cap_s=2.0, shed_depth=12),
))


# ---------------------------------------------------------------- CLI smoke
def main(argv: list[str] | None = None) -> int:
    """Registry smoke runner (the CI step): run named scenarios and fail
    on any exception or non-finite violation rate. By default every
    entry whose engine is registered runs (the serving scenarios wait
    for the serving engine's port)."""
    ap = argparse.ArgumentParser(
        description="Run named federation scenarios from the registry.")
    ap.add_argument("--scenario", action="append", default=None,
                    metavar="NAME", help="scenario to run (repeatable; "
                    "default: every registry entry)")
    ap.add_argument("--quick", action="store_true",
                    help="short-duration smoke variant of each scenario")
    ap.add_argument("--list", action="store_true",
                    help="list registry entries and exit")
    ap.add_argument("--engine", default=None,
                    help="run every scenario on this engine instead of "
                    "its own (e.g. torch)")
    ap.add_argument("--device", default=None,
                    help="backend_options device for --engine torch "
                    "(default: cuda)")
    args = ap.parse_args(argv)
    if args.list:
        print(format_registry())
        return 0
    failures = []
    names = args.scenario or [n for n, sc in SCENARIOS.items()
                              if sc.engine in ENGINE_BACKENDS]
    for name in names:
        if name not in SCENARIOS:
            raise ValueError(f"unknown scenario {name!r}; have "
                             f"{sorted(SCENARIOS)}")
        sc = SCENARIOS[name]
        if args.engine is not None:
            sc = dataclasses.replace(sc, engine=args.engine)
        if args.device is not None:
            sc = dataclasses.replace(sc, backend_options={
                **sc.backend_options, "device": args.device})
        res = run_scenario(sc, quick=args.quick)
        print(res.table())
        print()
        for policy, oc in res.outcomes.items():
            if not math.isfinite(oc.violation_rate):
                failures.append(f"{name}/{policy}: VR={oc.violation_rate}")
    if failures:
        print("NON-FINITE VIOLATION RATES:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
