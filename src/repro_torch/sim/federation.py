"""Edge federation: N DYVERSE nodes + a placement tier + a Cloud tier.

Mapping onto the paper's architecture (§2, Fig. 1): each
:class:`EdgeNodeSim` owns one *Edge Manager* (the ``DyverseController``
with its Monitor, priority manager and auto-scaler — Procedures 1–3,
unchanged). The paper evaluates a single node; here a thin federation
tier plays the role the *Cloud Manager* plays at deployment time, for a
whole fleet of nodes:

* **Placement** — when a tenant is offloaded, the federation admits it
  to the best-ranked node under a pluggable :class:`PlacementPolicy`
  among those with free capacity for the default quota (``can_admit``).
  The default ``least_loaded`` policy picks the smallest projected
  allocated-units fraction (via ``DyverseController.
  load_fraction_after``); ``locality`` prefers the cheapest node↔Cloud
  WAN link and ``price_aware`` the lowest per-uR price. This is the
  "which Edge node hosts the server" decision the paper defers to the
  Cloud Manager.
* **Faults** — ``FederationConfig.node_failures`` schedules whole-node
  failures: at the first chunk boundary ≥ the scheduled second, every
  tenant the node hosts re-places on the surviving siblings (or the
  Cloud tier), keeping its spec, RNG streams, Age_s and Loyalty_s.
  A failure may carry a ``recover_t``: the node rejoins empty at that
  boundary and Cloud-fallback tenants drain back onto the Edge through
  the placement policy (flapping = repeated fail/recover pairs).
  ``node_degradations`` shrink a node's capacity mid-run (a real
  Procedure-2/3 contraction cascade re-places the overflow) and
  ``wan_faults`` spike a node↔Cloud link's latency over a window —
  every fault kind fires at chunk boundaries only, preserving the
  engines' bitwise determinism contract.
* **Re-placement** — when a node's Procedure 3 terminates a tenant
  (eviction under contention), the federation first tries to migrate it
  to a sibling Edge node with spare capacity, and only falls back to
  the Cloud tier when no node fits. This follows Baktir et al.
  (*Addressing the Challenges in Federating Edge Resources*): federated
  Edge resources absorb each other's overflow before the WAN is paid.
* **Cloud tier** — tenants nowhere placeable are serviced by the origin
  Cloud server with ``WAN_EXTRA_LATENCY`` added per request, exactly as
  the single-node simulator treats terminated tenants (users are
  redirected, never dropped).

All nodes advance in lockstep, one round-interval chunk at a time, so
re-placement happens at the same boundaries where Procedure 1 runs.
Federation-level SLO accounting (Eq. 1 aggregated over nodes) is the
request-weighted mean of the per-node violation rates.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core import POLICIES, PricingModel, TenantSpec
from repro_torch.sim.edgesim import (WAN_EXTRA_LATENCY, EdgeNodeSim,
                                     SimConfig, SimResult, resolve_engine)
from repro_torch.sim.workload import Workload

# the no-scaling baseline + the four priority policies (Figs. 3–5 sweeps)
SWEEP_POLICIES = ("none",) + POLICIES


# ------------------------------------------------------- placement policies
@runtime_checkable
class PlacementPolicy(Protocol):
    """Which feasible node hosts a tenant (admission AND eviction
    re-placement). The federation filters candidates to nodes with free
    capacity (``can_admit``), then sorts them by ``key`` ascending and
    picks the first — so a policy is just a total order over nodes.
    Keys must end with a deterministic tie-break (the node name) so
    placement never depends on Python sort stability across runs."""

    name: str

    def key(self, node: EdgeNodeSim, wl: Workload) -> tuple: ...


class LeastLoadedPlacement:
    """The paper-default policy (extracted verbatim from the previously
    hardwired ``EdgeFederation._place`` sort): smallest projected
    allocated-units fraction after admission, ties by node name. On
    heterogeneous fleets this steers tenants toward the node that ends
    up least utilised."""

    name = "least_loaded"

    def key(self, node: EdgeNodeSim, wl: Workload) -> tuple:
        return (node.ctrl.load_fraction_after(), node.name)


class LocalityPlacement:
    """Network-locality-aware: prefer the node with the cheapest
    node↔Cloud WAN link (``SimConfig.wan_extra_latency``), so tenants
    land where an eventual Cloud fallback — and the origin round-trip
    their users already pay — is cheapest. Ties fall back to the
    least-loaded order."""

    name = "locality"

    def key(self, node: EdgeNodeSim, wl: Workload) -> tuple:
        return (node.cfg.wan_extra_latency, node.ctrl.load_fraction_after(),
                node.name)


class PriceAwarePlacement:
    """Price-aware: prefer the node with the lowest per-uR unit price
    (``SimConfig.unit_price`` — heterogeneous fleets mix expensive big
    boxes with EdgeOS-style dense cheap nodes). Ties fall back to the
    least-loaded order."""

    name = "price_aware"

    def key(self, node: EdgeNodeSim, wl: Workload) -> tuple:
        return (node.cfg.unit_price, node.ctrl.load_fraction_after(),
                node.name)


PLACEMENTS: dict[str, PlacementPolicy] = {
    p.name: p for p in (LeastLoadedPlacement(), LocalityPlacement(),
                        PriceAwarePlacement())
}


def resolve_placement(policy: str | PlacementPolicy) -> PlacementPolicy:
    """Registry lookup for string names; pass-through for policy objects
    (anything exposing ``name`` + ``key``)."""
    if isinstance(policy, str):
        try:
            return PLACEMENTS[policy]
        except KeyError:
            raise ValueError(
                f"placement {policy!r} not in {sorted(PLACEMENTS)}") from None
    if not isinstance(policy, PlacementPolicy):
        raise TypeError(f"not a PlacementPolicy: {policy!r}")
    return policy


def paper_capacity_units(tenants: int, n_nodes: int = 1,
                         headroom: int = 0) -> int:
    """Paper §5 node capacity (490 uR for 32 tenants), scaled to the
    tenant count, split across federation nodes, plus optional headroom
    so re-placement has somewhere to go."""
    return int(490 * tenants / 32 / n_nodes) + headroom


@dataclass
class FederationConfig:
    n_nodes: int = 4
    duration_s: int = 1200
    round_interval: int = 300
    capacity_units: int = 520          # per node, unless node_capacities
    node_capacities: list[int] | None = None   # heterogeneous override
    default_units: int = 16
    policy: str = "sdps"
    slo_scale: float = 1.0
    donation_fraction: float = 0.3
    pricing: PricingModel = PricingModel.HYBRID
    normalize_factors: bool = False
    engine: str = "vectorized"
    control_plane: str = "array"       # "array" | "reference" (per node)
    rng_workers: int = 2               # batched engine: jitter-draw pool
    # engine-specific knobs, forwarded into every node's SimConfig
    backend_options: dict = field(default_factory=dict)
    # ScalingPolicy seam (repro_torch.core.forecast), applied on every node
    scaling_policy: str = "reactive"   # "reactive"|"proactive"|"hybrid"
    forecaster: str = "ewma"           # FORECASTERS name
    forecast_window: int = 16
    hybrid_vr_band: float = 0.15
    placement: str | PlacementPolicy = "least_loaded"
    # per-node node↔Cloud WAN round-trip (heterogeneous links); None →
    # the homogeneous WAN_EXTRA_LATENCY default on every node
    node_wan_latency_s: list[float] | None = None
    node_unit_price: list[float] | None = None   # price-aware placement
    # scheduled node failures: (second, node name | list of node names)
    # with an optional third element recover_t; each fires at the first
    # chunk boundary ≥ its second. A multi-name entry is a CORRELATED
    # failure (whole-rack outage): every listed node is marked dead
    # before any tenant re-places, so refugees only land on true
    # survivors (or the Cloud tier). With recover_t the node rejoins
    # (empty, placeable) at the first boundary ≥ recover_t and the
    # federation drains Cloud-fallback tenants back onto the Edge
    node_failures: list[tuple] = field(default_factory=list)
    # capacity degradations: (t0, t1, node(s), capacity_fraction) — the
    # node's uR capacity shrinks to the fraction at the first boundary
    # ≥ t0 (Procedure-2/3 contraction cascade re-places the overflow)
    # and restores at the first boundary ≥ t1
    node_degradations: list[tuple] = field(default_factory=list)
    # WAN latency spikes: (t0, t1, node(s), extra_latency_s) added to
    # the node↔Cloud link over the window, at chunk boundaries
    wan_faults: list[tuple] = field(default_factory=list)
    seed: int = 0
    # optional repro_torch.obs.FlightRecorder shared by the federation and
    # every node/controller/engine; None (default) = tracing off
    recorder: object | None = None

    def _per_node(self, values, i: int, default):
        if values is None:
            return default
        if len(values) != self.n_nodes:
            raise ValueError(
                f"per-node list of length {len(values)} for "
                f"{self.n_nodes} nodes")
        return values[i]

    def node_sim_config(self, i: int) -> SimConfig:
        return SimConfig(
            duration_s=self.duration_s,
            round_interval=self.round_interval,
            capacity_units=self._per_node(self.node_capacities, i,
                                          self.capacity_units),
            default_units=self.default_units,
            policy=self.policy,
            slo_scale=self.slo_scale,
            donation_fraction=self.donation_fraction,
            pricing=self.pricing,
            normalize_factors=self.normalize_factors,
            engine=self.engine,
            control_plane=self.control_plane,
            rng_workers=self.rng_workers,
            backend_options=dict(self.backend_options),
            scaling_policy=self.scaling_policy,
            forecaster=self.forecaster,
            forecast_window=self.forecast_window,
            hybrid_vr_band=self.hybrid_vr_band,
            wan_extra_latency=self._per_node(self.node_wan_latency_s, i,
                                             WAN_EXTRA_LATENCY),
            unit_price=self._per_node(self.node_unit_price, i, 1.0),
            seed=self.seed,
            recorder=self.recorder,
        )


@dataclass
class PlacementEvent:
    t: int                      # simulated second of the decision
    tenant: str
    node: str | None            # None → Cloud tier
    # "admit" | "replace" | "failover" | "cloud" | "recover" (a
    # Cloud-fallback tenant drained back onto the Edge after a rejoin)
    kind: str
    source: str | None = None   # node the tenant was evicted/failed from


@dataclass
class FederationResult:
    policy: str
    node_results: dict[str, SimResult]
    violation_rate: float       # Eq. 1 aggregated across all Edge nodes
    total_requests: int
    total_violations: int
    placements: list[PlacementEvent] = field(default_factory=list)
    replaced: list[str] = field(default_factory=list)   # moved node→node
    cloud: list[str] = field(default_factory=list)      # ended on the Cloud
    failed_nodes: list[str] = field(default_factory=list)   # ever failed
    recovered_nodes: list[str] = field(default_factory=list)  # rejoined
    # flight-recorder event stream (tracing-on runs only): the shared
    # recorder's whole ring, federation- and node-level events merged
    events: list = field(default_factory=list)

    @property
    def per_node_vr(self) -> dict[str, float]:
        return {n: r.violation_rate for n, r in self.node_results.items()}

    @property
    def mean_round_overhead_s(self) -> dict[str, float]:
        return {n: r.mean_overhead_per_server_s
                for n, r in self.node_results.items()}

    # -------------------------------------------------- obs exporters
    def write_events_jsonl(self, path: str) -> str:
        """JSONL dump of the run's flight-recorder events (tracing-on
        runs only; off runs write an empty file)."""
        from repro_torch.obs import write_events_jsonl
        return write_events_jsonl(path, self.events)

    def write_trace(self, path: str) -> str:
        """Chrome-trace/Perfetto ``trace.json`` of this run: one track
        per node plus a federation track (open at
        https://ui.perfetto.dev)."""
        from repro_torch.obs import write_chrome_trace
        return write_chrome_trace(path, {self.policy: self.events})


class EdgeFederation:
    def __init__(self, workloads: list[Workload], cfg: FederationConfig):
        self.cfg = cfg
        self.obs = cfg.recorder          # None = tracing off
        self.placement = resolve_placement(cfg.placement)
        self.nodes = [
            EdgeNodeSim([], cfg.node_sim_config(i), name=f"edge{i}")
            for i in range(cfg.n_nodes)
        ]
        self.placements: list[PlacementEvent] = []
        self.replaced: list[str] = []
        self.failed: set[str] = set()
        self._ever_failed: set[str] = set()
        self.recovered: list[str] = []
        node_names = {n.name for n in self.nodes}

        def names_of(fnodes, what: str, ft) -> tuple[str, ...]:
            # one event may name several nodes (correlated/rack outage)
            names = ((fnodes,) if isinstance(fnodes, str)
                     else tuple(fnodes))
            if not names:
                raise ValueError(f"{what} at t={ft} names no nodes")
            for fname in names:
                if fname not in node_names:
                    raise ValueError(f"{what}s names unknown node "
                                     f"{fname!r} (have {sorted(node_names)})")
            return names

        def boundary(t) -> int:
            # boundaries are the multiples of round_interval (plus the
            # run end, where firing would be unobservable)
            return int(-(-t // cfg.round_interval) * cfg.round_interval)

        normalized: list[tuple[int, tuple[str, ...]]] = []
        recoveries: list[tuple[int, tuple[str, ...]]] = []
        windows: list[tuple[int, float, str]] = []   # (dead-from, -to, node)
        for entry in cfg.node_failures:
            ft, fnodes = entry[0], entry[1]
            rt = entry[2] if len(entry) > 2 else None
            names = names_of(fnodes, "node failure", ft)
            if not 0 < ft:
                raise ValueError(f"node failure at t={ft} must be > 0")
            # a failure whose first boundary is not inside the run never
            # fires — reject it instead of silently dropping it
            fb = boundary(ft)
            if fb >= cfg.duration_s:
                raise ValueError(
                    f"node failure at t={ft} would never fire: its chunk "
                    f"boundary {fb} is not before "
                    f"duration_s={cfg.duration_s}")
            if rt is None:
                rb = None
            else:
                if rt <= ft:
                    raise ValueError(f"node failure at t={ft}: recover_t="
                                     f"{rt} must be after the failure")
                rb = boundary(rt)
                if rb <= fb:
                    raise ValueError(
                        f"node failure at t={ft}: recovery at t={rt} "
                        f"shares chunk boundary {fb} with the failure — "
                        f"the node would never be down")
                if rb >= cfg.duration_s:
                    raise ValueError(
                        f"node recovery at t={rt} would never fire: its "
                        f"chunk boundary {rb} is not before "
                        f"duration_s={cfg.duration_s}")
                recoveries.append((rt, names))
            normalized.append((ft, names))
            for nm in names:
                windows.append((fb, np.inf if rb is None else rb, nm))
        # "kills every node" now means CONCURRENTLY dead — at any failure
        # boundary, the set of nodes whose dead window [fb, rb) covers it
        # must leave at least one survivor
        for fb, _, _ in windows:
            dead = {nm for lo, hi, nm in windows if lo <= fb < hi}
            if len(dead) >= cfg.n_nodes:
                raise ValueError("node_failures would kill every node")

        deg_starts: list[tuple[int, tuple[str, ...], float]] = []
        deg_ends: list[tuple[int, tuple[str, ...]]] = []
        for t0, t1, dnodes, frac in cfg.node_degradations:
            names = names_of(dnodes, "node degradation", t0)
            if not 0 < t0 < t1:
                raise ValueError(f"degradation window [{t0}, {t1}) must "
                                 f"satisfy 0 < t0 < t1")
            if not 0.0 < frac <= 1.0:
                raise ValueError(f"degradation capacity_fraction {frac} "
                                 f"must be in (0, 1]")
            if boundary(t0) >= cfg.duration_s:
                raise ValueError(
                    f"node degradation at t={t0} would never fire: its "
                    f"chunk boundary {boundary(t0)} is not before "
                    f"duration_s={cfg.duration_s}")
            deg_starts.append((t0, names, frac))
            deg_ends.append((t1, names))   # past-the-end → never restores

        wan_starts: list[tuple[int, tuple[str, ...], float]] = []
        wan_ends: list[tuple[int, tuple[str, ...], float]] = []
        for t0, t1, wnodes, extra in cfg.wan_faults:
            names = names_of(wnodes, "WAN fault", t0)
            if not 0 < t0 < t1:
                raise ValueError(f"WAN fault window [{t0}, {t1}) must "
                                 f"satisfy 0 < t0 < t1")
            if extra < 0:
                raise ValueError(f"WAN fault extra_latency_s {extra} "
                                 f"must be >= 0")
            if boundary(t0) >= cfg.duration_s:
                raise ValueError(
                    f"WAN fault at t={t0} would never fire: its chunk "
                    f"boundary {boundary(t0)} is not before "
                    f"duration_s={cfg.duration_s}")
            wan_starts.append((t0, names, extra))
            wan_ends.append((t1, names, extra))

        # schedules sorted by time; each fires at the first boundary ≥ t
        self._pending_failures = sorted(normalized)
        self._pending_recoveries = sorted(recoveries)
        self._pending_deg_starts = sorted(deg_starts)
        self._pending_deg_ends = sorted(deg_ends)
        self._pending_wan_starts = sorted(wan_starts)
        self._pending_wan_ends = sorted(wan_ends)
        # restore targets for degradation/WAN ends
        self._base_units = {n.name: n.cfg.capacity_units for n in self.nodes}
        self._base_wan = {n.name: n.cfg.wan_extra_latency
                          for n in self.nodes}
        self._wan_extra = {n.name: 0.0 for n in self.nodes}
        names = [wl.name for wl in workloads]
        if len(set(names)) != len(names):
            raise ValueError("duplicate tenant names in federation fleet")
        rng = np.random.default_rng(cfg.seed)
        # spec draws happen federation-side, in tenant order, so placement
        # choices never perturb another tenant's donation/premium roll
        for wl in workloads:
            donation = bool(rng.random() < cfg.donation_fraction)
            premium = float(rng.random() < 0.25)
            self._place(wl, donation=donation, premium=premium, t=0)

    # ---------------------------------------------------------- placement
    def _feasible_nodes(self, wl: Workload,
                        exclude: EdgeNodeSim | None = None):
        cands = [n for n in self.nodes
                 if n is not exclude and n.name not in self.failed
                 and n.ctrl.can_admit()]
        return sorted(cands, key=lambda n: self.placement.key(n, wl))

    def _live_host(self, preferred: EdgeNodeSim | None) -> EdgeNodeSim:
        """A surviving node to account a Cloud-tier tenant on."""
        if preferred is not None and preferred.name not in self.failed:
            return preferred
        for n in self.nodes:
            if n.name not in self.failed:
                return n
        raise RuntimeError("no live node left to host the Cloud tier")

    def _place(self, wl: Workload, *, donation: bool, premium: float,
               t: int, spec: TenantSpec | None = None, tenant_rng=None,
               source: str | None = None, prior_age: int = 0,
               prior_loyalty: int = 0,
               kind: str | None = None) -> EdgeNodeSim | None:
        if kind is None:
            kind = "admit" if source is None else "replace"
        # a tenant Procedure 3 just evicted must go to a SIBLING node —
        # the source freed its units, so it would otherwise re-admit the
        # tenant it terminated and churn
        src_node = next((n for n in self.nodes if n.name == source), None)
        feasible = self._feasible_nodes(wl, exclude=src_node)
        if feasible:
            node = feasible[0]
            if prior_age:
                # seed BEFORE admit: ctrl.admit builds the TenantState
                # from its history, so the refugee keeps its Age_s credit
                node.ctrl.remember_age(wl.name, prior_age)
            if prior_loyalty:
                # §3.2: Loyalty_s counts times the service was used —
                # tenancy on a sibling node is still the same federated
                # service, so migration must not zero it
                node.ctrl.remember_loyalty(wl.name, prior_loyalty)
            if not node.add_tenant(wl, donation=donation, premium=premium,
                                   spec=spec, tenant_rng=tenant_rng):
                # can_admit() and admit() test the same capacity condition
                # and nothing runs in between — a refusal is a bug
                raise RuntimeError(
                    f"admit refused on feasible node {node.name}")
            self.placements.append(PlacementEvent(
                t=t, tenant=wl.name, node=node.name, kind=kind,
                source=source))
            if self.obs is not None:
                self.obs.emit("placement", t=float(t), node=node.name,
                              tenant=wl.name, cause=kind, source=source)
            if source is not None:
                self.replaced.append(wl.name)
            return node
        # Cloud tier: host on the source node (or the first live node,
        # when the source itself failed) as an evicted tenant — requests
        # keep flowing with that node's WAN latency
        host = self._live_host(src_node or self.nodes[0])
        if prior_age:
            # keep the Age_s/Loyalty_s credit on the hosting controller,
            # so a later recovery drain re-places with history intact
            host.ctrl.remember_age(wl.name, prior_age)
        if prior_loyalty:
            host.ctrl.remember_loyalty(wl.name, prior_loyalty)
        host.host_cloud_tenant(wl, tenant_rng=tenant_rng)
        self.placements.append(PlacementEvent(
            t=t, tenant=wl.name, node=None, kind="cloud", source=source))
        if self.obs is not None:
            self.obs.emit("placement", t=float(t), tenant=wl.name,
                          cause="cloud", source=source, host=host.name)
        return None

    def _replace_terminated(self, node: EdgeNodeSim, terminated: list[str],
                            t: int) -> None:
        for name in terminated:
            age = node.ctrl.prior_age(name)        # Age_s carries over
            loyalty = node.ctrl.prior_loyalty(name)  # so does Loyalty_s
            wl = node.workloads[name]
            rng = node.tenant_rngs[name]
            node.remove_tenant(name)
            spec = TenantSpec(
                name=name,
                slo_latency=node.cfg.slo_scale * wl.base_latency,
                users=wl.users(),
                donation=False,     # a migrated refugee no longer donates
                pricing=node.cfg.pricing,
                premium=0.0,        # premium was spent on the first node
            )
            self._place(wl, donation=False, premium=0.0, t=t, spec=spec,
                        tenant_rng=rng, source=node.name, prior_age=age,
                        prior_loyalty=loyalty)

    # ---------------------------------------------------------- faults
    def _fail_node(self, node: EdgeNodeSim, t: int) -> None:
        """Mid-session whole-node failure (``FederationConfig.
        node_failures``): the node stops serving and every tenant it
        hosts — Edge-managed and Cloud-fallback alike — re-places on the
        surviving siblings, or falls back to the Cloud tier hosted on a
        live node. Unlike a Procedure-3 eviction, a failure is the
        infrastructure's fault: refugees keep their original spec
        (donation/premium intact) and are NOT charged Age_s
        (``DyverseController.release_tenant``). The dead node's
        already-served requests still count in Eq. 1."""
        self.failed.add(node.name)       # idempotent under batched faults
        self._ever_failed.add(node.name)
        if self.obs is not None:
            self.obs.emit("node_fail", t=float(t), node=node.name,
                          tenants=len(node.workloads))
        refugees = []
        for name in list(node.workloads):
            age = node.ctrl.prior_age(name)
            loyalty = node.ctrl.prior_loyalty(name)
            st = (node.ctrl.release_tenant(name)
                  if name in node.ctrl.registry else None)
            rng = node.tenant_rngs[name]
            wl = node.remove_tenant(name)
            refugees.append((wl, rng, st, age, loyalty))
        for wl, rng, st, age, loyalty in refugees:
            if st is not None:
                spec, donation, premium = (st.spec, st.spec.donation,
                                           st.spec.premium)
            else:   # was already Cloud-serviced: same refugee contract
                #     an eviction re-placement would carry
                spec = TenantSpec(
                    name=wl.name,
                    slo_latency=node.cfg.slo_scale * wl.base_latency,
                    users=wl.users(), donation=False,
                    pricing=node.cfg.pricing, premium=0.0)
                donation, premium = False, 0.0
            self._place(wl, donation=donation, premium=premium, t=t,
                        spec=spec, tenant_rng=rng, source=node.name,
                        prior_age=age, prior_loyalty=loyalty,
                        kind="failover")

    def _drain_cloud(self, t1: int) -> None:
        """After a node rejoins, re-place Cloud-fallback tenants back
        onto the Edge through the active placement policy (tenant-name
        order for determinism; RNG stream, Age_s and Loyalty_s carried).
        Tenants with no feasible node stay on the Cloud."""
        entries = sorted(
            (name, node) for node in self.nodes
            if node.name not in self.failed for name in node.evicted)
        for name, node in entries:
            wl = node.workloads[name]
            if not self._feasible_nodes(wl):
                continue
            age = node.ctrl.prior_age(name)
            loyalty = node.ctrl.prior_loyalty(name)
            rng = node.tenant_rngs[name]
            node.remove_tenant(name)
            spec = TenantSpec(
                name=name,
                slo_latency=node.cfg.slo_scale * wl.base_latency,
                users=wl.users(),
                donation=False,     # same refugee contract as a migration
                pricing=node.cfg.pricing,
                premium=0.0,
            )
            self._place(wl, donation=False, premium=0.0, t=t1, spec=spec,
                        tenant_rng=rng, prior_age=age,
                        prior_loyalty=loyalty, kind="recover")

    def _due(self, sched: list, t1: int) -> list:
        out = []
        while sched and sched[0][0] <= t1:
            out.append(sched.pop(0))
        return out

    def _node(self, name: str) -> EdgeNodeSim:
        return next(n for n in self.nodes if n.name == name)

    def _apply_faults(self, t1: int) -> None:
        """Fire every scheduled fault event due at this chunk boundary,
        in a fixed order: (1) recoveries mark nodes live again, (2) all
        due failures are marked dead as ONE correlated batch before any
        tenant re-places — so a rack outage's refugees only ever land
        on true survivors, never on a sibling failing in the same event
        (a node recovering and re-failing at the SAME boundary stays
        continuously dead), (3) rejoins drain Cloud-fallback tenants
        back onto the Edge, (4) degradation windows close then open
        (capacity restore before a new contraction cascade), (5) WAN
        spikes clear then start."""
        obs = self.obs
        recovered: list[str] = []
        for _, rnames in self._due(self._pending_recoveries, t1):
            for rname in rnames:
                if rname in self.failed:
                    self.failed.discard(rname)
                    recovered.append(rname)
                    self.recovered.append(rname)
                    if obs is not None:
                        obs.emit("node_recover", t=float(t1), node=rname)

        due: list[str] = []
        while self._pending_failures and self._pending_failures[0][0] <= t1:
            _, fnames = self._pending_failures.pop(0)
            for fname in fnames:
                if fname not in self.failed and fname not in due:
                    due.append(fname)   # duplicate entries: already dead
        if due:
            self.failed.update(due)
            self._ever_failed.update(due)
            for fname in due:
                self._fail_node(self._node(fname), t1)

        if any(r not in self.failed for r in recovered):
            self._drain_cloud(t1)

        for _, dnames in self._due(self._pending_deg_ends, t1):
            for dname in dnames:
                if dname not in self.failed:
                    # growing back to base capacity never evicts
                    self._node(dname).ctrl.resize_capacity(
                        self._base_units[dname])
                    if obs is not None:
                        obs.emit("node_restore", t=float(t1), node=dname,
                                 units=self._base_units[dname])
        for _, dnames, frac in self._due(self._pending_deg_starts, t1):
            for dname in dnames:
                if dname in self.failed:
                    continue            # a dead node cannot degrade
                node = self._node(dname)
                units = max(1, int(self._base_units[dname] * frac))
                terminated = node.ctrl.resize_capacity(units)
                if obs is not None:
                    obs.emit("node_degrade", t=float(t1), node=dname,
                             units=units, terminated=len(terminated))
                self._replace_terminated(node, terminated, t1)

        wan_dirty: set[str] = set()
        for _, wnames, extra in self._due(self._pending_wan_ends, t1):
            for wname in wnames:
                self._wan_extra[wname] -= extra
                wan_dirty.add(wname)
                if obs is not None:
                    obs.emit("wan_fault", t=float(t1), node=wname,
                             cause="end", extra_s=extra)
        for _, wnames, extra in self._due(self._pending_wan_starts, t1):
            for wname in wnames:
                self._wan_extra[wname] += extra
                wan_dirty.add(wname)
                if obs is not None:
                    obs.emit("wan_fault", t=float(t1), node=wname,
                             cause="start", extra_s=extra)
        for wname in sorted(wan_dirty):
            node = self._node(wname)
            node.cfg.wan_extra_latency = (self._base_wan[wname]
                                          + self._wan_extra[wname])
            # fleet steppers cache per-node WAN by epoch — invalidate
            node._fleet_epoch += 1

    # ---------------------------------------------------------- execution
    def run(self) -> FederationResult:
        cfg = self.cfg
        # fleet-capable engines (batched, torch) advance all nodes as ONE
        # stacked (nodes·tenants × seconds) step per chunk; the
        # stepper's caches follow re-placement via the nodes' fleet
        # epochs. Per-node engines return None and step node by node.
        stepper = resolve_engine(cfg.engine).make_stepper(self.nodes)
        t = 0
        while t < cfg.duration_s:
            t1 = min(t + cfg.round_interval, cfg.duration_s)
            if stepper is not None:
                stepper.step(t, t1)
            else:
                for node in self.nodes:
                    if node.name not in self.failed:
                        node.step_chunk(t, t1)
            if cfg.policy != "none" and t1 % cfg.round_interval == 0 \
                    and t1 < cfg.duration_s:
                # all Procedure-1 rounds first, re-placement after: a
                # refugee must never land on a sibling whose round at
                # this same boundary hasn't run yet (it would be scaled
                # down / evictable with zero requests on the books, and
                # outcomes would depend on node iteration order)
                reports = [(n, n.run_controller_round(t1))
                           for n in self.nodes if n.name not in self.failed]
                for node, report in reports:
                    self._replace_terminated(node, report.terminated, t1)
            # faults fire at the boundary, after the rounds: the failing
            # node's last chunk is fully accounted before its tenants move
            self._apply_faults(t1)
            t = t1
        return self._finalize()

    def _finalize(self) -> FederationResult:
        node_results = {n.name: n.finalize() for n in self.nodes}
        total_req = sum(r.total_requests for r in node_results.values())
        total_viol = sum(r.total_violations for r in node_results.values())
        cloud = sorted({n for node in self.nodes for n in node.evicted})
        return FederationResult(
            policy=self.cfg.policy,
            node_results=node_results,
            violation_rate=total_viol / total_req if total_req else 0.0,
            total_requests=total_req,
            total_violations=total_viol,
            placements=self.placements,
            replaced=self.replaced,
            cloud=cloud,
            failed_nodes=sorted(self._ever_failed | self.failed),
            recovered_nodes=sorted(set(self.recovered)),
            events=(list(self.obs.events) if self.obs is not None
                    else []),
        )
