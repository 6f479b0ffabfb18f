"""Serving federation: the real LLM engine under the sim control plane.

This module closes the sim-to-serving loop: a
:class:`ServingFederation` drives N :class:`~repro_torch.serving.engine.
MultiTenantEngine` instances — one per Edge node, each wrapping its own
``QuotaScheduler`` + ``DyverseController`` — under the SAME placement /
re-placement / fault machinery :class:`~repro_torch.sim.federation.
EdgeFederation` applies to the latency-model nodes. The seam between
the two worlds is deliberately narrow:

* **Sim side unchanged.** Placement policies duck-type on
  ``node.ctrl.load_fraction_after()`` / ``node.name`` /
  ``node.cfg.wan_extra_latency`` / ``node.cfg.unit_price`` — a
  :class:`ServingNode` exposes exactly that surface, so every
  ``PlacementPolicy`` and the fault-injection grammar
  (``FederationConfig.node_failures``) work verbatim.
* **Serving side real.** Scaling rounds move *actual* KV-page and
  decode-slot quotas (``_EngineActuator``), Procedure-3 terminations and
  node failures migrate *live request queues* to sibling nodes —
  waiting requests re-submit with their original ``arrival_t``; active
  requests restart cleanly on the new node (KV cannot move, so their
  ``generated`` tokens are cleared; TTFT already served stays) — before
  the Cloud/WAN fallback is paid. Completed requests feed per-request
  token latencies into ``Monitor.record_request``, so Eq. 1 violation
  rates are measured on real decode timelines, not a latency model.

Determinism contract (virtual clock)
====================================

Every timestamp the engines take — arrival, first token, finish — comes
from one shared :class:`VirtualClock` that advances ``step_dt`` per
engine step, and every stochastic choice (arrival counts, prompt
tokens, donation/premium draws) comes from generators seeded by
``FederationConfig.seed``. Greedy decode on seeded parameters makes the
token streams deterministic too. Two runs of the same scenario
therefore produce IDENTICAL violation-rate and latency tables — wall
clock never leaks into results (it is reported separately as overhead).
This is what makes the serving path usable as a regression surface.
Outcomes depend only on the clock and on token counts, never on the
model's numbers, so the same scenario gives the same results on the
card and on the CPU (``device``), and the same as the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import TenantSpec
from repro_torch.obs.metrics import percentile_bands
from repro_torch.serving.request import Phase
from repro_torch.serving.spec import (ServingClassSpec, ServingSpec,  # noqa: F401
                                VirtualClock)
from repro_torch.sim.edgesim import WAN_EXTRA_LATENCY, SimResult
from repro_torch.sim.federation import (FederationConfig, FederationResult,
                                  PlacementEvent, resolve_placement)
from repro_torch.sim.workload import Workload


@dataclass
class _NodeLink:
    """The ``node.cfg`` surface the placement policies duck-type on."""

    wan_extra_latency: float
    unit_price: float


class ServingNode:
    """One Edge node of the serving federation: a real engine plus the
    federation-facing bookkeeping (placement surface, cloud-tier
    accounting, collected round reports)."""

    def __init__(self, name: str, capacity_units: int, link: _NodeLink,
                 fed_cfg: FederationConfig, spec: ServingSpec,
                 clock: VirtualClock, seed: int, device="cuda"):
        from repro_torch.serving.engine import EngineConfig, MultiTenantEngine
        self.name = name
        self.cfg = link
        self.spec = spec
        self.capacity_units = capacity_units
        self.engine = MultiTenantEngine(EngineConfig(
            page_size=spec.page_size,
            slot_cap=spec.slot_cap,
            max_seq_len=spec.max_seq_len,
            round_interval_steps=10 ** 9,   # the federation drives rounds
            policy=fed_cfg.policy,
            capacity_slots=capacity_units,
            capacity_pages=capacity_units * spec.pages_per_unit,
            default_units=fed_cfg.default_units,
        ), seed=seed, clock=clock, device=device)
        # cloud-tier request samples accounted on this node (WAN paid)
        self.cloud_lats: list[float] = []
        self.cloud_slos: list[float] = []
        # load-shed request samples (graceful degradation): counted as
        # SLO violations, never silently dropped
        self.shed_lats: list[float] = []
        self.shed_slos: list[float] = []
        # every Cloud/shed sample keyed by tenant, so the federation can
        # aggregate token-level latency bands per tenant class (the
        # Edge-completed samples come off ``engine.completed`` directly)
        self.lat_by_tenant: dict[str, list[float]] = {}
        # collected RoundReports (overhead + action streams)
        self.reports: list = []

    @property
    def ctrl(self):
        return self.engine.ctrl

    def record_cloud(self, tenant: str, latency: float, slo: float) -> None:
        self.ctrl.monitor.record_request(tenant, latency, slo)
        self.cloud_lats.append(latency)
        self.cloud_slos.append(slo)
        self.lat_by_tenant.setdefault(tenant, []).append(latency)

    def record_shed(self, tenant: str, latency: float, slo: float) -> None:
        self.ctrl.monitor.record_request(tenant, latency, slo)
        self.shed_lats.append(latency)
        self.shed_slos.append(slo)
        self.lat_by_tenant.setdefault(tenant, []).append(latency)

    def finalize(self, slo_of: dict[str, float]) -> SimResult:
        mon = self.ctrl.monitor
        lats = [rs.latency() for rs in self.engine.completed]
        slos = [slo_of[rs.req.tenant] for rs in self.engine.completed]
        lats += self.cloud_lats + self.shed_lats
        slos += self.cloud_slos + self.shed_slos
        total_req = mon.total_requests
        total_viol = mon.total_violations
        return SimResult(
            policy=self.engine.cfg.policy,
            violation_rate=total_viol / total_req if total_req else 0.0,
            latencies=np.asarray(lats, np.float64),
            slos=np.asarray(slos, np.float64),
            overhead_priority_s=[r.priority_update_s for r in self.reports],
            overhead_scaling_s=[r.scaling_s for r in self.reports],
            overhead_forecast_s=[r.forecast_s for r in self.reports],
            terminated=[t for r in self.reports for t in r.terminated],
            round_actions=[r.actions for r in self.reports],
            total_requests=total_req,
            total_violations=total_viol,
        )


@dataclass
class ServingFederationResult(FederationResult):
    """FederationResult plus the serving-only aggregates the latency
    model cannot produce."""

    tokens: int = 0                 # generated tokens, federation-wide
    completed: int = 0              # requests served by Edge engines
    cloud_requests: int = 0         # requests serviced on the Cloud tier
    virtual_duration_s: float = 0.0
    shed: int = 0                   # load-shed requests (violations)
    submitted: int = 0              # every request the federation took
    # the request-conservation invariant, asserted by _finalize:
    # submitted == completed + cloud_requests (+ engine strays) + shed
    requests_conserved: bool = True
    # TOKEN-level latency bands per tenant class, over every accounted
    # request (Edge-completed + Cloud + shed): {class prefix:
    # {"p50", "p95", "p99", "n"}} in virtual seconds — the real-decode
    # companion to the latency-model band fractions
    token_latency_bands: dict = field(default_factory=dict)


class ServingFederation:
    """Drive N real engines under the sim federation's control plane.

    ``workloads`` supplies the tenant fleet (names, users, base
    latencies) exactly as for :class:`~repro_torch.sim.federation.
    EdgeFederation`; ``spec`` supplies the engine-side shape. The
    donation/premium draws replicate the sim federation's RNG pattern
    (federation-side, in fleet order) so serving scenarios and sim
    scenarios describe tenants identically. Every engine runs on
    ``device``."""

    def __init__(self, workloads: list[Workload], cfg: FederationConfig,
                 spec: ServingSpec, device="cuda"):
        from repro_torch.configs import get_reduced
        from repro_torch.serving.engine import CLOUD_LATENCY_S
        self.cfg = cfg
        self.spec = spec
        self.cloud_latency_s = CLOUD_LATENCY_S
        self.placement = resolve_placement(cfg.placement)
        self.clock = VirtualClock(spec.step_dt)
        names = [wl.name for wl in workloads]
        if len(set(names)) != len(names):
            raise ValueError("duplicate tenant names in federation fleet")
        self.fleet = list(workloads)
        self.wl = {wl.name: wl for wl in workloads}
        self.cls = {wl.name: spec.class_for(wl.name) for wl in workloads}
        self.model_cfg = {wl.name: get_reduced(self.cls[wl.name].arch)
                          for wl in workloads}
        self.slo = {
            wl.name: (self.cls[wl.name].slo_s
                      if self.cls[wl.name].slo_s is not None
                      else cfg.slo_scale * wl.base_latency)
            for wl in workloads}
        self.nodes = [
            ServingNode(
                name=f"edge{i}",
                capacity_units=cfg._per_node(cfg.node_capacities, i,
                                             cfg.capacity_units),
                link=_NodeLink(
                    wan_extra_latency=cfg._per_node(
                        cfg.node_wan_latency_s, i, WAN_EXTRA_LATENCY),
                    unit_price=cfg._per_node(cfg.node_unit_price, i, 1.0)),
                fed_cfg=cfg, spec=spec, clock=self.clock,
                seed=cfg.seed + i, device=device)
            for i in range(cfg.n_nodes)
        ]
        for node in self.nodes:
            node.engine.evict_hook = \
                lambda tenant, rts, n=node: self._on_evict(n, tenant, rts)
        # optional flight recorder (repro_torch.obs). MultiTenantEngine builds
        # its controller internally, so instrument each one post-hoc;
        # None = tracing off (hot paths pay one ``is None`` predicate)
        self.obs = cfg.recorder
        if self.obs is not None:
            for node in self.nodes:
                node.ctrl.recorder = self.obs
                node.ctrl.node_name = node.name
        self.placements: list[PlacementEvent] = []
        self.replaced: list[str] = []
        self.failed: set[str] = set()
        self._ever_failed: set[str] = set()
        self.recovered: list[str] = []
        self._submitted = 0
        self.cloud_tenants: dict[str, ServingNode] = {}   # name → host node
        self.hosted: dict[str, ServingNode] = {}
        self._pending_migrations: list[tuple[ServingNode, str, list]] = []
        self._validate_faults()
        # spec draws federation-side in fleet order (same pattern as the
        # sim federation, so placement never perturbs a sibling's roll)
        rng = np.random.default_rng(cfg.seed)
        # per-tenant arrival streams owned by the federation, NOT the
        # nodes: the stream follows the tenant across migrations, and is
        # identical across the policy sweep (equal-workload comparisons)
        self.rngs = {wl.name: np.random.default_rng([cfg.seed, i])
                     for i, wl in enumerate(self.fleet)}
        for wl in self.fleet:
            donation = bool(rng.random() < cfg.donation_fraction)
            premium = float(rng.random() < 0.25)
            self._place(wl, donation=donation, premium=premium, t=0.0)

    # ---------------------------------------------------------- validation
    def _validate_faults(self) -> None:
        cfg, spec = self.cfg, self.spec
        node_names = {n.name for n in self.nodes}
        rv = spec.round_virtual_s
        end = spec.duration_virtual_s

        def names_of(fnodes, what: str, ft) -> tuple[str, ...]:
            names = (fnodes,) if isinstance(fnodes, str) else tuple(fnodes)
            if not names:
                raise ValueError(f"{what} at t={ft} names no nodes")
            for fname in names:
                if fname not in node_names:
                    raise ValueError(f"{what}s names unknown node "
                                     f"{fname!r} (have {sorted(node_names)})")
            return names

        def boundary(t) -> float:
            return float(np.ceil(t / rv)) * rv

        normalized: list[tuple[float, tuple[str, ...]]] = []
        recoveries: list[tuple[float, tuple[str, ...]]] = []
        windows: list[tuple[float, float, str]] = []
        for entry in cfg.node_failures:
            ft, fnodes = entry[0], entry[1]
            rt = entry[2] if len(entry) > 2 else None
            fnames = names_of(fnodes, "node failure", ft)
            if not 0 < ft:
                raise ValueError(f"node failure at t={ft} must be > 0")
            fb = boundary(ft)
            if fb >= end:
                raise ValueError(
                    f"node failure at t={ft} would never fire: its round "
                    f"boundary {fb:g} is not before the virtual "
                    f"session end {end:g}")
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
                        f"shares round boundary {fb:g} with the failure — "
                        f"the node would never be down")
                if rb >= end:
                    raise ValueError(
                        f"node recovery at t={rt} would never fire: its "
                        f"round boundary {rb:g} is not before the virtual "
                        f"session end {end:g}")
                recoveries.append((float(rt), fnames))
            normalized.append((float(ft), fnames))
            for nm in fnames:
                windows.append((fb, np.inf if rb is None else rb, nm))
        # concurrently-dead check: at any failure boundary at least one
        # node must survive
        for fb, _, _ in windows:
            dead = {nm for lo, hi, nm in windows if lo <= fb < hi}
            if len(dead) >= cfg.n_nodes:
                raise ValueError("node_failures would kill every node")

        deg_starts: list[tuple[float, tuple[str, ...], float]] = []
        deg_ends: list[tuple[float, tuple[str, ...]]] = []
        for t0, t1, dnodes, frac in cfg.node_degradations:
            dnames = names_of(dnodes, "node degradation", t0)
            if not 0 < t0 < t1:
                raise ValueError(f"degradation window [{t0}, {t1}) must "
                                 f"satisfy 0 < t0 < t1")
            if not 0.0 < frac <= 1.0:
                raise ValueError(f"degradation capacity_fraction {frac} "
                                 f"must be in (0, 1]")
            if boundary(t0) >= end:
                raise ValueError(
                    f"node degradation at t={t0} would never fire: its "
                    f"round boundary {boundary(t0):g} is not before the "
                    f"virtual session end {end:g}")
            deg_starts.append((float(t0), dnames, float(frac)))
            deg_ends.append((float(t1), dnames))
        wan_starts: list[tuple[float, tuple[str, ...], float]] = []
        wan_ends: list[tuple[float, tuple[str, ...], float]] = []
        for t0, t1, wnodes, extra in cfg.wan_faults:
            wnames = names_of(wnodes, "WAN fault", t0)
            if not 0 < t0 < t1:
                raise ValueError(f"WAN fault window [{t0}, {t1}) must "
                                 f"satisfy 0 < t0 < t1")
            if extra < 0:
                raise ValueError(f"WAN fault extra_latency_s {extra} "
                                 f"must be >= 0")
            if boundary(t0) >= end:
                raise ValueError(
                    f"WAN fault at t={t0} would never fire: its round "
                    f"boundary {boundary(t0):g} is not before the "
                    f"virtual session end {end:g}")
            wan_starts.append((float(t0), wnames, float(extra)))
            wan_ends.append((float(t1), wnames, float(extra)))

        self._pending_failures = sorted(normalized)
        self._pending_recoveries = sorted(recoveries)
        self._pending_deg_starts = sorted(deg_starts)
        self._pending_deg_ends = sorted(deg_ends)
        self._pending_wan_starts = sorted(wan_starts)
        self._pending_wan_ends = sorted(wan_ends)
        self._base_units = {n.name: n.capacity_units for n in self.nodes}
        self._base_wan = {n.name: n.cfg.wan_extra_latency
                          for n in self.nodes}
        self._wan_extra = {n.name: 0.0 for n in self.nodes}

    # ---------------------------------------------------------- placement
    def _feasible_nodes(self, wl: Workload,
                        exclude: ServingNode | None = None):
        cands = [n for n in self.nodes
                 if n is not exclude and n.name not in self.failed
                 and n.ctrl.can_admit()]
        return sorted(cands, key=lambda n: self.placement.key(n, wl))

    def _live_host(self, preferred: ServingNode | None) -> ServingNode:
        if preferred is not None and preferred.name not in self.failed:
            return preferred
        for n in self.nodes:
            if n.name not in self.failed:
                return n
        raise RuntimeError("no live node left to host the Cloud tier")

    def _place(self, wl: Workload, *, donation: bool, premium: float,
               t: float, spec: TenantSpec | None = None,
               source: str | None = None, prior_age: int = 0,
               prior_loyalty: int = 0,
               kind: str | None = None) -> ServingNode | None:
        if kind is None:
            kind = "admit" if source is None else "replace"
        src_node = next((n for n in self.nodes if n.name == source), None)
        feasible = self._feasible_nodes(wl, exclude=src_node)
        if feasible:
            node = feasible[0]
            if prior_age:
                node.ctrl.remember_age(wl.name, prior_age)
            if prior_loyalty:
                node.ctrl.remember_loyalty(wl.name, prior_loyalty)
            tspec = spec if spec is not None else TenantSpec(
                name=wl.name,
                slo_latency=self.slo[wl.name],
                users=wl.users(),
                donation=donation,
                pricing=self.cfg.pricing,
                premium=premium,
            )
            if not node.engine.add_tenant(tspec, self.model_cfg[wl.name]):
                raise RuntimeError(
                    f"admit refused on feasible node {node.name}")
            self.hosted[wl.name] = node
            self.cloud_tenants.pop(wl.name, None)
            self.placements.append(PlacementEvent(
                t=round(t), tenant=wl.name, node=node.name, kind=kind,
                source=source))
            if self.obs is not None:
                self.obs.emit("placement", t=float(t), node=node.name,
                              tenant=wl.name, cause=kind, source=source)
            if source is not None:
                self.replaced.append(wl.name)
            return node
        host = self._live_host(src_node or self.nodes[0])
        if prior_age:
            # keep the credit on the hosting controller so a recovery
            # drain can re-place with Age_s/Loyalty_s intact
            host.ctrl.remember_age(wl.name, prior_age)
        if prior_loyalty:
            host.ctrl.remember_loyalty(wl.name, prior_loyalty)
        self.hosted.pop(wl.name, None)
        self.cloud_tenants[wl.name] = host
        self.placements.append(PlacementEvent(
            t=round(t), tenant=wl.name, node=None, kind="cloud",
            source=source))
        if self.obs is not None:
            self.obs.emit("placement", t=float(t), tenant=wl.name,
                          cause="cloud", source=source, host=host.name)
        return None

    # ---------------------------------------------------------- migration
    def _on_evict(self, node: ServingNode, tenant: str, rts: list) -> bool:
        """``MultiTenantEngine.evict_hook``: claim a Procedure-3 victim's
        live queue so the federation can migrate it (sibling first,
        Cloud second) instead of the engine's default Cloud path."""
        if self.obs is not None:
            self.obs.emit("serving_preempt", node=node.name, tenant=tenant,
                          n=len(rts))
        self._pending_migrations.append((node, tenant, rts))
        return True

    def _cloud_flush(self, host: ServingNode, tenant: str,
                     rts: list, now: float) -> None:
        """Queue of a tenant nowhere placeable: every request is serviced
        by the origin Cloud server — queueing already paid plus the WAN
        round-trip and the Cloud service latency."""
        slo = self.slo[tenant]
        extra = host.cfg.wan_extra_latency + self.cloud_latency_s
        if self.obs is not None:
            self.obs.emit("serving_cloud", t=float(now), node=host.name,
                          tenant=tenant, n=len(rts))
        for rs in rts:
            rs.finish_t = now + extra
            host.record_cloud(tenant, rs.finish_t - rs.req.arrival_t, slo)

    def _migrate_queue(self, dest: ServingNode, rts: list) -> None:
        """Hand a migrated tenant's live queue to its new node. Waiting
        requests re-enqueue untouched; requests that were mid-decode
        restart from their prompt (the KV cache cannot move across
        nodes) but keep their arrival time and served TTFT."""
        for rs in rts:
            if rs.generated:
                rs.generated.clear()
            dest.engine.sched.requeue(rs)

    def _migrate_pending(self, t: float) -> None:
        for node, tenant, rts in self._pending_migrations:
            wl = self.wl[tenant]
            age = node.ctrl.prior_age(tenant)
            loyalty = node.ctrl.prior_loyalty(tenant)
            spec = TenantSpec(
                name=tenant,
                slo_latency=self.slo[tenant],
                users=wl.users(),
                donation=False,     # a migrated refugee no longer donates
                pricing=self.cfg.pricing,
                premium=0.0,        # premium was spent on the first node
            )
            dest = self._place(wl, donation=False, premium=0.0, t=t,
                               spec=spec, source=node.name, prior_age=age,
                               prior_loyalty=loyalty)
            if dest is not None:
                self._migrate_queue(dest, rts)
            else:
                self._cloud_flush(self._live_host(node), tenant, rts, t)
        self._pending_migrations.clear()

    # ---------------------------------------------------------- faults
    def _fail_node(self, node: ServingNode, t: float) -> None:
        """Whole-node failure: every tenant the node hosts re-places on
        the surviving siblings with its spec intact (the infrastructure's
        fault — no Age_s charge, ``release_tenant``), its live queue
        migrating with it; Cloud-tier tenants it hosted move their
        accounting to a live node. Requests the dead node already served
        still count in Eq. 1."""
        self.failed.add(node.name)
        self._ever_failed.add(node.name)
        eng = node.engine
        if self.obs is not None:
            self.obs.emit("node_fail", t=float(t), node=node.name,
                          tenants=len(eng.ctrl.registry))
        refugees = []
        for name in list(eng.ctrl.registry):
            age = node.ctrl.prior_age(name)
            loyalty = node.ctrl.prior_loyalty(name)
            st = eng.ctrl.release_tenant(name)
            rts = eng.sched.remove_tenant(name)
            eng.tenants.pop(name, None)
            refugees.append((name, st, rts, age, loyalty))
        for name, st, rts, age, loyalty in refugees:
            wl = self.wl[name]
            dest = self._place(wl, donation=st.spec.donation,
                               premium=st.spec.premium, t=t, spec=st.spec,
                               source=node.name, prior_age=age,
                               prior_loyalty=loyalty, kind="failover")
            if dest is not None:
                self._migrate_queue(dest, rts)
            else:
                self._cloud_flush(self._live_host(None), name, rts, t)
        for name, host in list(self.cloud_tenants.items()):
            if host is node:
                self.cloud_tenants[name] = self._live_host(None)

    def _drain_cloud(self, t1: float) -> None:
        """After a node rejoins, re-place Cloud-fallback tenants back
        onto the Edge (tenant-name order; Age_s/Loyalty_s carried from
        the hosting controller). Tenants with no feasible node stay on
        the Cloud."""
        for name in sorted(self.cloud_tenants):
            wl = self.wl[name]
            if not self._feasible_nodes(wl):
                continue
            host = self.cloud_tenants[name]
            age = host.ctrl.prior_age(name)
            loyalty = host.ctrl.prior_loyalty(name)
            spec = TenantSpec(
                name=name,
                slo_latency=self.slo[name],
                users=wl.users(),
                donation=False,     # same refugee contract as a migration
                pricing=self.cfg.pricing,
                premium=0.0,
            )
            self._place(wl, donation=False, premium=0.0, t=t1, spec=spec,
                        prior_age=age, prior_loyalty=loyalty,
                        kind="recover")

    def _due(self, sched: list, t1: float) -> list:
        out = []
        while sched and sched[0][0] <= t1:
            out.append(sched.pop(0))
        return out

    def _node(self, name: str) -> ServingNode:
        return next(n for n in self.nodes if n.name == name)

    def _apply_faults(self, t1: float) -> None:
        """Same fixed order as the sim federation: recoveries, then all
        due failures as one correlated batch, then the Cloud→Edge
        recovery drain, then degradation restores/starts (the
        contraction cascade's evicted queues migrate immediately), then
        WAN clears/starts."""
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
                    due.append(fname)
        if due:
            self.failed.update(due)      # all dead before any re-placement
            self._ever_failed.update(due)
            for fname in due:
                self._fail_node(self._node(fname), t1)

        if any(r not in self.failed for r in recovered):
            self._drain_cloud(t1)

        for _, dnames in self._due(self._pending_deg_ends, t1):
            for dname in dnames:
                if dname not in self.failed:
                    self._node(dname).ctrl.resize_capacity(
                        self._base_units[dname])
                    if obs is not None:
                        obs.emit("node_restore", t=float(t1), node=dname,
                                 units=self._base_units[dname])
        degraded = False
        for _, dnames, frac in self._due(self._pending_deg_starts, t1):
            for dname in dnames:
                if dname in self.failed:
                    continue             # a dead node cannot degrade
                node = self._node(dname)
                units = max(1, int(self._base_units[dname] * frac))
                node.ctrl.resize_capacity(units)
                degraded = True
                if obs is not None:
                    obs.emit("node_degrade", t=float(t1), node=dname,
                             units=units)
        if degraded:
            # the cascade's victims handed their live queues to
            # evict_hook — migrate them now, at the same boundary
            self._migrate_pending(t1)

        for _, wnames, extra in self._due(self._pending_wan_ends, t1):
            for wname in wnames:
                self._wan_extra[wname] -= extra
                self._node(wname).cfg.wan_extra_latency = \
                    self._base_wan[wname] + self._wan_extra[wname]
                if obs is not None:
                    obs.emit("wan_fault", t=float(t1), node=wname,
                             cause="end", extra_s=extra)
        for _, wnames, extra in self._due(self._pending_wan_starts, t1):
            for wname in wnames:
                self._wan_extra[wname] += extra
                self._node(wname).cfg.wan_extra_latency = \
                    self._base_wan[wname] + self._wan_extra[wname]
                if obs is not None:
                    obs.emit("wan_fault", t=float(t1), node=wname,
                             cause="start", extra_s=extra)

    # ---------------------------------------------------------- resilience
    def _apply_timeouts(self, now: float) -> None:
        """Per-request timeouts on the virtual clock: a request not
        finished ``timeout_s`` after (re-)submission leaves its decode
        slot / KV pages, re-enqueues with capped exponential backoff
        while it has retries left, and is Cloud-serviced after that.
        Mid-decode victims restart from the prompt on re-admission (the
        same restart-clean semantics as a cross-node migration)."""
        spec = self.spec
        if spec.timeout_s is None:
            return
        for node in self._live_nodes():
            sched = node.engine.sched
            for name in list(sched.tenants):
                tq = sched.tenants[name]
                timed_out = [rs for rs in list(tq.active) + list(tq.waiting)
                             if rs.timeout_t is not None
                             and now > rs.timeout_t]
                if not timed_out:
                    continue
                rt = node.engine.tenants.get(name)
                for rs in timed_out:
                    if rs in tq.active:
                        tq.active.remove(rs)
                        if rt is not None and rs.batch_slot >= 0 \
                                and rt.slot_req[rs.batch_slot] is rs:
                            rt.slot_req[rs.batch_slot] = None
                        rs.batch_slot = -1
                    else:
                        tq.waiting.remove(rs)
                    if rs.retries < spec.retry_limit:
                        rs.retries += 1
                        backoff = min(
                            spec.backoff_base_s * 2.0 ** (rs.retries - 1),
                            spec.backoff_cap_s)
                        rs.generated.clear()
                        rs.phase = Phase.QUEUED
                        rs.not_before = now + backoff
                        rs.timeout_t = rs.not_before + spec.timeout_s
                        tq.waiting.append(rs)
                        if self.obs is not None:
                            self.obs.emit("serving_retry", t=float(now),
                                          node=node.name, tenant=name,
                                          retries=rs.retries)
                    else:                # retry budget spent → Cloud
                        rs.phase = Phase.EVICTED
                        if self.obs is not None:
                            self.obs.emit("serving_timeout", t=float(now),
                                          node=node.name, tenant=name,
                                          cause="retry_budget")
                        self._cloud_flush(node, name, [rs], now)

    def _shed_excess(self, now: float) -> None:
        """Graceful degradation: while a node's total admission-queue
        depth exceeds ``shed_depth``, the lowest-priority tenant with a
        queue sheds its YOUNGEST waiting request — accounted as a
        guaranteed SLO violation (the user is redirected to the origin),
        never silently dropped."""
        depth_cap = self.spec.shed_depth
        if depth_cap is None:
            return
        for node in self._live_nodes():
            sched = node.engine.sched
            total = sum(len(tq.waiting) for tq in sched.tenants.values())
            while total > depth_cap:
                cands = [name for name, tq in sched.tenants.items()
                         if tq.waiting]
                if not cands:
                    break
                victim = min(cands, key=lambda nm: (
                    node.ctrl.registry[nm].priority, nm))
                rs = sched.tenants[victim].waiting.pop()
                rs.phase = Phase.EVICTED
                slo = self.slo[victim]
                lat = (slo + node.cfg.wan_extra_latency
                       + self.cloud_latency_s)
                rs.finish_t = rs.req.arrival_t + lat
                node.record_shed(victim, lat, slo)
                if self.obs is not None:
                    self.obs.emit("serving_shed", t=float(now),
                                  node=node.name, tenant=victim)
                total -= 1

    # ---------------------------------------------------------- execution
    def _submit_arrivals(self) -> None:
        """One step's Poisson arrivals for every tenant, in fleet order.
        Cloud-tier tenants draw from the SAME stream (their requests are
        serviced by the origin over the WAN), so a tenant's workload is
        independent of where it happens to be hosted."""
        obs = self.obs
        for wl in self.fleet:
            name = wl.name
            c = self.cls[name]
            rng = self.rngs[name]
            k = int(rng.poisson(c.rate))
            for _ in range(k):
                prompt = [int(x) for x in
                          rng.integers(1, self.spec.vocab, c.prompt_len)]
                self._submitted += 1
                node = self.hosted.get(name)
                if node is not None and node.name not in self.failed:
                    rs = node.engine.submit(name, prompt,
                                            max_new_tokens=c.max_new_tokens,
                                            user=wl.users())
                    if self.spec.timeout_s is not None:
                        rs.timeout_t = (rs.req.arrival_t
                                        + self.spec.timeout_s)
                    if obs is not None:
                        obs.emit("serving_admit", node=node.name,
                                 tenant=name)
                else:
                    host = self._live_host(self.cloud_tenants.get(name))
                    host.record_cloud(
                        name, host.cfg.wan_extra_latency
                        + self.cloud_latency_s, self.slo[name])
                    if obs is not None:
                        obs.emit("serving_admit", tenant=name,
                                 cause="cloud", host=host.name)

    def _live_nodes(self) -> list[ServingNode]:
        return [n for n in self.nodes if n.name not in self.failed]

    def run(self) -> ServingFederationResult:
        spec, cfg = self.spec, self.cfg
        obs = self.obs
        for r in range(spec.rounds):
            for _ in range(spec.steps_per_round):
                self.clock.tick()
                if obs is not None:
                    obs.now = self.clock()
                self._submit_arrivals()
                self._shed_excess(self.clock())
                for node in self._live_nodes():
                    node.engine.step()
                self._apply_timeouts(self.clock())
            t1 = (r + 1) * spec.round_virtual_s
            if cfg.policy != "none" and t1 < spec.duration_virtual_s:
                # all rounds first, re-placement after — a refugee must
                # never land on a sibling whose round at this boundary
                # hasn't run yet (same ordering as the sim federation)
                for node in self._live_nodes():
                    if obs is None:
                        node.reports.append(node.ctrl.run_round())
                    else:
                        obs.now = float(t1)
                        report = node.ctrl.run_round()
                        node.reports.append(report)
                        phases = dict(report.phases or {})
                        for k, v in phases.items():
                            obs.observe_phase(k, v)
                        obs.emit("round", t=float(t1), node=node.name,
                                 round=r, cause=cfg.policy,
                                 dur=float(spec.round_virtual_s), **phases)
                self._migrate_pending(t1)
            self._apply_faults(t1)
        # let in-flight requests finish (no new arrivals, no rounds)
        for _ in range(spec.drain_steps):
            live = self._live_nodes()
            if not any(tq.active or tq.waiting
                       for n in live
                       for tq in n.engine.sched.tenants.values()):
                break
            self.clock.tick()
            if obs is not None:
                obs.now = self.clock()
            for node in live:
                node.engine.step()
            self._apply_timeouts(self.clock())
        # anything still stuck after the drain cap is Cloud-serviced so
        # every submitted request is accounted exactly once
        now = self.clock()
        for node in self._live_nodes():
            for name in list(node.engine.sched.tenants):
                tq = node.engine.sched.tenants[name]
                leftovers = list(tq.active) + list(tq.waiting)
                if leftovers:
                    tq.active.clear()
                    tq.waiting.clear()
                    self._cloud_flush(node, name, leftovers, now)
        return self._finalize()

    def _finalize(self) -> ServingFederationResult:
        node_results = {n.name: n.finalize(self.slo) for n in self.nodes}
        total_req = sum(r.total_requests for r in node_results.values())
        total_viol = sum(r.total_violations for r in node_results.values())
        completed = sum(len(n.engine.completed) for n in self.nodes)
        tokens = sum(len(rs.generated)
                     for n in self.nodes for rs in n.engine.completed)
        cloud_req = sum(len(n.cloud_lats) for n in self.nodes)
        shed = sum(len(n.shed_lats) for n in self.nodes)
        # requests that slipped through an engine's own Cloud path
        # (unknown-tenant submit) — normally zero in a federation run
        strays = sum(len(n.engine.cloud_serviced) for n in self.nodes)
        # the request-conservation invariant, a cheap post-run
        # assertion: every submitted request is accounted exactly once
        if self._submitted != completed + cloud_req + strays + shed:
            raise RuntimeError(
                f"request conservation violated: submitted "
                f"{self._submitted} != completed {completed} + cloud "
                f"{cloud_req + strays} + shed {shed}")
        # token-level latency bands per tenant class, over every
        # accounted sample: Edge-completed real decode timelines plus
        # the Cloud/shed latencies already recorded per tenant
        by_class: dict[str, list] = {}
        for n in self.nodes:
            for rs in n.engine.completed:
                by_class.setdefault(
                    self.cls[rs.req.tenant].prefix, []).append(rs.latency())
            for tname, ls in n.lat_by_tenant.items():
                by_class.setdefault(self.cls[tname].prefix, []).extend(ls)
        token_bands = {p: percentile_bands(a)
                       for p, a in sorted(by_class.items()) if a}
        return ServingFederationResult(
            policy=self.cfg.policy,
            node_results=node_results,
            violation_rate=total_viol / total_req if total_req else 0.0,
            total_requests=total_req,
            total_violations=total_viol,
            placements=self.placements,
            replaced=self.replaced,
            cloud=sorted(self.cloud_tenants),
            failed_nodes=sorted(self._ever_failed | self.failed),
            recovered_nodes=sorted(set(self.recovered)),
            tokens=tokens,
            completed=completed,
            cloud_requests=cloud_req,
            virtual_duration_s=self.clock(),
            shed=shed,
            submitted=self._submitted,
            requests_conserved=True,
            token_latency_bands=token_bands,
            events=(list(self.obs.events) if self.obs is not None else []),
        )
