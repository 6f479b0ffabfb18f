"""DyverseController — the Edge Manager + Auto-scaler of the paper.

Owns the tenant registry, the resource pool, and the Monitor; executes
Procedure 1 (priority-ordered dynamic vertical scaling), Procedure 2
(scale with eviction) and Procedure 3 (termination/migration) each round.

The controller is actuator-agnostic: an Actuator receives quota changes
and terminations. In the simulator the actuator adjusts the modelled
service rate; in the serving engine it adjusts the scheduler's per-tenant
slot/page quotas (control-plane only — no data movement, which is what
keeps DYVERSE vertical scaling sub-second at 32+ tenants).

Array-native control plane (``control_plane="array"``, the default):
:class:`TenantState` stays the API surface, but every per-tenant counter
the round hot path touches (priority, age, loyalty, reward/scale counts,
active flag, SLO thresholds, units) lives in slot-aligned numpy columns
(:class:`_StateCols`) sharing the Monitor's :class:`SlotTable`. Each
round then

* scores all tenants straight off the arrays (one ``batch_scores_np``
  call on gathered columns — no per-tenant list building),
* classifies scale-up / donation-band / scale-down / floor-blocked for
  the whole fleet with a handful of vectorised comparisons, and
* keeps only the inherently-sequential eviction cascade of Procedure 2
  as a loop, fed by the round's presorted (priority, name) order instead
  of an O(N) victim rescan per eviction.

``control_plane="reference"`` retains the original dict/dataclass loop
(with :class:`~repro_torch.core.monitor.DictMonitor`) — the two paths are
bitwise-identical, pinned by the control-plane equivalence tests and the
``ctrlscale`` benchmark.

Orthogonally, ``scaling_policy`` selects what a round scales ON
(:mod:`repro_torch.core.forecast`): ``"reactive"`` (default) keeps the
paper's Procedure 2 bitwise-identical to the pre-forecast controller;
``"proactive"`` pre-scales tenants their forecast predicts will violate
(from free headroom, never evictions) while realised violations keep
full Procedure-2 mechanics; ``"hybrid"`` additionally falls back to the
pure reactive branch wherever the forecast has recently been wrong. The
per-round metric history feeding the forecasters is recorded at every
``roll_round`` under ALL scaling policies — recording is deterministic
numpy and draws no randomness, so it cannot perturb the reactive path.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Protocol

import numpy as np

from repro_torch.core.forecast import (SCALING_POLICIES, Forecaster,
                                       ForecastEngine)
from repro_torch.core.monitor import DictMonitor, Monitor, SlotTable
from repro_torch.core.priority import (POLICIES, batch_scores_normalized,
                                       batch_scores_np)
from repro_torch.core.quota import NodeCapacity, PoolError, ResourcePool
from repro_torch.core.types import (Decision, PricingModel, Quota,
                                    ResourceUnit, RoundAction, RoundReport,
                                    TenantSpec, TenantState, Weights)

CONTROL_PLANES = ("array", "reference")


def _network_always_ok(tenant: str) -> bool:
    """Default network probe — a sentinel, so the round can tell whether
    a real callback was installed (even after construction)."""
    return True


class Actuator(Protocol):
    def apply_quota(self, tenant: str, quota: Quota) -> None: ...
    def terminate(self, tenant: str) -> None: ...


class NullActuator:
    def apply_quota(self, tenant: str, quota: Quota) -> None: ...
    def terminate(self, tenant: str) -> None: ...


@dataclass
class AdmissionResult:
    admitted: bool
    reason: str = ""


class _StateCols:
    """Slot-aligned per-tenant controller state (struct-of-arrays twin
    of the TenantState registry + the spec constants the round needs)."""

    __slots__ = ("premium", "ordinal", "age", "loyalty", "scale", "reward",
                 "pfp", "priority", "active", "slo", "dthr_slo", "donation",
                 "min_units", "units")
    _DTYPES = {"premium": np.float64, "ordinal": np.int64, "age": np.int64,
               "loyalty": np.int64, "scale": np.int64, "reward": np.int64,
               "pfp": np.bool_, "priority": np.float64, "active": np.bool_,
               "slo": np.float64, "dthr_slo": np.float64,
               "donation": np.bool_, "min_units": np.int64,
               "units": np.int64}

    def __init__(self, slots: SlotTable):
        for f in self.__slots__:
            setattr(self, f, np.zeros(slots.capacity, self._DTYPES[f]))
        slots.attach(self)

    def _grow_columns(self, cap: int) -> None:
        for f in self.__slots__:
            old = getattr(self, f)
            new = np.zeros(cap, old.dtype)
            new[: old.size] = old
            setattr(self, f, new)


class _SlotState(TenantState):
    """TenantState-shaped registry entry whose mutable counters live in
    the controller's slot-aligned columns. Reads and writes go through
    to the arrays, so external mutation (tests, tooling) is seen by the
    vectorised round and vice versa. ``_detach`` freezes the values into
    the object when the tenant's slot is released (Procedure 3), so a
    held reference keeps reading its final state, not a reused slot.

    Subclassing keeps ``__dataclass_fields__``, so ``dataclasses.replace``
    /``asdict`` keep working — a replace() copy is constructed through
    this ``__init__`` (field-compatible signature) and comes out
    detached, holding the values read at copy time."""

    def __init__(self, spec: TenantSpec, ordinal: int, quota: Quota,
                 active: bool = True, age: int = 0, loyalty: int = 0,
                 scale_count: int = 0, reward_count: int = 0,
                 priority: float = 0.0, last_vr: float = 0.0, *,
                 cols: _StateCols | None = None, slot: int = -1):
        self.spec = spec
        self.ordinal = ordinal
        self.quota = quota
        self.last_vr = last_vr
        self._cols = cols
        self._slot = slot if cols is not None else -1
        # detached-value store; unused while a slot is attached (the
        # controller writes the live values into the columns at admit)
        self._det = [age, loyalty, scale_count, reward_count, priority,
                     active]

    # write-through counters: (column name, detached-store index, cast),
    # in _det order — _detach() snapshots them in this same order
    _COUNTERS = (("age", 0, int), ("loyalty", 1, int), ("scale", 2, int),
                 ("reward", 3, int), ("priority", 4, float),
                 ("active", 5, bool))

    def _detach(self) -> None:
        self._det = [self.age, self.loyalty, self.scale_count,
                     self.reward_count, self.priority, self.active]
        self._slot = -1

    def _counter_property(col: str, det_i: int, cast):  # noqa: N805
        def get(self):
            s = self._slot
            return (cast(getattr(self._cols, col)[s]) if s >= 0
                    else self._det[det_i])

        def set_(self, v):
            if self._slot >= 0:
                getattr(self._cols, col)[self._slot] = v
            else:
                self._det[det_i] = v

        return property(get, set_)

    age = _counter_property(*_COUNTERS[0])
    loyalty = _counter_property(*_COUNTERS[1])
    scale_count = _counter_property(*_COUNTERS[2])
    reward_count = _counter_property(*_COUNTERS[3])
    priority = _counter_property(*_COUNTERS[4])
    active = _counter_property(*_COUNTERS[5])
    del _counter_property


class DyverseController:
    def __init__(self, capacity: NodeCapacity,
                 uR: ResourceUnit = ResourceUnit(),
                 policy: str = "sdps",
                 weights: Weights = Weights(),
                 actuator: Actuator | None = None,
                 default_units: int = 4,
                 network_ok: Callable[[str], bool] | None = None,
                 normalize_factors: bool = False,
                 control_plane: str = "array",
                 scaling_policy: str = "reactive",
                 forecaster: str | Forecaster = "ewma",
                 forecast_window: int = 16,
                 hybrid_vr_band: float = 0.15,
                 recorder=None,
                 node_name: str = "node"):
        if policy not in POLICIES and policy != "none":
            raise ValueError(f"policy {policy!r} not in {POLICIES + ('none',)}")
        if control_plane not in CONTROL_PLANES:
            raise ValueError(
                f"control_plane {control_plane!r} not in {CONTROL_PLANES}")
        if scaling_policy not in SCALING_POLICIES:
            raise ValueError(
                f"scaling_policy {scaling_policy!r} not in {SCALING_POLICIES}")
        self.pool = ResourcePool(capacity, uR)
        self.control_plane = control_plane
        if control_plane == "array":
            self.monitor = Monitor()
            self._cols: _StateCols | None = _StateCols(self.monitor.slots)
            # the forecast history shares the Monitor's slot table: one
            # slot id indexes metrics, controller state AND history
            self._fc_slots: SlotTable | None = None
            fc_slots = self.monitor.slots
        else:
            self.monitor = DictMonitor()
            self._cols = None
            # the reference plane has no slot table; the history keeps
            # its own (acquire/release mirrors the registry exactly)
            self._fc_slots = SlotTable()
            fc_slots = self._fc_slots
        self.scaling_policy = scaling_policy
        self.hybrid_vr_band = hybrid_vr_band
        self.forecast = ForecastEngine(fc_slots, forecaster, forecast_window)
        self.policy = policy
        self.weights = weights
        self.actuator = actuator or NullActuator()
        self.default_units = default_units
        self.network_ok = network_ok or _network_always_ok
        self.normalize_factors = normalize_factors
        self.registry: dict[str, TenantState] = {}
        # Edge Manager's memory of tenants across launches (ageing/loyalty)
        self._history: dict[str, dict[str, int]] = {}
        self._next_ordinal = 1
        self.rounds_run = 0
        # per-round scratch for the presorted eviction cascade
        self._round_names: list[str] = []
        self._round_pri: list[float] = []
        self._round_vorder: list[int] = []
        self._round_vptr = 0
        # registry-order gather cache. Invalidated two ways: the
        # controller bumps _members_epoch on every admit/terminate
        # (slot reuse can hand the SAME name list a DIFFERENT slot map,
        # e.g. terminate a registry suffix and re-admit it in order —
        # LIFO reuse swaps the slots), and the names list is compared
        # every round as a backstop against direct registry mutation.
        self._members_epoch = 0
        # optional repro_torch.obs.FlightRecorder — observation only: emits
        # typed events and per-phase walls, draws no RNG, never feeds
        # back into a decision. None (the default) is the off path.
        self.recorder = recorder
        self.node_name = node_name
        self._phase_acc: dict[str, float] | None = None
        self._dense_key: tuple | None = None
        self._dense_names: list[str] = []
        self._dense_idx: np.ndarray | None = None
        self._dense_names_np: np.ndarray | None = None

    def _dense_index(self) -> tuple[list[str], np.ndarray]:
        """Registry-insertion-order tenant names + their slot ids."""
        names = list(self.registry)
        if (self._members_epoch, names) != self._dense_key:
            self._dense_key = (self._members_epoch, names)
            self._dense_names = names
            self._dense_idx = np.fromiter(
                (st._slot for st in self.registry.values()), np.intp,
                len(names))
            self._dense_names_np = None        # rebuilt lazily on demand
        return self._dense_names, self._dense_idx

    # ------------------------------------------------------------ admission
    def admit(self, spec: TenantSpec, units: int | None = None) -> AdmissionResult:
        """Edge Manager decision on hosting an offloaded server."""
        units = units or self.default_units
        if spec.max_units is not None:
            # never allocate more than the actuator can enforce (the
            # serving engine's compiled decode-batch cap): billed units
            # must equal enforced units or Eq. 1 utilisation drifts
            units = max(1, min(units, spec.max_units))
        hist = self._history.setdefault(spec.name, {"age": 0, "loyalty": 0})
        if spec.name in self.registry:
            return AdmissionResult(False, "already running")
        try:
            quota = self.pool.admit(spec.name, units)
        except PoolError:
            hist["age"] += 1  # Age_s: rejected by the node
            return AdmissionResult(False, "insufficient resources")
        if self._cols is not None:
            self.monitor.register(spec.name)        # acquires the slot
            slot = self.monitor.slots.index[spec.name]
            self.forecast.born(slot)                # fresh history column
            st: TenantState = _SlotState(spec, self._next_ordinal, quota,
                                         cols=self._cols, slot=slot)
            c = self._cols
            c.premium[slot] = spec.premium
            c.ordinal[slot] = self._next_ordinal
            c.age[slot] = hist["age"]
            c.loyalty[slot] = hist["loyalty"]
            c.scale[slot] = 0
            c.reward[slot] = 0
            c.pfp[slot] = spec.pricing == PricingModel.PFP
            c.priority[slot] = 0.0
            c.active[slot] = True
            c.slo[slot] = spec.slo_latency
            c.dthr_slo[slot] = spec.down_threshold * spec.slo_latency
            c.donation[slot] = spec.donation
            c.min_units[slot] = spec.min_units
            c.units[slot] = self.pool.units(spec.name)
        else:
            st = TenantState(spec=spec, ordinal=self._next_ordinal,
                             quota=quota, age=hist["age"],
                             loyalty=hist["loyalty"])
            self.monitor.register(spec.name)
            self.forecast.born(self._fc_slots.acquire(spec.name))
        self._next_ordinal += 1
        hist["loyalty"] += 1  # Loyalty_s: used the service
        self.registry[spec.name] = st
        self._members_epoch += 1
        self.actuator.apply_quota(spec.name, quota)
        return AdmissionResult(True)

    def prior_age(self, name: str) -> int:
        """Age_s the Edge Manager remembers for a (possibly departed)
        tenant — rejections and Procedure-3 terminations both count."""
        return self._history.get(name, {"age": 0})["age"]

    def remember_age(self, name: str, age: int) -> None:
        """Import a tenant's Age_s from another Edge Manager (federation
        re-placement), so a subsequent ``admit`` builds the TenantState
        with the carried-over ageing credit rather than starting at 0."""
        hist = self._history.setdefault(name, {"age": 0, "loyalty": 0})
        hist["age"] = max(hist["age"], age)

    def prior_loyalty(self, name: str) -> int:
        """Loyalty_s the Edge Manager remembers for a (possibly departed)
        tenant — every admission on this node counted as one use of the
        service (§3.2)."""
        return self._history.get(name, {"loyalty": 0})["loyalty"]

    def remember_loyalty(self, name: str, loyalty: int) -> None:
        """Import a tenant's Loyalty_s from another Edge Manager: a
        Procedure-3 refugee re-placed on a sibling keeps the SPS loyalty
        factor its prior tenancy earned instead of restarting at 0."""
        hist = self._history.setdefault(name, {"age": 0, "loyalty": 0})
        hist["loyalty"] = max(hist["loyalty"], loyalty)

    # ------------------------------------------------------------ procedures
    def update_priorities(self) -> float:
        """Procedure 1, line 1. Returns wall-clock overhead (seconds).

        Scores all tenants in one vectorised pass — ``batch_scores_np``
        is bitwise-identical to the scalar ``priority_score``, so both
        control planes produce the same priorities to the last ULP
        (pinned by the priority regression tests). The array path feeds
        the scorer gathered slot columns directly (no per-tenant list
        building) and the scores land straight in the priority column."""
        t0 = time.perf_counter()
        policy = self.policy if self.policy != "none" else "sps"
        if self.registry:
            scorer = (batch_scores_normalized if self.normalize_factors
                      else batch_scores_np)
            if self._cols is not None:
                c = self._cols
                _, idx = self._dense_index()
                prev = self.monitor._prev
                c.priority[idx] = scorer(
                    policy, c.premium[idx], c.ordinal[idx], c.age[idx],
                    c.loyalty[idx], prev.requests[idx], prev.users[idx],
                    prev.data_mb[idx], c.reward[idx], c.scale[idx],
                    c.pfp[idx], self.weights)
            else:
                names = list(self.registry)
                sts = [self.registry[n] for n in names]
                ms = [self.monitor.prev(n) for n in names]
                scores = scorer(
                    policy,
                    [s.spec.premium for s in sts], [s.ordinal for s in sts],
                    [s.age for s in sts], [s.loyalty for s in sts],
                    [m.requests for m in ms], [m.users for m in ms],
                    [m.data_mb for m in ms], [s.reward_count for s in sts],
                    [s.scale_count for s in sts],
                    [s.spec.pricing == PricingModel.PFP for s in sts],
                    self.weights)
                for st, sc in zip(sts, scores):
                    st.priority = float(sc)
        return time.perf_counter() - t0

    def run_round(self) -> RoundReport:
        """Procedure 1: one dynamic vertical scaling round, O(N)."""
        report = RoundReport(policy=self.policy)
        # per-phase profiling (classification / eviction cascade /
        # actuation) only exists while a flight recorder observes the
        # run; the sub-timers read perf_counter around code that runs
        # identically either way, so decisions are unperturbed
        acc = self._phase_acc = (
            {"classification": 0.0, "eviction": 0.0, "actuation": 0.0}
            if self.recorder is not None else None)
        metrics = self.monitor.roll_round()
        # the closed round joins the forecast history on EVERY policy —
        # recording is deterministic numpy on Monitor-held values (no
        # RNG, no actions), so the reactive path stays bitwise-identical
        # to the pre-forecast controller (neutrality pins). Its cost is
        # accounted as forecast overhead (prediction time joins it in
        # the proactive/hybrid round).
        t0 = time.perf_counter()
        self._record_history()
        report.forecast_s = time.perf_counter() - t0
        if self.policy == "none":  # no dynamic vertical scaling (baseline)
            if acc is not None:
                self._attach_phases(report, acc)
            return report
        report.priority_update_s = self.update_priorities()

        t0 = time.perf_counter()
        if self.scaling_policy != "reactive":
            self._scaling_round_forecast(metrics, report)
        elif self._cols is not None:
            self._scaling_round_array(report)
        else:
            self._scaling_round_reference(metrics, report)
        report.scaling_s = time.perf_counter() - t0
        self.rounds_run += 1
        self.pool.check_invariants()
        if acc is not None:
            self._attach_phases(report, acc)
        return report

    def _attach_phases(self, report: RoundReport, acc: dict) -> None:
        """Flush the round's per-phase walls into the report (tracing
        on only). ``monitor_feed`` is appended by the layer that owns
        the chunk loop (node / fleet stepper)."""
        report.phases = {
            "forecast": report.forecast_s,
            "priority": report.priority_update_s,
            "classification": acc["classification"],
            "eviction": acc["eviction"],
            "actuation": acc["actuation"],
            "scaling": report.scaling_s,
        }
        self._phase_acc = None

    def _emit(self, kind: str, name: str | None, st, **kw) -> None:
        """Emit one flight-recorder event stamped with this round/node
        (call sites guard on ``self.recorder is not None``)."""
        self.recorder.emit(
            kind, round=self.rounds_run, node=self.node_name,
            tenant=name, slot=getattr(st, "_slot", -1), **kw)

    # ---- forecast history + proactive/hybrid scaling --------------------
    def _record_history(self) -> None:
        """Append the just-closed round (requests, VR_s, aL_s, allocated
        uR) to the forecast ring. Both planes record the identical
        float64 divisions the RoundMetrics properties perform, so their
        histories — and therefore their forecasts — match bitwise."""
        fc = self.forecast
        if self._cols is not None:
            prev = self.monitor.prev_columns()
            req = prev.requests.astype(np.float64)
            has = prev.requests > 0
            vr = np.zeros(req.size)
            np.divide(prev.violations.astype(np.float64), req, out=vr,
                      where=has)
            aL = np.zeros(req.size)
            np.divide(prev.lat_sum, req, out=aL, where=has)
            fc.observe(req, vr, aL, self._cols.units.astype(np.float64))
        else:
            cap = self._fc_slots.capacity
            req = np.zeros(cap)
            vr = np.zeros(cap)
            aL = np.zeros(cap)
            units = np.zeros(cap)
            index = self._fc_slots.index
            for name in self.registry:
                i = index[name]
                m = self.monitor.prev(name)
                req[i] = m.requests
                vr[i] = m.violation_rate
                aL[i] = m.avg_latency
                units[i] = self.pool.units(name)
            fc.observe(req, vr, aL, units)

    def _history_index(self, names: list[str]) -> np.ndarray:
        """Slot ids of the registry tenants in the forecast history."""
        if self._fc_slots is not None:
            index = self._fc_slots.index
            return np.fromiter((index[n] for n in names), np.intp,
                               len(names))
        return np.fromiter((st._slot for st in self.registry.values()),
                           np.intp, len(names))

    def _scaling_round_forecast(self, metrics, report: RoundReport) -> None:
        """Procedure 1 under ``scaling_policy="proactive"|"hybrid"``:
        one shared implementation for both control planes (identical
        forecasts + identical walk → identical action streams).

        ``proactive`` classifies each tenant from BOTH its realised
        metrics and its FORECAST next-round metrics (aL̂_s vs the SLO)
        and acts on whichever is more urgent:

        * realised violation → the paper's Procedure 2 unchanged
          (eviction cascade included), sized aR_s = R_s · max(VR_s,
          VR̂_s) — a forecast can add urgency to a real violation but
          never discount it;
        * violation only PREDICTED → pre-scale before it lands, sized
          aR_s = R_s · VR̂_s, drawing from free units only — never
          evictions. That is the headroom cap keeping total allocation
          inside the same budget reactive scaling works with: a wrong
          forecast can cost spare headroom, never another tenant's
          session;
        * a predicted violation (or predicted hold band) also vetoes the
          scale-down a purely reactive round would take, so units are
          not drained right before a forecast burst.

        With the ``last_value`` forecaster the predicted metrics equal
        the realised ones and every decision collapses to the reactive
        classification — the baseline the better forecasters improve on.

        ``hybrid`` falls back to the PURE reactive branch for any tenant
        whose smoothed forecast error exceeds ``hybrid_vr_band``, and
        everywhere while the history is still empty."""
        reg = self.registry
        if not reg:
            return
        fc = self.forecast
        names = list(reg)
        n = len(names)
        t0 = time.perf_counter()
        idx = self._history_index(names)
        # depth ≥ 1 always: run_round records the closed round before
        # scaling, so even the first round predicts from a one-round
        # window (every forecaster degenerates to ~last_value there)
        frame = fc.predict(idx)
        if self.scaling_policy == "hybrid":
            fallback = fc.err_vr[idx] > self.hybrid_vr_band
            if fc.scored_rounds < 1:
                fallback[:] = True   # no prediction scored → no error signal
        else:
            fallback = np.zeros(n, bool)
        report.forecast_s += time.perf_counter() - t0
        acc = self._phase_acc
        if acc is not None:
            _c0 = time.perf_counter()
        pos = {name: j for j, name in enumerate(names)}
        fall_l = fallback.tolist()
        req_hat = frame.requests.tolist()
        vr_hat = frame.vr.tolist()
        aL_hat = frame.avg_latency.tolist()
        order = sorted(reg, key=lambda nm: reg[nm].priority, reverse=True)
        if acc is not None:
            acc["classification"] += time.perf_counter() - _c0
        for name in order:
            if name not in reg:                 # evicted earlier this round
                continue
            st = reg[name]
            if not st.active or not self.network_ok(name):
                self._terminate(name, report, reason="network/inactive")
                continue
            j = pos[name]
            L = st.spec.slo_latency
            if fall_l[j]:
                m = metrics.get(name)
                if m is None:
                    continue
                aL = m.avg_latency
                if m.requests and aL > L:
                    st.last_vr = m.violation_rate
                    self._scale_up(name, st, m.violation_rate, report)
                elif m.requests and aL > st.spec.down_threshold * L:
                    if st.spec.donation:
                        self._scale_down(name, st, report, donated=True)
                    else:
                        report.actions.append(RoundAction(
                            name, Decision.NONE, priority=st.priority))
                else:
                    self._scale_down(name, st, report, donated=False)
            else:
                m = metrics.get(name)
                dthr = st.spec.down_threshold * L
                r_up = bool(m is not None and m.requests
                            and m.avg_latency > L)
                r_band = bool(m is not None and m.requests and not r_up
                              and m.avg_latency > dthr)
                expects = req_hat[j] > 0.5      # forecast sees traffic
                f_up = expects and aL_hat[j] > L
                f_band = expects and not f_up and aL_hat[j] > dthr
                if r_up or f_up:
                    vr = max(m.violation_rate if r_up else 0.0,
                             vr_hat[j] if f_up else 0.0)
                    st.last_vr = vr
                    self._scale_up(name, st, vr, report, evict=r_up)
                elif r_band or f_band:
                    if st.spec.donation:
                        self._scale_down(name, st, report, donated=True)
                    else:
                        report.actions.append(RoundAction(
                            name, Decision.NONE, priority=st.priority))
                else:
                    self._scale_down(name, st, report, donated=False)

    def _sync_units_col(self, name: str, st: TenantState) -> None:
        """Array plane: keep the slot-aligned units column exact after a
        pool mutation made outside the vectorised round (the batched
        engine's FleetStepper reads it for the latency model). No-op on
        the reference plane, and never reached from the array plane's
        own reactive round (which maintains the column inline)."""
        if self._cols is not None:
            self._cols.units[st._slot] = self.pool.units(name)

    # ---- array control plane -------------------------------------------
    def _scaling_round_array(self, report: RoundReport) -> None:
        """Vectorised Procedure 1: the scale-up / donation-band /
        scale-down / floor classification is computed for all tenants at
        once from the previous-round columns; only the priority-ordered
        walk (whose pool mutations are order-dependent) and Procedure 2's
        eviction cascade remain loops."""
        reg = self.registry
        if not reg:
            return
        acc = self._phase_acc
        if acc is not None:
            _c0 = time.perf_counter()
        names, idx = self._dense_index()
        n = len(names)
        c = self._cols
        prev = self.monitor._prev
        req = prev.requests[idx]
        has = req > 0
        pri = c.priority[idx]
        # decision classes: 1 scale-up, 2 donated scale-down, 3 NONE,
        # 4 plain scale-down; floor-blocked scale-downs collapse to NONE
        # (a tenant's own units cannot change before its turn, so the
        # round-start floor check is exact)
        cls = np.full(n, 4, np.int8)
        vr = None
        ups_any = False
        if has.any():
            reqf = req.astype(np.float64)
            # aL_s and VR_s, elementwise — the identical float64 divisions
            # the RoundMetrics properties perform per tenant
            aL = np.zeros(n, np.float64)
            np.divide(prev.lat_sum[idx], reqf, out=aL, where=has)
            vr = np.zeros(n, np.float64)
            np.divide(prev.violations[idx].astype(np.float64), reqf,
                      out=vr, where=has)
            up = has & (aL > c.slo[idx])
            band = has & ~up & (aL > c.dthr_slo[idx])
            cls[up] = 1
            cls[band] = np.where(c.donation[idx][band], 2, 3)
            ups_any = bool(up.any())
        # (an idle round — no requests anywhere — takes the plain
        # scale-down branch fleet-wide, as the scalar loop does)
        at_floor = c.units[idx] <= c.min_units[idx]
        cls[at_floor & ((cls == 2) | (cls == 4))] = 3

        # processing order: stable descending priority (ties keep registry
        # insertion order, as sorted(reverse=True) does)
        order_l = np.argsort(-pri, kind="stable").tolist()
        pri_l = pri.tolist()
        if acc is not None:
            acc["classification"] += time.perf_counter() - _c0
        # probed per round, not cached: network_ok is a public attribute
        # and may be (re)assigned after construction
        check_net = self.network_ok is not _network_always_ok
        append = report.actions.append
        if not ups_any and not check_net and bool(c.active[idx].all()):
            # no scale-up and nothing terminable → membership is stable
            # for the whole round; the walk is a straight dispatch
            hold = Decision.NONE
            if not np.any(cls != 3):
                # steady state: every tenant holds — bulk-build the NONE
                # actions in priority order
                report.actions.extend(
                    [RoundAction(names[k], hold, 0, pri_l[k])
                     for k in order_l])
                return
            cls_l = cls.tolist()
            sts = list(reg.values())
            units_l = c.units[idx].tolist()
            for k in order_l:
                st = sts[k]
                if not st.active:
                    # an actuator callback flipped the flag mid-round —
                    # the reference loop reads it at each turn, so must we
                    self._terminate(names[k], report,
                                    reason="network/inactive")
                elif cls_l[k] == 3:
                    append(RoundAction(names[k], hold, 0, pri_l[k]))
                else:
                    self._scale_down_fast(names[k], st, report,
                                          donated=cls_l[k] == 2,
                                          priority=pri_l[k],
                                          units=units_l[k])
            return
        # general path: evictions possible — victims come presorted by
        # ascending (priority, name), as min() over tuples picks
        cls_l = cls.tolist()
        sts = list(reg.values())
        units_l = c.units[idx].tolist()   # round-start units: a tenant's
        #                                   own units cannot change before
        #                                   its turn, so these stay exact
        if self._dense_names_np is None:
            self._dense_names_np = np.array(names)
        self._round_names = names
        self._round_pri = pri_l
        self._round_vorder = np.lexsort((self._dense_names_np, pri)).tolist()
        self._round_vptr = 0
        vr_l = vr.tolist() if vr is not None else [0.0] * n
        for k in order_l:
            name = names[k]
            if name not in reg:                 # evicted earlier this round
                continue
            st = sts[k]
            # active is read live at each turn (not from a round-start
            # snapshot): callbacks may flip it mid-round, and the
            # reference loop would see that
            if not st.active or (check_net and not self.network_ok(name)):
                self._terminate(name, report, reason="network/inactive")
                continue
            kls = cls_l[k]
            if kls == 3:
                append(RoundAction(name, Decision.NONE, priority=pri_l[k]))
            elif kls == 1:
                st.last_vr = vr_l[k]
                self._scale_up_presorted(k, name, st, vr_l[k], units_l[k],
                                         report)
            else:
                self._scale_down_fast(name, st, report, donated=kls == 2,
                                      priority=pri_l[k], units=units_l[k])

    def _next_victim(self, exclude_k: int) -> int | None:
        """Lowest-(priority, name) live tenant this round, excluding the
        scaler itself. The cursor advances permanently past terminated
        entries, so a whole round's eviction cascade costs O(N) total
        instead of O(N) per eviction."""
        vorder, names = self._round_vorder, self._round_names
        reg = self.registry
        p = self._round_vptr
        nv = len(vorder)
        while p < nv and names[vorder[p]] not in reg:
            p += 1
        self._round_vptr = p
        if p >= nv:
            return None
        j = vorder[p]
        if j != exclude_k:
            return j
        q = p + 1                   # peek past the excluded scaler only
        while q < nv and names[vorder[q]] not in reg:
            q += 1
        return vorder[q] if q < nv else None

    def _scale_up_presorted(self, k: int, name: str, st: TenantState,
                            vr: float, r_units: int,
                            report: RoundReport) -> None:
        """Procedure 2, scaleup branch: aR_s = R_s · VR_s (≥1 unit), with
        victims drawn from the round's presorted priority order."""
        want = max(1, round(r_units * vr))
        if st.spec.max_units is not None:
            # actuator ceiling: grant only what can be enforced, so the
            # pool never bills quota the scheduler would clamp away
            want = min(want, st.spec.max_units - r_units)
        if want <= 0:
            report.actions.append(RoundAction(name, Decision.SCALE_UP, 0,
                                              self._round_pri[k]))
            return
        freed_for: str | None = None
        my_pri = self._round_pri[k]
        acc = self._phase_acc
        if acc is not None:
            _e0 = time.perf_counter()
        while self.pool.free_units < want:
            j = self._next_victim(k)
            # paper Procedure 2 line 10: stop at "index of s" — only tenants
            # with strictly lower priority may be evicted
            if j is None or self._round_pri[j] >= my_pri:
                break
            victim = self._round_names[j]
            self._terminate(victim, report, reason=f"evicted for {name}")
            freed_for = victim
        if acc is not None:
            acc["eviction"] += time.perf_counter() - _e0
        grant = min(want, self.pool.free_units)
        if grant > 0:
            st.quota = self.pool.grow(name, grant)
            cols, slot = self._cols, st._slot
            cols.scale[slot] += 1            # Scale_s penalty accounting
            cols.units[slot] = r_units + grant
            if acc is None:
                self.actuator.apply_quota(name, st.quota)
            else:
                _a0 = time.perf_counter()
                self.actuator.apply_quota(name, st.quota)
                acc["actuation"] += time.perf_counter() - _a0
        if self.recorder is not None:
            self._emit("scale_up", name, st, cause="reactive",
                       want=want, granted=grant, freed_for=freed_for)
        report.actions.append(RoundAction(name, Decision.SCALE_UP, grant,
                                          my_pri, terminated_for=freed_for))

    def _scale_down_fast(self, name: str, st: TenantState,
                         report: RoundReport, *, donated: bool,
                         priority: float, units: int) -> None:
        """Procedure 2, scaledown branch (array path): the floor check
        already ran vectorised, so this always removes one uR."""
        st.quota = self.pool.shrink(name, 1)
        cols, slot = self._cols, st._slot
        if donated:
            cols.reward[slot] += 1           # Reward_s credit; donation scaling is NOT penalised
        else:
            cols.scale[slot] += 1            # Scale_s penalty accounting
        cols.units[slot] = units - 1
        acc = self._phase_acc
        if acc is None:
            self.actuator.apply_quota(name, st.quota)
        else:
            _a0 = time.perf_counter()
            self.actuator.apply_quota(name, st.quota)
            acc["actuation"] += time.perf_counter() - _a0
        if self.recorder is not None:
            self._emit("donation" if donated else "scale_down", name, st,
                       units=1)
        report.actions.append(RoundAction(name, Decision.SCALE_DOWN, 1,
                                          priority))

    # ---- reference control plane ----------------------------------------
    def _scaling_round_reference(self, metrics, report: RoundReport) -> None:
        """The original per-tenant dict/dataclass loop, retained verbatim
        as the bitwise reference for the array path."""
        acc = self._phase_acc
        if acc is not None:
            _c0 = time.perf_counter()
        order = sorted(self.registry, key=lambda n: self.registry[n].priority,
                       reverse=True)
        if acc is not None:
            # the reference loop interleaves per-tenant classification
            # with actuation; the classification timer covers the
            # priority-order sort (the array plane's analogue)
            acc["classification"] += time.perf_counter() - _c0
        for name in order:
            if name not in self.registry:       # evicted earlier this round
                continue
            st = self.registry[name]
            m = metrics.get(name)
            if m is None:
                continue
            if not st.active or not self.network_ok(name):
                self._terminate(name, report, reason="network/inactive")
                continue
            L = st.spec.slo_latency
            aL = m.avg_latency
            if m.requests and aL > L:
                st.last_vr = m.violation_rate
                self._scale_up(name, st, m.violation_rate, report)
            elif m.requests and aL > st.spec.down_threshold * L:
                if st.spec.donation:
                    self._scale_down(name, st, report, donated=True)
                else:
                    report.actions.append(RoundAction(name, Decision.NONE,
                                                      priority=st.priority))
            else:
                self._scale_down(name, st, report, donated=False)

    def _scale_up(self, name: str, st: TenantState, vr: float,
                  report: RoundReport, *, evict: bool = True) -> None:
        """Procedure 2, scaleup branch: aR_s = R_s · VR_s (≥1 unit).
        Shared by the reference reactive round and the forecast round —
        ``evict=False`` is the proactive headroom cap: a scale-up
        justified only by a forecast grants from free units and never
        starts the eviction cascade."""
        r_units = self.pool.units(name)
        want = max(1, round(r_units * vr))
        if st.spec.max_units is not None:
            # actuator ceiling (see _scale_up_presorted)
            want = min(want, st.spec.max_units - r_units)
        if want <= 0:
            report.actions.append(RoundAction(name, Decision.SCALE_UP, 0,
                                              st.priority))
            return
        freed_for: str | None = None
        acc = self._phase_acc
        if acc is not None:
            _e0 = time.perf_counter()
        while evict and self.pool.free_units < want:
            victim = self._lowest_priority_victim(exclude=name)
            # paper Procedure 2 line 10: stop at "index of s" — only tenants
            # with strictly lower priority may be evicted
            if victim is None or \
                    self.registry[victim].priority >= st.priority:
                break
            self._terminate(victim, report, reason=f"evicted for {name}")
            freed_for = victim
        if acc is not None:
            acc["eviction"] += time.perf_counter() - _e0
        grant = min(want, self.pool.free_units)
        if grant > 0:
            self.pool.grow(name, grant)
            st.quota = self.pool.quota(name)
            st.scale_count += 1              # Scale_s penalty accounting
            self._sync_units_col(name, st)
            if acc is None:
                self.actuator.apply_quota(name, st.quota)
            else:
                _a0 = time.perf_counter()
                self.actuator.apply_quota(name, st.quota)
                acc["actuation"] += time.perf_counter() - _a0
        if self.recorder is not None:
            self._emit("scale_up", name, st,
                       cause="reactive" if evict else "proactive",
                       want=want, granted=grant, freed_for=freed_for)
        report.actions.append(RoundAction(name, Decision.SCALE_UP, grant,
                                          st.priority, terminated_for=freed_for))

    def _scale_down(self, name: str, st: TenantState, report: RoundReport,
                    *, donated: bool) -> None:
        """Procedure 2, scaledown branch: remove one uR (never below
        floor). Shared by the reference reactive round and the forecast
        round."""
        if self.pool.units(name) <= st.spec.min_units:
            report.actions.append(RoundAction(name, Decision.NONE,
                                              priority=st.priority))
            return
        self.pool.shrink(name, 1)
        st.quota = self.pool.quota(name)
        if donated:
            st.reward_count += 1             # Reward_s credit; donation scaling is NOT penalised
        else:
            st.scale_count += 1              # Scale_s penalty accounting
        self._sync_units_col(name, st)
        acc = self._phase_acc
        if acc is None:
            self.actuator.apply_quota(name, st.quota)
        else:
            _a0 = time.perf_counter()
            self.actuator.apply_quota(name, st.quota)
            acc["actuation"] += time.perf_counter() - _a0
        if self.recorder is not None:
            self._emit("donation" if donated else "scale_down", name, st,
                       units=1)
        report.actions.append(RoundAction(name, Decision.SCALE_DOWN, 1,
                                          st.priority))

    def _lowest_priority_victim(self, exclude: str) -> str | None:
        cands = [(st.priority, n) for n, st in self.registry.items()
                 if n != exclude]
        if not cands:
            return None
        return min(cands)[1]

    def _terminate(self, name: str, report: RoundReport, reason: str) -> None:
        """Procedure 3: migrate users/state to the Cloud, destroy tenant."""
        acc = self._phase_acc
        if acc is None:
            self.actuator.terminate(name)    # engine flushes KV, redirects users
        else:
            _a0 = time.perf_counter()
            self.actuator.terminate(name)
            acc["actuation"] += time.perf_counter() - _a0
        if self.recorder is not None:
            self._emit("terminate", name, self.registry.get(name),
                       cause=reason)
        self.pool.release(name)
        st = self.registry.pop(name, None)
        self._members_epoch += 1
        if isinstance(st, _SlotState):
            st._detach()                     # before the slot is freed
        self.monitor.forget(name)
        self._release_history_slot(name)
        hist = self._history.setdefault(name, {"age": 0, "loyalty": 0})
        hist["age"] += 1                     # future re-admission gets priority
        report.terminated.append(name)
        report.actions.append(RoundAction(name, Decision.TERMINATE))

    def resize_capacity(self, units: int) -> list[str]:
        """Fault-injection hook (NodeDegradation): resize the node to
        ``units`` uR and, if the surviving capacity no longer covers the
        allocated quotas, run a Procedure-3 contraction cascade —
        terminate lowest-(priority, name) tenants until FR is
        non-negative again. Mirrors Procedure 2's eviction order, so it
        is deterministic and identical on both control planes (priority
        columns and registry priorities are pinned bitwise). Returns the
        terminated tenant names so a federation can re-place them as
        refugees."""
        q = Quota(0, 0).add_units(units, self.pool.uR)
        self.pool.resize(NodeCapacity(slots=q.slots, pages=q.pages))
        report = RoundReport(policy=self.policy)
        while True:
            f = self.pool.free
            if f.slots >= 0 and f.pages >= 0:
                break
            victim = self._lowest_priority_victim(exclude="")
            if victim is None:       # nothing left to evict
                break
            self._terminate(victim, report, reason="capacity degradation")
        self.pool.check_invariants()
        return report.terminated

    def release_tenant(self, name: str) -> TenantState:
        """Federation hook: detach a tenant WITHOUT Procedure 3's penalty
        accounting — used when the hosting *node* disappears (fault
        injection, node failure mid-session) rather than the tenant being
        evicted for cause. Frees the quota and the monitor slot (the
        cumulative Eq. 1 totals are kept — requests already served still
        count), but does not bump the tenant's Age_s and does not invoke
        the actuator's terminate path (there is no node left to migrate
        state from). Returns the final TenantState so the federation can
        carry the spec and counters to the tenant's next home."""
        st = self.registry.pop(name, None)
        if st is None:
            raise KeyError(f"tenant {name!r} not hosted here")
        self.pool.release(name)
        self._members_epoch += 1
        if isinstance(st, _SlotState):
            st._detach()                 # before the slot is freed
        self.monitor.forget(name)
        self._release_history_slot(name)
        return st

    def _release_history_slot(self, name: str) -> None:
        """Reference plane only: the forecast history keeps its own slot
        table, released in lockstep with the registry (the array plane
        shares the Monitor's table — ``forecast.born`` at the slot's
        next acquire re-initialises it there)."""
        if self._fc_slots is not None:
            slot = self._fc_slots.release(name)
            if slot is not None:
                self.forecast.born(slot)     # reused slots start clean

    # ------------------------------------------------------------ views
    @property
    def node_violation_rate(self) -> float:
        return self.monitor.node_violation_rate

    def can_admit(self, units: int | None = None) -> bool:
        """Would a new tenant at ``units`` (default quota) fit?"""
        return self.pool.can_admit(
            self.default_units if units is None else units)

    @property
    def capacity_units(self) -> int:
        """Node capacity measured in uR units."""
        cap = self.pool.capacity
        return Quota(cap.slots, cap.pages).units(self.pool.uR)

    @property
    def load_fraction(self) -> float:
        """Allocated fraction of node capacity, in uR units."""
        total = self.capacity_units
        return self.pool.used_units / total if total else 1.0

    def load_fraction_after(self, units: int | None = None) -> float:
        """Projected load fraction after admitting ``units`` (default
        quota) — the federation placement tier's least-loaded metric:
        on heterogeneous nodes it steers tenants to the node that ends
        up least utilised, which plain current-load cannot distinguish
        while nodes are empty."""
        total = self.capacity_units
        used = self.pool.used_units + (
            self.default_units if units is None else units)
        return used / total if total else 1.0

    def snapshot(self) -> dict[str, dict]:
        return {n: {"units": self.pool.units(n), "priority": st.priority,
                    "scale_count": st.scale_count, "reward": st.reward_count}
                for n, st in self.registry.items()}
