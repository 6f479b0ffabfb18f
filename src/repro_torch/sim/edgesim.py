"""Edge-node simulator driving the REAL DyverseController (paper §5).

Time advances in round-interval chunks. Every ``round_interval`` seconds
the controller runs Procedure 1 (exactly the code in repro_torch.core). The
simulator's actuator maps quota units onto the workload latency model;
terminated tenants are serviced "from the Cloud" with WAN latency added —
requests keep flowing, as in the paper (users are redirected, not
dropped).

Four execution engines (see :mod:`repro_torch.sim.engines` for the backend
registry they dispatch through):

* ``scalar`` — the reference per-second, per-tenant Python loop;
* ``vectorized`` (default) — batched NumPy over whole chunks, one pass
  of array calls per tenant per round-interval chunk;
* ``batched`` — fleet-batched: a whole node's chunk is computed as one
  (tenants × seconds) matrix via :class:`~repro_torch.sim.workload.FleetBatch`
  (and a federation's chunk as one stacked (nodes·tenants × seconds)
  step, see :class:`FleetStepper`), collapsing the per-tenant Python
  loops to a handful of NumPy calls per chunk;
* ``torch`` — mega-scale fleets: the fleet's draws, latencies and
  reductions run as hand-written GPU kernels with counter-based RNG
  streams (:mod:`repro_torch.sim.engines.torch_backend` — statistically,
  not bitwise, equivalent to the trio below).

The first three engines draw the identical random trace per chunk
(per-tenant arrival counts + jitter, from per-tenant RNG substreams —
the batched engine never merges draws across tenants, it only batches
the deterministic math between them) and evaluate the identical
floating-point expressions element for element, so their violation
rates, per-minute timelines, and termination lists are bitwise
identical — only wall-clock differs.

Orthogonally, ``SimConfig.control_plane`` selects the controller
implementation: ``"array"`` (default, struct-of-arrays Monitor +
vectorised rounds) or ``"reference"`` (the retained dict/dataclass
path) — also bitwise-identical, pinned by tests/test_control_plane.py.

Reproduces: Fig. 3 (violation-rate timeline), Figs. 4/5 (violation rate
vs #tenants × SLO), Figs. 6/7 (latency distributions), and the overhead
measurements of Fig. 2 (controller wall-clock per round).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import (DyverseController, NodeCapacity, PricingModel,
                              Quota, ResourceUnit, TenantSpec)
from repro_torch.sim.engines import (resolve_engine,  # noqa: F401  (re-export)
                               sim_engines, tenant_stream)
from repro_torch.sim.workload import FleetBatch, Workload

WAN_EXTRA_LATENCY = 0.12     # s: Cloud round-trip penalty after eviction
WAN_BW_MBPS = 20.0           # migration bandwidth Edge→Cloud
CLOUD_UNITS = 10 ** 6        # effectively unconstrained Cloud capacity

# the node-capable engines registered at import time (compat constant;
# the live list is repro_torch.sim.engines.sim_engines())
ENGINES = sim_engines()


@dataclass
class SimConfig:
    duration_s: int = 1200            # paper: 20-minute session
    round_interval: int = 300         # scaling at the 5th/10th/15th minute
    capacity_units: int = 520         # node capacity (in uR)
    default_units: int = 16
    policy: str = "sdps"              # "none"|"sps"|"wdps"|"cdps"|"sdps"
    slo_scale: float = 1.0            # SLO = slo_scale × base latency
    donation_fraction: float = 0.3    # tenants willing to donate
    pricing: PricingModel = PricingModel.HYBRID
    normalize_factors: bool = False  # beyond-paper mode (see core.priority)
    engine: str = "vectorized"        # any node-capable engine in ENGINES
    jit_scale: bool = False           # DEPRECATED — alias for
    #                                   backend_options={"jit_scale": True}
    #                                   (shimmed in __post_init__, warns once)
    control_plane: str = "array"      # "array" | "reference" controller path
    rng_workers: int = 2              # batched engine: jitter-draw pool size
    # engine-specific knobs, interpreted by the resolved backend:
    # batched: {"jit_scale": bool | device};
    # torch: {"device": str, "scale_kernel": bool}
    backend_options: dict = field(default_factory=dict)
    # ScalingPolicy seam (repro_torch.core.forecast): "reactive" keeps the
    # paper's Procedure-2 path bitwise-identical; "proactive" scales on
    # the forecast before violations land; "hybrid" falls back to
    # reactive wherever the forecast error exceeds hybrid_vr_band
    scaling_policy: str = "reactive"  # "reactive" | "proactive" | "hybrid"
    forecaster: str = "ewma"          # FORECASTERS name (or instance)
    forecast_window: int = 16         # RoundHistory ring depth (rounds)
    hybrid_vr_band: float = 0.15      # smoothed |VR̂−VR| reactive-fallback band
    # this node's Cloud link: Cloud-serviced requests pay this round-trip
    # (per-node WAN heterogeneity — TopologySpec threads it through here)
    wan_extra_latency: float = WAN_EXTRA_LATENCY
    unit_price: float = 1.0           # per-uR price (price-aware placement)
    seed: int = 0
    # optional repro_torch.obs.FlightRecorder shared by node + controller +
    # engine. None (default) = tracing off: the hot paths reduce to one
    # ``is None`` predicate and the run is bitwise-identical either way
    recorder: object | None = None

    def __post_init__(self):
        if self.jit_scale:
            if not _JIT_SCALE_WARNED:
                import warnings

                warnings.warn(
                    "SimConfig.jit_scale is deprecated; pass "
                    "backend_options={'jit_scale': True} instead",
                    DeprecationWarning, stacklevel=3)
                _JIT_SCALE_WARNED.append(True)
            if "jit_scale" not in self.backend_options:
                self.backend_options = {**self.backend_options,
                                        "jit_scale": True}


_JIT_SCALE_WARNED: list = []


@dataclass
class SimResult:
    policy: str
    violation_rate: float                       # Eq. 1 over whole run
    per_minute_vr: list[float] = field(default_factory=list)
    # all request latencies + the matching SLO per request; empty until
    # finalize() fills them (so band_fractions is safe to call any time)
    latencies: np.ndarray = field(default_factory=lambda: np.empty(0))
    slos: np.ndarray = field(default_factory=lambda: np.empty(0))
    overhead_priority_s: list[float] = field(default_factory=list)
    overhead_scaling_s: list[float] = field(default_factory=list)
    # forecast-prediction wall per round (zero under reactive scaling)
    overhead_forecast_s: list[float] = field(default_factory=list)
    terminated: list[str] = field(default_factory=list)
    # per-round Procedure-1 action streams (RoundReport.actions), in round
    # order — the scenario/placement equivalence tests pin these bitwise
    round_actions: list[list] = field(default_factory=list)
    migration_s: list[float] = field(default_factory=list)
    total_requests: int = 0                     # Edge-serviced (Eq. 1 basis)
    total_violations: int = 0
    # tracing-on extras (empty when the run had no FlightRecorder):
    # phase name → per-round walls for the full round pipeline
    # (monitor_feed / forecast / priority / classification / eviction /
    # actuation / scaling), and the node's flight-recorder events
    overhead_phases: dict[str, list[float]] = field(default_factory=dict)
    events: list = field(default_factory=list)

    @property
    def mean_overhead_per_server_s(self) -> float:
        """Mean per-round management overhead (the paper's Fig. 2
        per-server claim). The divisor is the number of rounds actually
        recorded across all three overhead lists — they can differ in
        length on early-terminated/partial runs, and dividing the
        three-list total by only ``len(priority)`` inflated the mean."""
        tot = (sum(self.overhead_priority_s) + sum(self.overhead_scaling_s)
               + sum(self.overhead_forecast_s))
        n = max(len(self.overhead_priority_s),
                len(self.overhead_scaling_s),
                len(self.overhead_forecast_s), 1)
        return tot / n

    def band_fractions(self, lo: float, hi: float) -> float:
        """Fraction of requests with latency in [lo·SLO, hi·SLO)."""
        lat, slo = self.latencies, self.slos
        sel = (lat >= lo * slo) & (lat < hi * slo)
        return float(sel.mean()) if lat.size else 0.0

    # -------------------------------------------------- obs exporters
    def write_events_jsonl(self, path: str) -> str:
        """Dump this node's flight-recorder events as JSONL (tracing-on
        runs only; off runs write an empty file)."""
        from repro_torch.obs import write_events_jsonl
        return write_events_jsonl(path, self.events)

    def write_trace(self, path: str) -> str:
        """Write a Chrome-trace/Perfetto ``trace.json`` of this run
        (open at https://ui.perfetto.dev)."""
        from repro_torch.obs import write_chrome_trace
        return write_chrome_trace(path, {self.policy: self.events})


class _SimActuator:
    """Maps controller quota decisions onto the latency model + tracks
    migration cost on termination (Procedure 3's Redis data move)."""

    def __init__(self, sim: "EdgeNodeSim"):
        self.sim = sim

    def apply_quota(self, tenant: str, quota: Quota) -> None:
        self.sim.units[tenant] = quota.units(self.sim.ctrl.pool.uR)

    def terminate(self, tenant: str) -> None:
        wl = self.sim.workloads[tenant]
        self.sim.migration_s.append(wl.migration_mb / WAN_BW_MBPS)
        self.sim.evicted.add(tenant)
        self.sim.units.pop(tenant, None)


class EdgeNodeSim:
    """One Edge node: a tenant fleet + its DyverseController.

    Drive it either with :meth:`run` (standalone, full duration) or with
    the chunk API (:meth:`step_chunk` / :meth:`run_controller_round` /
    :meth:`finalize`) — the latter is how :class:`EdgeFederation`
    interleaves placement decisions between nodes at round boundaries.
    """

    def __init__(self, workloads: list[Workload], cfg: SimConfig,
                 name: str = "edge0"):
        self.backend = resolve_engine(cfg.engine)
        if not self.backend.node_capable:
            raise ValueError(
                f"engine {cfg.engine!r} is not node-capable; valid "
                f"SimConfig engines: {sim_engines()}")
        self.cfg = cfg
        self.name = name
        self.rng = np.random.default_rng(cfg.seed)
        self.workloads: dict[str, Workload] = {}
        # name → (arrivals Generator, jitter Generator)
        self.tenant_rngs: dict[str, tuple] = {}
        self.units: dict[str, int] = {}
        # bumped on every fleet-membership change so FleetStepper knows
        # when its stacked parameter/RNG caches are stale
        self._fleet_epoch = 0
        self._stepper: FleetStepper | None = None
        self.evicted: set[str] = set()
        self.migration_s: list[float] = []
        # optional flight recorder (repro_torch.obs); _feed_wall accumulates
        # the monitor-feed wall between rounds while tracing is on
        self._obs = cfg.recorder
        self._feed_wall = 0.0
        self.ctrl = DyverseController(
            capacity=NodeCapacity(slots=cfg.capacity_units,
                                  pages=cfg.capacity_units * 8),
            uR=ResourceUnit(slots=1, pages=8),
            policy=cfg.policy,
            default_units=cfg.default_units,
            actuator=_SimActuator(self),
            normalize_factors=cfg.normalize_factors,
            control_plane=cfg.control_plane,
            scaling_policy=cfg.scaling_policy,
            forecaster=cfg.forecaster,
            forecast_window=cfg.forecast_window,
            hybrid_vr_band=cfg.hybrid_vr_band,
            recorder=cfg.recorder,
            node_name=name,
        )
        # run-state accumulators (chunk API)
        self._result = SimResult(policy=cfg.policy, violation_rate=0.0)
        self._all_lat: list[np.ndarray] = []
        self._all_slo: list[np.ndarray] = []
        self._req_s = np.zeros(cfg.duration_s, np.int64)
        self._viol_s = np.zeros(cfg.duration_s, np.int64)
        for i, w in enumerate(workloads):
            self.add_tenant(
                w,
                donation=bool(self.rng.random() < cfg.donation_fraction),
                premium=float(self.rng.random() < 0.25))

    # ------------------------------------------------------------ tenants
    def add_tenant(self, wl: Workload, *, donation: bool, premium: float,
                   spec: TenantSpec | None = None,
                   tenant_rng: tuple | None = None) -> bool:
        """Admit a workload to this node. Returns True when the Edge
        Manager accepted it; rejected tenants are serviced by the Cloud
        (they stay in ``workloads`` and keep generating requests). A
        federation passes ``spec``/``tenant_rng`` so a migrated tenant
        keeps its SLO contract and its random stream across nodes."""
        if wl.name in self.workloads:
            raise ValueError(
                f"tenant {wl.name!r} already hosted on node {self.name}")
        spec = spec or TenantSpec(
            name=wl.name,
            slo_latency=self.cfg.slo_scale * wl.base_latency,
            users=wl.users(),
            donation=donation,
            pricing=self.cfg.pricing,
            premium=premium,
        )
        self.workloads[wl.name] = wl
        self.tenant_rngs[wl.name] = (
            tenant_rng if tenant_rng is not None
            else self.backend.tenant_rng(self.cfg.seed, wl.name))
        self._fleet_epoch += 1
        res = self.ctrl.admit(spec)
        if not res.admitted:
            self.evicted.add(wl.name)
        return res.admitted

    def host_cloud_tenant(self, wl: Workload,
                          tenant_rng: tuple | None = None) -> None:
        """Attach a workload serviced purely by the Cloud tier: the Edge
        Manager allocates nothing, but the tenant's requests keep
        flowing through this node's accounting with WAN latency."""
        if wl.name in self.workloads:
            raise ValueError(
                f"tenant {wl.name!r} already hosted on node {self.name}")
        self.workloads[wl.name] = wl
        self.tenant_rngs[wl.name] = (
            tenant_rng if tenant_rng is not None
            else self.backend.tenant_rng(self.cfg.seed, wl.name))
        self._fleet_epoch += 1
        self.evicted.add(wl.name)

    def remove_tenant(self, name: str) -> Workload:
        """Detach an evicted workload (federation re-placement): it stops
        generating requests here and carries its RNG stream along."""
        self.evicted.discard(name)
        self.units.pop(name, None)
        self.tenant_rngs.pop(name)
        self._fleet_epoch += 1
        return self.workloads.pop(name)

    @property
    def load_fraction(self) -> float:
        return self.ctrl.load_fraction

    # ------------------------------------------------------------ chunk API
    def step_chunk(self, t0: int, t1: int) -> None:
        """Simulate seconds [t0, t1); no controller round in between.

        Dispatches through the resolved engine backend
        (:meth:`repro_torch.sim.engines.base.EngineBackend.step_node`): the
        scalar engine runs the per-second, per-tenant Python inner loop
        (per-second RNG draws, latency evaluation and SLO counting, as
        in the original second-stepped simulator); the vectorized engine
        realises the same trace with O(1) NumPy calls per tenant; the
        batched engine with O(1) NumPy calls per *fleet* (one
        (tenants × seconds) matrix). Because each tenant's arrival and
        jitter draws live on their own Generators, the three call
        patterns consume the bitstreams identically, and because all
        three feed the Monitor identical per-chunk values, every
        downstream quantity — violation rates, per-minute timelines,
        controller decisions — is bitwise equal. The torch engine matches
        them statistically, not bitwise (see
        :mod:`repro_torch.sim.engines.torch_backend`)."""
        obs = self._obs
        if obs is None:
            self.backend.step_node(self, t0, t1)
            return
        w0 = time.perf_counter()
        self.backend.step_node(self, t0, t1)
        obs.now = float(t1)
        obs.emit("chunk", t=float(t1), node=self.name,
                 dur=float(t1 - t0), wall=time.perf_counter() - w0)

    def _tenant_units(self, name: str) -> int:
        if name in self.evicted:
            return CLOUD_UNITS
        return self.units.get(name, self.cfg.default_units)

    def _account_chunk(self, name: str, wl: Workload, lat: np.ndarray,
                       counts: np.ndarray, slo: float) -> None:
        """Chunk-level bookkeeping common to both engines: Monitor feed
        (Eq. 1 + per-round metrics, Edge tenants only) and the
        user-visible latency distribution (Cloud requests get the WAN
        penalty but, as in the paper, don't enter Edge SLO accounting)."""
        if name in self.evicted:
            if lat.size:
                self._all_lat.append(lat + self.cfg.wan_extra_latency)
                self._all_slo.append(np.full(lat.size, slo))
            return
        if self._obs is None:
            self.ctrl.monitor.record_batch(
                name, lat, slo,
                data_mb=float(counts.sum()) * wl.data_per_request_mb)
            self.ctrl.monitor.set_users(name, wl.users())
        else:
            # identical calls, wall-clocked into the monitor-feed phase
            f0 = time.perf_counter()
            self.ctrl.monitor.record_batch(
                name, lat, slo,
                data_mb=float(counts.sum()) * wl.data_per_request_mb)
            self.ctrl.monitor.set_users(name, wl.users())
            self._feed_wall += time.perf_counter() - f0
        if lat.size:
            self._all_lat.append(lat)
            self._all_slo.append(np.full(lat.size, slo))

    def _step_chunk_vectorized(self, t0: int, t1: int) -> None:
        for name, wl in self.workloads.items():
            arr_rng, jit_rng = self.tenant_rngs[name]
            counts = wl.arrival_counts(arr_rng, t0, t1)
            jitter = wl.draw_jitter(jit_rng, int(counts.sum()))
            slo = self.cfg.slo_scale * wl.base_latency
            scale = wl.latency_scale(self._tenant_units(name), t0, t1)
            lat = np.repeat(scale, counts) * jitter
            self._account_chunk(name, wl, lat, counts, slo)
            if name in self.evicted:
                continue
            # per-second violation counts for the per-minute timeline:
            # reduceat over the seconds that actually saw requests (empty
            # seconds contribute no elements, so consecutive non-empty
            # offsets delimit exactly one second's requests)
            nz = counts > 0
            if nz.any():
                off = np.zeros(counts.size, np.int64)
                np.cumsum(counts[:-1], out=off[1:])
                viol = np.add.reduceat((lat > slo).astype(np.int64), off[nz])
                self._viol_s[t0:t1][nz] += viol
            self._req_s[t0:t1] += counts

    def _step_chunk_scalar(self, t0: int, t1: int) -> None:
        """Reference engine: the per-second, per-tenant Python inner loop
        — per-second arrival draw, jitter draw, latency-model evaluation
        and SLO counting, exactly the structure (and cost profile) of the
        original 1 s-resolution simulator."""
        for name, wl in self.workloads.items():
            arr_rng, jit_rng = self.tenant_rngs[name]
            units = self._tenant_units(name)
            evicted = name in self.evicted
            slo = self.cfg.slo_scale * wl.base_latency
            counts = np.zeros(t1 - t0, np.int64)
            parts = []
            for t in range(t0, t1):
                n = wl.requests_this_second(arr_rng, t)
                if n == 0:
                    continue
                lat_t = wl.latencies(jit_rng, n, units, t=t)
                counts[t - t0] = n
                parts.append(lat_t)
                if not evicted:
                    self._req_s[t] += n
                    self._viol_s[t] += int((lat_t > slo).sum())
            lat = np.concatenate(parts) if parts else np.empty(0)
            self._account_chunk(name, wl, lat, counts, slo)

    def run_controller_round(self, t: int | None = None):
        """One Procedure-1 round; records overheads and terminations.
        ``t`` (the round-boundary virtual time) stamps the recorder's
        clock cursor and the round span when tracing is on."""
        obs = self._obs
        if obs is not None and t is not None:
            obs.now = float(t)
        report = self.ctrl.run_round()
        res = self._result
        res.overhead_priority_s.append(report.priority_update_s)
        res.overhead_scaling_s.append(report.scaling_s)
        res.overhead_forecast_s.append(report.forecast_s)
        res.terminated.extend(report.terminated)
        res.round_actions.append(report.actions)
        if obs is not None:
            ri = len(res.overhead_priority_s) - 1
            phases = dict(report.phases or {})
            phases["monitor_feed"] = self._feed_wall
            self._feed_wall = 0.0
            for k, v in phases.items():
                res.overhead_phases.setdefault(k, []).append(v)
                obs.observe_phase(k, v)
            obs.emit("round", node=self.name, round=ri,
                     cause=self.cfg.policy,
                     dur=float(self.cfg.round_interval), **phases)
        return report

    def finalize(self) -> SimResult:
        res = self._result
        res.violation_rate = self.ctrl.node_violation_rate
        res.total_requests = self.ctrl.monitor.total_requests
        res.total_violations = self.ctrl.monitor.total_violations
        if self.cfg.duration_s > 0:
            # minute windows, INCLUDING the trailing partial minute when
            # duration_s % 60 != 0 (reduceat's last segment runs to the
            # end of the per-second arrays)
            edges = np.arange(0, self.cfg.duration_s, 60)
            req_m = np.add.reduceat(self._req_s, edges)
            viol_m = np.add.reduceat(self._viol_s, edges)
            res.per_minute_vr.extend(
                int(v) / max(int(r), 1) for r, v in zip(req_m, viol_m))
        res.latencies = (np.concatenate(self._all_lat)
                         if self._all_lat else np.empty(0))
        res.slos = (np.concatenate(self._all_slo)
                    if self._all_slo else np.empty(0))
        res.migration_s = self.migration_s
        if self._obs is not None:
            # standalone runs own their recorder; federations attach the
            # shared event stream to the FederationResult instead and
            # filter per-node here
            res.events = [e for e in self._obs.events
                          if e.node in (self.name, None)]
        return res

    # ------------------------------------------------------------ standalone
    def run(self) -> SimResult:
        cfg = self.cfg
        t = 0
        while t < cfg.duration_s:
            t1 = min(t + cfg.round_interval, cfg.duration_s)
            self.step_chunk(t, t1)
            if cfg.policy != "none" and t1 % cfg.round_interval == 0 \
                    and t1 < cfg.duration_s:
                self.run_controller_round(t1)
            t = t1
        return self.finalize()


_RNG_POOLS: dict[int, object] = {}
# below this many draws per chunk, drawing jitter inline beats the
# worker-thread handoff (wall-clock only — the bitstreams are identical)
_JITTER_OVERLAP_MIN = 4096
_EMPTY_F8 = np.empty(0)


def _rng_pool(workers: int):
    """Process-wide executors for overlapped RNG fills, keyed by pool
    size (``SimConfig.rng_workers``) — shared across steppers so
    short-lived simulators don't each pin idle threads. A stepper runs
    one chunk at a time and each Generator is owned by exactly one
    submitted range, so queued fills never interleave within a
    Generator."""
    pool = _RNG_POOLS.get(workers)
    if pool is None:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="repro-sim-rng")
        _RNG_POOLS[workers] = pool
    return pool


class FleetStepper:
    """``engine="batched"``: advances one or many nodes in lockstep,
    computing each chunk as a single stacked (nodes·tenants × seconds)
    matrix instead of per-tenant array passes.

    Bitwise-equivalence contract (vs the scalar/vectorized engines):

    * all deterministic math (arrival rates, demand, latency scale, the
      per-request scale×jitter product, WAN penalty, SLO comparisons)
      evaluates the identical float64 elementwise ops in the identical
      order — :class:`~repro_torch.sim.workload.FleetBatch` only restructures
      loops, never arithmetic;
    * random draws remain on each tenant's private Generator pair, in
      fleet order, so every substream is consumed exactly as the
      per-tenant engines consume it;
    * Monitor feeds use per-tenant contiguous slices of the flat request
      axis, whose ``.sum()`` is the same pairwise reduction
      ``record_batch`` performs on the per-tenant arrays;
    * per-second violation/request tallies are integer arithmetic.

    Stacked parameter arrays and RNG lists are cached and rebuilt when
    any node's fleet membership changes (``_fleet_epoch``), which is how
    federation re-placement stays cheap between round boundaries.

    Jitter draws run on a small worker-thread pool
    (``SimConfig.rng_workers``), overlapped with the deterministic
    matrix math on the main thread: NumPy's Generator releases the GIL
    while filling, the fleet is split into contiguous tenant ranges so
    each Generator is touched by exactly one thread, and the per-tenant
    call sequence is unchanged — so the overlap changes wall-clock only,
    never the bitstream.

    Monitor feed: when a node's controller runs the array control plane,
    the whole chunk's per-tenant reductions land as ONE
    ``Monitor.add_chunk`` sliced array-add per node (slot ids cached per
    fleet epoch); reference-control-plane nodes keep the per-tenant
    ``record_batch_sums`` loop. Per-tenant latency sums stay the exact
    reductions ``record_batch`` performs: segments of ≤2 requests reduce
    to the elements themselves (bitwise equal to a slice ``.sum()``, so
    fine-``round_interval`` chunks vectorise fully) and longer segments
    keep the per-tenant pairwise ``.sum()``.
    """

    def __init__(self, nodes: list[EdgeNodeSim]):
        self.nodes = nodes
        self._epochs: tuple | None = None
        # federation runs share one recorder across all nodes, so any
        # node's reference is THE recorder (None = tracing off)
        self._obs = next((n._obs for n in nodes if n._obs is not None),
                         None)
        # backend_options["jit_scale"]: True → the GPU, or a device name
        jit = next((n.cfg.backend_options["jit_scale"] for n in nodes
                    if n.cfg.backend_options.get("jit_scale", False)),
                   None)
        self._scale_device = "cuda" if jit is True else jit
        # overlap needs spare cores: workers beyond cores−1 just fight
        # the main thread for the GIL (measurably slower on 2-core CI)
        import os

        cfg_workers = max(1, max(
            (n.cfg.rng_workers for n in nodes), default=1))
        self._rng_workers = max(1, min(cfg_workers,
                                       (os.cpu_count() or 2) - 1))

    def _rebuild(self) -> None:
        entries = []
        slices = []
        start = 0
        for node in self.nodes:
            for name, wl in node.workloads.items():
                entries.append((node, name, wl))
            slices.append(slice(start, len(entries)))
            start = len(entries)
        self._entries = entries
        self._node_slices = slices
        self._batch = FleetBatch([wl for _, _, wl in entries])
        self._gather_rngs(entries)
        # membership-stable per-tenant metadata, gathered once per epoch
        # (same python products the other engines compute per chunk)
        self._slos = np.array([node.cfg.slo_scale * wl.base_latency
                               for node, _, wl in entries], np.float64)
        # per-row Cloud round-trip penalty (the hosting node's WAN link)
        self._wan = [node.cfg.wan_extra_latency for node, _, _ in entries]
        self._data_mb = [wl.data_per_request_mb for _, _, wl in entries]
        self._data_mb_arr = np.asarray(self._data_mb, np.float64)
        # array-control-plane nodes take the O(1)-per-chunk add_chunk
        # feed; slot ids stay valid within an epoch (evictions only free
        # slots, and any (re)admission bumps the epoch → rebuild)
        self._node_array_feed = [
            hasattr(node.ctrl.monitor, "add_chunk") for node in self.nodes]
        self._slot_ids = np.array(
            [getattr(node.ctrl.monitor, "slots", None).index.get(name, -1)
             if hasattr(node.ctrl.monitor, "slots") else -1
             for node, name, _ in entries], np.int64)
        self._evict_key: tuple | None = None
        self._evicted_arr: np.ndarray | None = None

    def _gather_rngs(self, entries: list) -> None:
        """Per-tenant numpy substream gather (arrival + jitter
        Generators). Counter-RNG engines override this with a no-op —
        their draws are keyed, not stateful, so there is nothing to
        collect."""
        self._arr_rngs = [node.tenant_rngs[name][0]
                          for node, name, _ in entries]
        self._batch.bind_rngs(self._arr_rngs)
        self._jit_rngs = [node.tenant_rngs[name][1]
                          for node, name, _ in entries]

    def _evicted_mask(self) -> np.ndarray:
        """(T,) bool eviction mask. Within a fleet epoch the evicted sets
        only grow (shrinking goes through remove_tenant, which bumps the
        epoch and rebuilds), so their sizes are a sufficient change key."""
        key = tuple(len(n.evicted) for n in self.nodes)
        if key != self._evict_key:
            self._evicted_arr = np.array(
                [name in node.evicted for node, name, _ in self._entries],
                bool)
            self._evict_key = key
        return self._evicted_arr

    def _units_vector(self, evicted: np.ndarray) -> np.ndarray:
        """Per-row allocated units: array-control-plane nodes gather the
        controller's slot-aligned units column (the same values the
        actuator writes into ``EdgeNodeSim.units``); reference nodes keep
        the per-tenant probe. Evicted rows get Cloud capacity."""
        units = np.empty(len(self._entries), np.int64)
        for node, sl, feed in zip(self.nodes, self._node_slices,
                                  self._node_array_feed):
            if sl.stop == sl.start:
                continue
            if feed:
                units[sl] = node.ctrl._cols.units[self._slot_ids[sl]]
            else:
                units[sl] = [node._tenant_units(name)
                             for _, name, _ in self._entries[sl]]
        units[evicted] = CLOUD_UNITS
        return units

    def _draw_jitter_range(self, lo: int, hi: int, totals_l: list) -> list:
        # a size-0 draw consumes no bitstream, so tenants with no
        # arrivals this chunk skip the Generator call entirely — at fine
        # round_interval that is most of the fleet, and it is bitwise-free
        return [wl.draw_jitter(self._jit_rngs[i], n) if n else _EMPTY_F8
                for i, ((_, _, wl), n) in enumerate(
                    zip(self._entries[lo:hi], totals_l[lo:hi]), lo)]

    def _submit_jitter(self, totals_l: list, totals: np.ndarray,
                       total: int) -> list:
        """Split the fleet into ≤``rng_workers`` contiguous ranges,
        balanced by draw count, and submit each as one task. Each
        Generator is drawn by exactly one task with the per-tenant call
        sequence unchanged, so the split never affects the bitstreams."""
        T = len(totals_l)
        w = min(self._rng_workers, T)
        pool = _rng_pool(self._rng_workers)
        if w <= 1:
            return [pool.submit(self._draw_jitter_range, 0, T, totals_l)]
        cum = np.cumsum(totals)
        targets = np.arange(1, w) * (total / w)
        bounds = [0, *(np.searchsorted(cum, targets, side="left") + 1), T]
        bounds = sorted(set(int(min(b, T)) for b in bounds))
        return [pool.submit(self._draw_jitter_range, lo, hi, totals_l)
                for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]

    def step(self, t0: int, t1: int) -> None:
        obs = self._obs
        if obs is not None:
            w0 = time.perf_counter()
            self._step(t0, t1)
            obs.now = float(t1)
            obs.emit("chunk", t=float(t1), dur=float(t1 - t0),
                     wall=time.perf_counter() - w0)
            return
        self._step(t0, t1)

    def _step(self, t0: int, t1: int) -> None:
        epochs = tuple(n._fleet_epoch for n in self.nodes)
        if epochs != self._epochs:
            self._rebuild()
            self._epochs = epochs
        entries = self._entries
        T, S = len(entries), t1 - t0
        if T == 0:
            return
        counts = self._batch.arrival_counts(self._arr_rngs, t0, t1)
        totals = counts.sum(axis=1)
        totals_l = totals.tolist()
        # jitter draws overlap the deterministic math below (see class
        # docstring); each worker owns its range's jitter Generators
        # until its future resolves. Tiny chunks (fine round_interval)
        # draw inline instead — thread handoff + GIL churn there costs
        # more than the draws, and the draw order is unchanged either way
        total_draws = int(totals.sum())
        jitter_futs = (self._submit_jitter(totals_l, totals, total_draws)
                       if total_draws >= _JITTER_OVERLAP_MIN else None)
        evicted = self._evicted_mask()
        units = self._units_vector(evicted)
        scale = self._batch.latency_scale(units, t0, t1,
                                          device=self._scale_device)
        # per-request deterministic factor: repeat each (tenant, second)
        # cell by its arrival count — a time-invariant fleet carries one
        # column per tenant, every second of which holds the same value
        if scale.shape[1] == 1:
            per_req = np.repeat(scale[:, 0], totals)
        else:
            per_req = np.repeat(scale.ravel(), counts.ravel())
        slo_rep = np.repeat(self._slos, totals)
        ends = np.cumsum(counts.ravel())
        # per-tenant extents on the flat request axis
        starts = np.zeros(T + 1, np.int64)
        np.cumsum(totals, out=starts[1:])
        if jitter_futs is not None:
            jit_parts = [p for f in jitter_futs for p in f.result()]
        elif total_draws:
            jit_parts = self._draw_jitter_range(0, T, totals_l)
        else:
            jit_parts = []        # nothing arrived: no Generator is owed
        #                           a draw, so skip the fleet walk entirely
        lat = per_req * (np.concatenate(jit_parts) if jit_parts
                         else np.empty(0))
        # per-(tenant, second) violation tallies, exactly: only the
        # violating requests need attribution, so locate each one's cell
        # on the flat request axis and count them (integer arithmetic —
        # identical to reducing the comparison per cell)
        vpos = np.flatnonzero(lat > slo_rep)
        if vpos.size:
            viol_ts = np.bincount(
                np.searchsorted(ends, vpos, side="right"),
                minlength=ends.size).reshape(T, S)
        else:
            viol_ts = np.zeros((T, S), np.int64)
        viol_t = viol_ts.sum(axis=1)
        # Cloud-serviced tenants: WAN penalty on the user-visible
        # latencies (same elementwise add the other engines apply, with
        # the hosting node's own Cloud-link latency)
        for i in np.flatnonzero(evicted):
            lat[starts[i]:starts[i + 1]] += self._wan[i]
        starts_l = starts.tolist()
        live = ~evicted
        # per-tenant latency sums, feeding the Monitors: segments of ≤2
        # requests are the elements themselves (bitwise equal to the
        # slice .sum() — so fine-round_interval chunks vectorise fully);
        # longer segments keep the per-tenant pairwise .sum(). Evicted
        # rows already carry the WAN penalty but are never fed.
        lat_sums = np.zeros(T, np.float64)
        if lat.size:
            p = starts[:T]
            small = totals <= 2
            sel = small & (totals >= 1)
            lat_sums[sel] = lat[p[sel]]
            sel = totals == 2
            lat_sums[sel] += lat[p[sel] + 1]
            for i in np.flatnonzero(~small & live).tolist():
                lat_sums[i] = lat[starts_l[i]:starts_l[i + 1]].sum()
        self._feed_nodes(t0, t1, counts, totals, starts, lat, slo_rep,
                         viol_ts, viol_t, lat_sums, evicted)

    def _feed_nodes(self, t0: int, t1: int, counts: np.ndarray,
                    totals: np.ndarray, starts: np.ndarray,
                    lat: np.ndarray, slo_rep: np.ndarray,
                    viol_ts: np.ndarray, viol_t: np.ndarray,
                    lat_sums: np.ndarray, evicted: np.ndarray,
                    users_arr: np.ndarray | None = None) -> None:
        """Accounting tail shared with the torch stepper: per-node
        per-second tallies, latency-distribution appends, and the
        Monitor feeds. Pure bookkeeping over already-final arrays — no
        RNG, no new float math — so the batched engine stays bitwise
        and engine subclasses reuse it unchanged. ``users_arr`` is an
        optional per-row user-count override; by default ``users()`` is
        re-read every chunk, like the other engines do (a subclass may
        report a time-varying user count)."""
        entries = self._entries
        live = ~evicted
        # per-node per-second tallies over Edge-hosted rows only
        # (integer sums — order-independent, exact)
        if live.all():
            counts_live, viol_live = counts, viol_ts
        else:
            counts_live = counts * live[:, None]
            viol_live = viol_ts * live[:, None]
        for node, sl in zip(self.nodes, self._node_slices):
            if sl.stop > sl.start:
                node._req_s[t0:t1] += counts_live[sl].sum(axis=0)
                node._viol_s[t0:t1] += viol_live[sl].sum(axis=0)
            seg = slice(starts[sl.start], starts[sl.stop])
            if seg.stop > seg.start:
                node._all_lat.append(lat[seg])
                node._all_slo.append(slo_rep[seg])
        totals_l = totals.tolist()
        viol_l = viol_t.tolist()
        all_live = bool(live.all())
        obs_on = self._obs is not None
        for ni, (node, sl) in enumerate(zip(self.nodes, self._node_slices)):
            if sl.stop == sl.start:
                continue
            f0 = time.perf_counter() if obs_on else 0.0
            if all_live and self._node_array_feed[ni]:
                # no evicted rows → the node's rows are one contiguous
                # slice: feed views instead of six gather copies
                users = (users_arr[sl] if users_arr is not None
                         else np.array([wl.users() for _, _, wl
                                        in entries[sl]], np.int64))
                node.ctrl.monitor.add_chunk(
                    self._slot_ids[sl], totals[sl], lat_sums[sl],
                    viol_t[sl], totals[sl] * self._data_mb_arr[sl], users)
            else:
                rows = np.flatnonzero(live[sl]) + sl.start
                if rows.size == 0:
                    continue
                mon = node.ctrl.monitor
                rows_l = rows.tolist()
                if self._node_array_feed[ni]:
                    users = (users_arr[rows] if users_arr is not None
                             else np.array([entries[i][2].users()
                                            for i in rows_l], np.int64))
                    mon.add_chunk(self._slot_ids[rows], totals[rows],
                                  lat_sums[rows], viol_t[rows],
                                  totals[rows] * self._data_mb_arr[rows],
                                  users)
                else:
                    for i in rows_l:
                        _, name, wl = entries[i]
                        mon.record_batch_sums(
                            name, totals_l[i], float(lat_sums[i]),
                            viol_l[i], totals_l[i] * self._data_mb[i],
                            users=(int(users_arr[i])
                                   if users_arr is not None
                                   else wl.users()))
            if obs_on:
                node._feed_wall += time.perf_counter() - f0
