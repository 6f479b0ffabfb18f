"""Workload generators mirroring the paper's two use cases (§5 Setup).

GameWorkload ≈ iPokeMon: a multi-user request/response server. Each
tenant serves 1–100 users; each user issues frequent small requests
(GPS/virtual-environment updates). Avg service time ≈ 78 ms; per-request
payload is small (the paper measures 149 KB/s over 32 servers).

StreamWorkload ≈ Face Detection: a single streaming source pushing
0.1–1 frames/s; each frame is large (grey-scaled video; 4 MB/s over 32
servers) and slow to process (avg 2.13 s).

Latency model (per request, given the tenant's allocated units):
    latency = base · max(1, ρ)^α · jitter,   ρ = demand_work / capacity
with capacity = units · unit_rate and lognormal jitter. Under-provisioned
tenants queue (ρ>1) and blow through their SLO; over-provisioned tenants
sit at base latency — exactly the regime DYVERSE redistributes.

Chunked API: the simulator consumes whole round-intervals at a time.
``arrival_counts`` returns per-second request counts for a [t0, t1)
window, ``latency_scale`` the per-second deterministic latency factor,
and ``draw_jitter`` the per-request multiplicative noise.

The scalar engine calls ``requests_this_second``/``draw_jitter`` once
per second; the vectorized engine calls ``arrival_counts``/
``draw_jitter`` once per chunk. On a ``numpy.random.Generator`` a
vector draw consumes the bitstream exactly like the equivalent sequence
of scalar draws (elementwise generation, no cached state), so as long
as each kind of draw has its own Generator the two call patterns yield
bitwise-identical traces — which is what makes the two engines agree
exactly.

Fleet-batched API: :class:`FleetBatch` stacks a whole fleet on a tenant
axis and evaluates arrival rates, demand rates, and latency scales as
(tenants × seconds) matrices — a handful of NumPy calls per chunk
instead of ~20 per tenant. The batched engine stays bitwise identical
to the per-tenant engines because

* deterministic expressions (``_lam``, ``demand_rates``,
  ``latency_scale``) broadcast per-tenant parameter *columns* against
  the shared seconds *row*, evaluating the exact same elementwise
  float64 ops in the exact same order as the per-tenant calls — only
  the loop structure changes, never the arithmetic; and
* random draws stay on each tenant's private Generator pair: batched
  Poisson arrivals are drawn per tenant from the batched rate matrix's
  rows (same λ values → same bitstream consumption), and jitter is
  drawn per tenant then concatenated. No draw is ever merged across
  tenants, so every substream advances exactly as it does under the
  scalar and vectorized engines.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Workload:
    name: str
    base_latency: float            # intrinsic service time (s)
    work_per_request: float        # abstract work units per request
    unit_rate: float               # work/s one resource unit can service
    alpha: float = 1.3             # queueing exponent under overload
    jitter_sigma: float = 0.08
    data_per_request_mb: float = 0.005
    migration_mb: float = 0.0      # state migrated to Cloud on termination

    # a well-provisioned server services in ~0.72·base — under the SLO, below
    # the dThr=0.8 scale-down threshold; moderately loaded tenants sit in
    # the (0.8·SLO, SLO] donation band
    provisioned_factor: float = 0.72

    # classes whose demand_rates never varies with t declare it here, so
    # FleetBatch may cache their (G, 1) demand column across chunks
    demand_time_invariant = False
    #: True when ``arrival_counts`` consumes no randomness (a closed-form
    #: schedule): rate-based engines (torch) can then reuse
    #: ``batch_arrival_counts`` with ``rngs=[None]*G``. RNG-backed
    #: classes instead expose their Poisson rate via ``batch_arrival_lam``
    #: (see :class:`GameWorkload`) so such engines can draw the same
    #: distribution from their own streams.
    arrival_rng_free = False

    def users(self) -> int:
        return 1

    # ---- chunked interface (simulator hot path) -------------------------
    def arrival_counts(self, rng: np.random.Generator, t0: int,
                       t1: int) -> np.ndarray:
        """Per-second request counts for seconds [t0, t1), shape (t1-t0,)."""
        raise NotImplementedError

    def demand_rates(self, t0: int, t1: int) -> np.ndarray:
        """Expected work/s for each second in [t0, t1) (drives queueing,
        not the lumpy per-second arrival count)."""
        raise NotImplementedError

    def latency_scale(self, units: int, t0: int, t1: int) -> np.ndarray:
        """Deterministic per-second latency factor: base·pf·max(1,ρ)^α."""
        capacity = max(units, 1) * self.unit_rate
        rho = self.demand_rates(t0, t1) / capacity
        return (self.base_latency * self.provisioned_factor
                * np.maximum(1.0, rho) ** self.alpha)

    def draw_jitter(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.lognormal(0.0, self.jitter_sigma, size=n)

    # ---- scalar forms (reference engine, unit tests) --------------------
    def requests_this_second(self, rng: np.random.Generator, t: int) -> int:
        return int(self.arrival_counts(rng, t, t + 1)[0])

    def demand_rate(self, t: int) -> float:
        return float(self.demand_rates(t, t + 1)[0])

    def latencies(self, rng: np.random.Generator, n: int, units: int,
                  t: int = 0) -> np.ndarray:
        if n == 0:
            return np.empty(0)
        scale = self.latency_scale(units, t, t + 1)[0]
        return scale * self.draw_jitter(rng, n)


    # ---- fleet-batched forms (batched engine) ---------------------------
    # Subclasses override these with true tenant-axis vectorizations; the
    # base fallbacks stack the per-instance results so any custom Workload
    # stays correct (if not fast) under engine="batched".
    @classmethod
    def batch_demand_rates(cls, fleet: list["Workload"], t0: int,
                           t1: int) -> np.ndarray:
        """Expected work/s as a (len(fleet), t1-t0) matrix. A class whose
        demand is constant across seconds may return a (len(fleet), 1)
        column instead — broadcasting it over the window is bitwise
        identical to evaluating every second, and lets the batched
        engine collapse the latency-scale math to one column."""
        return np.stack([w.demand_rates(t0, t1) for w in fleet])

    @classmethod
    def batch_arrival_counts(cls, fleet: list["Workload"], rngs: list,
                             t0: int, t1: int) -> np.ndarray:
        """Per-second request counts, (len(fleet), t1-t0) int64. Random
        draws MUST come from each tenant's own ``rngs`` entry, in fleet
        order, consuming the bitstream exactly as the per-tenant
        ``arrival_counts`` call would — that is the whole bitwise-
        equivalence contract."""
        return np.stack([w.arrival_counts(r, t0, t1)
                         for w, r in zip(fleet, rngs)])


@dataclass
class GameWorkload(Workload):
    """iPokeMon-like: n_users each ~poisson(rate_per_user) req/s with a
    diurnal-ish burst pattern."""

    n_users: int = 50
    rate_per_user: float = 0.5
    burst_period: int = 300
    burst_amp: float = 0.08

    def __post_init__(self):
        self.data_per_request_mb = 0.005
        self.migration_mb = 0.05 * self.n_users  # user sessions move to Cloud

    def _phase(self, t) -> np.ndarray:
        return 1.0 + self.burst_amp * np.sin(
            2 * np.pi * np.asarray(t, np.float64) / self.burst_period
            + self.n_users)

    def _lam(self, t0: int, t1: int) -> np.ndarray:
        phase = np.maximum(self._phase(np.arange(t0, t1)), 0.05)
        return self.n_users * self.rate_per_user * phase

    def arrival_counts(self, rng: np.random.Generator, t0: int,
                       t1: int) -> np.ndarray:
        return rng.poisson(self._lam(t0, t1)).astype(np.int64)

    def demand_rates(self, t0: int, t1: int) -> np.ndarray:
        return self._lam(t0, t1) * self.work_per_request

    def users(self) -> int:
        return self.n_users

    # ---- fleet-batched forms --------------------------------------------
    @classmethod
    def _batch_lam(cls, fleet: list["GameWorkload"], t0: int,
                   t1: int) -> np.ndarray:
        """(len(fleet), t1-t0) arrival-rate matrix, rows bitwise equal to
        each instance's ``_lam``: per-tenant parameters broadcast as
        columns against the shared seconds row, so every element goes
        through the identical float64 op sequence as the scalar form."""
        tp = 2 * np.pi * np.arange(t0, t1, dtype=np.float64)
        period = np.array([w.burst_period for w in fleet],
                          np.float64)[:, None]
        users = np.array([w.n_users for w in fleet], np.int64)[:, None]
        amp = np.array([w.burst_amp for w in fleet], np.float64)[:, None]
        phase = np.maximum(1.0 + amp * np.sin(tp / period + users), 0.05)
        rate = np.array([w.n_users * w.rate_per_user for w in fleet],
                        np.float64)[:, None]
        return rate * phase

    @classmethod
    def batch_demand_rates(cls, fleet: list["GameWorkload"], t0: int,
                           t1: int) -> np.ndarray:
        wpr = np.array([w.work_per_request for w in fleet],
                       np.float64)[:, None]
        return cls._batch_lam(fleet, t0, t1) * wpr

    @classmethod
    def batch_arrival_lam(cls, fleet: list["GameWorkload"], t0: int,
                          t1: int) -> np.ndarray:
        """Public declaration that arrivals are Poisson(λ) with this
        (len(fleet), t1-t0) rate matrix: rate-based engines (torch) draw
        Poisson counts from their own counter streams at exactly these
        rates instead of consuming the numpy substreams."""
        return cls._batch_lam(fleet, t0, t1)

    @classmethod
    def batch_arrival_counts(cls, fleet: list["GameWorkload"], rngs: list,
                             t0: int, t1: int) -> np.ndarray:
        lam = cls._batch_lam(fleet, t0, t1)
        out = np.empty(lam.shape, np.int64)
        # Poisson draws stay per-tenant (each tenant owns its substream);
        # identical λ rows → identical bitstream consumption and counts.
        for i, rng in enumerate(rngs):
            out[i] = rng.poisson(lam[i])
        return out


@dataclass
class StreamWorkload(Workload):
    """FD-like: single source, fps in [0.1, 1]; fractional fps accumulates
    across seconds. Arrivals are the stateless closed form
    ``n_t = ⌊fps·(t+1)⌋ − ⌊fps·t⌋`` so any [t0, t1) chunking of the
    timeline yields the identical frame schedule."""

    fps: float = 0.5
    demand_time_invariant = True           # fps never varies with t
    arrival_rng_free = True                # closed-form frame schedule
    _frames_scratch = None                 # f64 scratch for out= callers

    def __post_init__(self):
        self.data_per_request_mb = 0.6     # one grey-scale frame
        self.migration_mb = 0.0            # paper: no data migrated for FD

    def arrival_counts(self, rng: np.random.Generator, t0: int,
                       t1: int) -> np.ndarray:
        frames = np.floor(self.fps * np.arange(t0, t1 + 1))
        return np.diff(frames).astype(np.int64)

    def demand_rates(self, t0: int, t1: int) -> np.ndarray:
        return np.full(t1 - t0, self.fps * self.work_per_request)

    def users(self) -> int:
        return 1

    # ---- fleet-batched forms --------------------------------------------
    @classmethod
    def batch_demand_rates(cls, fleet: list["StreamWorkload"], t0: int,
                           t1: int) -> np.ndarray:
        # demand is time-invariant: return one column per tenant (each
        # value is the same fps·work product the scalar form fills the
        # window with) and let the batched engine broadcast it.
        return np.array([w.fps * w.work_per_request for w in fleet],
                        np.float64)[:, None]

    @classmethod
    def batch_arrival_counts(cls, fleet: list["StreamWorkload"], rngs: list,
                             t0: int, t1: int,
                             out: np.ndarray | None = None) -> np.ndarray:
        # deterministic frame schedule — consumes no randomness, exactly
        # like the per-instance form (``rngs`` stay untouched); the floor
        # values are exact small integers, so the f64 difference is exact
        # and the int64 cast yields the same counts as diffing integers.
        # ``out`` lets hot callers (the torch engine) reuse one result
        # buffer per chunk instead of re-faulting ~100 MB pages at 10⁵
        # tenants.
        fps = np.array([w.fps for w in fleet], np.float64)[:, None]
        t = np.arange(t0, t1 + 1, dtype=np.float64)
        if out is None:
            frames = fps * t
            out = np.empty((len(fleet), t1 - t0), np.int64)
        else:
            # buffer-reusing callers get a reused f64 scratch too (same
            # single-threaded hot path, so one slot suffices)
            frames = cls._frames_scratch
            if frames is None or frames.shape != (len(fleet), t.size):
                frames = np.empty((len(fleet), t.size), np.float64)
                StreamWorkload._frames_scratch = frames
            np.multiply(fps, t, out=frames)
        np.floor(frames, out=frames)
        np.subtract(frames[:, 1:], frames[:, :-1], out=out,
                    casting="unsafe")
        return out


class FleetBatch:
    """Stacked (tenants × seconds) evaluation of a heterogeneous fleet.

    Rows follow fleet order. Tenants are grouped by concrete Workload
    class; each class vectorizes its own expressions over the tenant
    axis (``batch_demand_rates``/``batch_arrival_counts``) and the
    results are scattered back into fleet-ordered matrices. Classes
    whose demand is time-invariant contribute (G, 1) columns; when the
    whole fleet is time-invariant the latency-scale math runs on one
    column per tenant instead of the full window — bitwise identical,
    since every second of a constant row is the same float64 value.

    The per-tenant RNG substream contract (see module docstring) is
    honoured by delegating all random draws to the class batchers with
    each tenant's own Generator.
    """

    def __init__(self, fleet: list[Workload]):
        self.fleet = list(fleet)
        self.base_pf = np.array(
            [w.base_latency * w.provisioned_factor for w in self.fleet],
            np.float64)
        self.unit_rate = np.array([w.unit_rate for w in self.fleet],
                                  np.float64)
        self.alpha = np.array([w.alpha for w in self.fleet], np.float64)
        groups: dict[type, list[int]] = {}
        for i, w in enumerate(self.fleet):
            groups.setdefault(type(w), []).append(i)
        self.groups = [(cls, np.asarray(idx, np.intp),
                        [self.fleet[i] for i in idx])
                       for cls, idx in groups.items()]
        self._bound_rngs: list | None = None
        self._rng_subs: list[list] = []
        # per-group (G, 1) demand columns, cached the first time a class
        # reports time-invariant demand (a width-1 column is constant by
        # contract, so replaying it each chunk is bitwise identical)
        self._const_demand: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.fleet)

    def bind_rngs(self, rngs: list) -> None:
        """Pre-slice per-group RNG sublists for a stable fleet→Generator
        mapping, so per-chunk calls skip the gather (the stepper rebinds
        whenever fleet membership changes)."""
        self._bound_rngs = rngs
        self._rng_subs = [[rngs[i] for i in idx] for _, idx, _ in self.groups]

    def arrival_counts(self, rngs: list, t0: int, t1: int) -> np.ndarray:
        """(T, t1-t0) int64 per-second request counts, rows bitwise equal
        to each tenant's own ``arrival_counts`` draw."""
        out = np.empty((len(self.fleet), t1 - t0), np.int64)
        bound = rngs is self._bound_rngs
        for g, (cls, idx, sub) in enumerate(self.groups):
            sub_rngs = self._rng_subs[g] if bound else [rngs[i] for i in idx]
            out[idx] = cls.batch_arrival_counts(sub, sub_rngs, t0, t1)
        return out

    def demand_rates(self, t0: int, t1: int) -> np.ndarray:
        """(T, t1-t0) float64 — or (T, 1) when every class in the fleet
        reports time-invariant demand."""
        mats = []
        for g, (cls, idx, sub) in enumerate(self.groups):
            m = self._const_demand.get(g)
            if m is None:
                m = cls.batch_demand_rates(sub, t0, t1)
                # a time-varying class also returns one column for a
                # 1-second window, so invariance must be declared, never
                # inferred from the shape
                if m.shape[1] == 1 and cls.demand_time_invariant:
                    self._const_demand[g] = m
            mats.append((idx, m))
        width = t1 - t0 if any(m.shape[1] != 1 for _, m in mats) else 1
        out = np.empty((len(self.fleet), width), np.float64)
        for idx, m in mats:
            out[idx] = m          # (G,1) broadcasts over a wide window
        return out

    def latency_scale(self, units: np.ndarray, t0: int, t1: int,
                      device: str | None = None) -> np.ndarray:
        """Deterministic latency factor matrix, same column width as
        ``demand_rates``. Each element evaluates base·pf·max(1,ρ)^α with
        the identical float64 op sequence as ``Workload.latency_scale``
        (the ^α is only computed where ρ>1; elsewhere the factor is
        exactly 1.0, which is what pow would return). ``device`` routes
        the expression through torch float64 on that device (the batched
        engine's ``jit_scale`` option) — fast on a GPU but NOT covered
        by the bitwise guarantee."""
        demand = self.demand_rates(t0, t1)
        capacity = np.maximum(units, 1) * self.unit_rate
        if device is not None:
            return _torch_latency_scale(self.base_pf, self.alpha, demand,
                                        capacity, device)
        rho = demand / capacity[:, None]
        m = np.maximum(1.0, rho)
        powed = np.ones_like(m)
        np.power(m, np.broadcast_to(self.alpha[:, None], m.shape),
                 out=powed, where=m > 1.0)
        return self.base_pf[:, None] * powed


def _torch_latency_scale(base_pf, alpha, demand, capacity,
                         device: str) -> np.ndarray:
    """torch float64 latency-scale expression on ``device``
    (``backend_options={"jit_scale": device}``). Elementwise IEEE
    division, max and pow in float64 track NumPy to a few ulp, but the
    device's pow is not guaranteed bitwise-equal to NumPy's — keep the
    option off when exact cross-engine equality matters (it is off by
    default and never used by the equivalence suite)."""
    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    rho = f64(demand) / f64(capacity)[:, None]
    m = torch.clamp(rho, min=1.0)
    powed = torch.where(m > 1.0, torch.pow(m, f64(alpha)[:, None]),
                        torch.ones((), dtype=torch.float64, device=device))
    return (f64(base_pf)[:, None] * powed).cpu().numpy()


def make_game_fleet(n: int, rng: np.random.Generator,
                    base_latency: float = 0.078,
                    prefix: str = "game") -> list[GameWorkload]:
    """n tenants, each 1–100 users (paper §5), heterogeneous demand."""
    fleet = []
    for i in range(n):
        users = int(rng.integers(1, 101))
        fleet.append(GameWorkload(
            name=f"{prefix}-{i}", base_latency=base_latency,
            work_per_request=1.0,
            # default 16 units violate above ~94 users nominally, ~87 at
            # burst peak → ≈18% time-avg demand-weighted overflow (paper's
            # no-scaling regime for the stringent SLO)
            unit_rate=2.05,
            n_users=users,
            rate_per_user=0.5))
    return fleet


def make_stream_fleet(n: int, rng: np.random.Generator,
                      base_latency: float = 2.13,
                      prefix: str = "fd") -> list[StreamWorkload]:
    """n tenants, each 0.1–1 fps (paper §5)."""
    fleet = []
    for i in range(n):
        fps = float(rng.uniform(0.1, 1.0))
        fleet.append(StreamWorkload(
            name=f"{prefix}-{i}", base_latency=base_latency,
            work_per_request=8.0,
            # default 16 units saturate at ~0.90 fps → ≈19% nominal overflow
            unit_rate=0.35,
            fps=fps))
    return fleet
