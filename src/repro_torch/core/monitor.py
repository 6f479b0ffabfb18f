"""Monitor (paper §2): per-tenant metrics feeding priority + scaling.

Tracks, per tenant and per scaling round: request count, users serviced,
data transferred, latency samples vs the SLO (→ aL_s, VR_s), plus the
cumulative reward/scale/age/loyalty counters that live in TenantState.

The paper notes (Fig. 2a discussion) that DPM overhead depends on whether
workload metrics are maintained in-band (FD) or re-read from logs
(iPokeMon). This Monitor is in-band — and struct-of-arrays: each metric
is a dense numpy column indexed by a stable tenant-slot table
(:class:`SlotTable`), double-buffered for the current/previous round.
That makes the three hot operations cheap at fleet scale:

* ``add_chunk`` — the fleet-batched engine feeds a whole chunk's
  per-tenant reductions as ONE sliced array-add per node (O(1) numpy
  calls per chunk instead of one Python call per tenant);
* ``roll_round`` — a buffer swap + zero-fill instead of rebuilding a
  dict of N metric objects every round;
* the controller's Procedure-1 scoring/classification reads the
  previous-round columns directly, with no per-tenant accessor calls.

:class:`DictMonitor` retains the original dict-of-:class:`RoundMetrics`
implementation as the bitwise reference path (``control_plane=
"reference"`` on the controller) — the equivalence tests and the
``ctrlscale`` benchmark pin the array path against it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(slots=True)
class RoundMetrics:
    """One tenant's metrics within a scaling round (API surface; the
    array Monitor materialises these on demand from its columns)."""

    requests: int = 0                 # Request_s
    users: int = 0                    # |U_s| observed
    data_mb: float = 0.0              # Data_s
    lat_sum: float = 0.0
    violations: int = 0               # requests with latency > L_s

    @property
    def avg_latency(self) -> float:   # aL_s
        return self.lat_sum / self.requests if self.requests else 0.0

    @property
    def violation_rate(self) -> float:  # VR_s
        return self.violations / self.requests if self.requests else 0.0


class SlotTable:
    """Stable name → dense-slot-id mapping with LIFO slot reuse.

    Column owners (the Monitor's metric buffers, the controller's
    per-tenant state arrays) attach themselves and are grown in lockstep
    when the table doubles, so one slot id indexes every column of the
    control plane."""

    __slots__ = ("index", "_free", "capacity", "_owners")

    def __init__(self, capacity: int = 64):
        self.index: dict[str, int] = {}
        self._free: list[int] = []
        self.capacity = capacity
        self._owners: list = []       # objects exposing _grow_columns(cap)

    def attach(self, owner) -> None:
        self._owners.append(owner)

    def slot(self, name: str) -> int | None:
        return self.index.get(name)

    def acquire(self, name: str) -> int:
        """Slot for ``name``, allocating (or reusing a freed slot) if new."""
        slot = self.index.get(name)
        if slot is not None:
            return slot
        slot = self._free.pop() if self._free else len(self.index)
        if slot >= self.capacity:
            self.capacity *= 2
            for owner in self._owners:
                owner._grow_columns(self.capacity)
        self.index[name] = slot
        return slot

    def release(self, name: str) -> int | None:
        slot = self.index.pop(name, None)
        if slot is not None:
            self._free.append(slot)
        return slot


class _MetricCols:
    """One round buffer: five slot-indexed metric columns."""

    __slots__ = ("requests", "users", "data_mb", "lat_sum", "violations")

    def __init__(self, cap: int):
        self.requests = np.zeros(cap, np.int64)
        self.users = np.zeros(cap, np.int64)
        self.data_mb = np.zeros(cap, np.float64)
        self.lat_sum = np.zeros(cap, np.float64)
        self.violations = np.zeros(cap, np.int64)

    def grow(self, cap: int) -> None:
        for f in self.__slots__:
            old = getattr(self, f)
            new = np.zeros(cap, old.dtype)
            new[: old.size] = old
            setattr(self, f, new)

    def clear_slot(self, i: int) -> None:
        self.requests[i] = 0
        self.users[i] = 0
        self.data_mb[i] = 0.0
        self.lat_sum[i] = 0.0
        self.violations[i] = 0

    def zero(self) -> None:
        for f in self.__slots__:
            getattr(self, f).fill(0)

    def metrics(self, i: int) -> RoundMetrics:
        return RoundMetrics(
            requests=int(self.requests[i]), users=int(self.users[i]),
            data_mb=float(self.data_mb[i]), lat_sum=float(self.lat_sum[i]),
            violations=int(self.violations[i]))


class RoundView:
    """Mapping-style view of the closed round (``roll_round``'s return):
    materialises :class:`RoundMetrics` from the previous-round columns on
    demand, preserving the dict API the reference path consumes."""

    __slots__ = ("_mon",)

    def __init__(self, mon: "Monitor"):
        self._mon = mon

    def get(self, name: str, default=None):
        slot = self._mon.slots.index.get(name)
        if slot is None:
            return default
        return self._mon._prev.metrics(slot)

    def __contains__(self, name: str) -> bool:
        return name in self._mon.slots.index

    def keys(self):
        return self._mon.slots.index.keys()


class Monitor:
    """Struct-of-arrays Monitor (see module docstring for the layout)."""

    def __init__(self, slots: SlotTable | None = None) -> None:
        self.slots = slots or SlotTable()
        self.slots.attach(self)
        cap = self.slots.capacity
        self._cur = _MetricCols(cap)
        self._prev = _MetricCols(cap)
        # node-wide Eq. 1 accounting (never reset)
        self.total_requests = 0
        self.total_violations = 0

    def _grow_columns(self, cap: int) -> None:
        self._cur.grow(cap)
        self._prev.grow(cap)

    def register(self, tenant: str) -> None:
        self.slots.acquire(tenant)

    def forget(self, tenant: str) -> None:
        slot = self.slots.release(tenant)
        if slot is not None:          # reused slots must start clean
            self._cur.clear_slot(slot)
            self._prev.clear_slot(slot)

    def record_request(self, tenant: str, latency: float, slo: float,
                       data_mb: float = 0.0, user: int | None = None) -> None:
        i = self.slots.acquire(tenant)
        cur = self._cur
        cur.requests[i] += 1
        cur.lat_sum[i] += latency
        cur.data_mb[i] += data_mb
        if user is not None and user > cur.users[i]:
            cur.users[i] = user
        violated = latency > slo
        if violated:
            cur.violations[i] += 1
        self.total_requests += 1
        self.total_violations += int(violated)

    def record_batch(self, tenant: str, latencies, slo: float,
                     data_mb: float = 0.0) -> int:
        """Vectorised request recording (simulator fast-path). Returns the
        number of violations in the batch."""
        lat = np.asarray(latencies, np.float64)
        i = self.slots.acquire(tenant)
        n = int(lat.size)
        viol = int((lat > slo).sum())
        cur = self._cur
        cur.requests[i] += n
        cur.lat_sum[i] += float(lat.sum())
        cur.data_mb[i] += data_mb
        cur.violations[i] += viol
        self.total_requests += n
        self.total_violations += viol
        return viol

    def record_batch_sums(self, tenant: str, n: int, lat_sum: float,
                          violations: int, data_mb: float = 0.0,
                          users: int | None = None) -> None:
        """Batch recording from pre-reduced sums (fleet-batched engine
        fast path). The caller guarantees ``lat_sum``/``violations`` are
        the same reductions ``record_batch`` would compute — for the
        simulator that means a contiguous-slice ``.sum()`` (identical
        pairwise reduction) and an exact integer violation tally.
        ``users`` folds in a trailing ``set_users`` call."""
        i = self.slots.acquire(tenant)
        cur = self._cur
        cur.requests[i] += n
        cur.lat_sum[i] += lat_sum
        cur.data_mb[i] += data_mb
        cur.violations[i] += violations
        if users is not None:
            cur.users[i] = users
        self.total_requests += n
        self.total_violations += violations

    def add_chunk(self, slots: np.ndarray, n: np.ndarray, lat_sum: np.ndarray,
                  violations: np.ndarray, data_mb: np.ndarray,
                  users: np.ndarray | None = None) -> None:
        """One node's whole chunk as a single sliced array-add: per-slot
        reductions land with one elementwise add per column — the same
        float64/int64 add per tenant that ``record_batch_sums`` performs,
        just without N Python calls. ``slots`` must not repeat (each
        tenant appears once per chunk)."""
        cur = self._cur
        cur.requests[slots] += n
        cur.lat_sum[slots] += lat_sum
        cur.data_mb[slots] += data_mb
        cur.violations[slots] += violations
        if users is not None:
            cur.users[slots] = users
        self.total_requests += int(n.sum())
        self.total_violations += int(violations.sum())

    def set_users(self, tenant: str, users: int) -> None:
        self._cur.users[self.slots.acquire(tenant)] = users

    # ---- round boundary -------------------------------------------------
    def roll_round(self) -> RoundView:
        """Close the current round: the buffers swap, the new current
        round is zero-filled, and the closed round becomes the 'previous
        round' consumed by DPM and by Procedure 1's VR_s."""
        self._cur, self._prev = self._prev, self._cur
        self._cur.zero()
        return RoundView(self)

    def prev_columns(self) -> _MetricCols:
        """The closed round's slot-aligned metric columns — the bulk
        read-side API for consumers that reduce over the whole fleet at
        once (the controller's vectorised round classification and the
        forecast history recorder). Callers must treat the buffers as
        read-only; they are reused as the current round after the next
        ``roll_round``."""
        return self._prev

    def prev(self, tenant: str) -> RoundMetrics:
        slot = self.slots.index.get(tenant)
        return self._prev.metrics(slot) if slot is not None else RoundMetrics()

    def current(self, tenant: str) -> RoundMetrics:
        slot = self.slots.index.get(tenant)
        return self._cur.metrics(slot) if slot is not None else RoundMetrics()

    @property
    def node_violation_rate(self) -> float:
        """Eq. 1: VR_e over all tenants and all time."""
        return (self.total_violations / self.total_requests
                if self.total_requests else 0.0)


class DictMonitor:
    """Reference implementation: dict-of-RoundMetrics, one Python call
    per (tenant · chunk). Retained verbatim as the pre-array control
    plane so the equivalence suite and the ``ctrlscale`` benchmark can
    pin the SoA path against it bitwise."""

    def __init__(self) -> None:
        self._cur: dict[str, RoundMetrics] = {}
        self._prev: dict[str, RoundMetrics] = {}
        self.total_requests = 0
        self.total_violations = 0

    def register(self, tenant: str) -> None:
        self._cur.setdefault(tenant, RoundMetrics())
        self._prev.setdefault(tenant, RoundMetrics())

    def forget(self, tenant: str) -> None:
        self._cur.pop(tenant, None)
        self._prev.pop(tenant, None)

    def record_request(self, tenant: str, latency: float, slo: float,
                       data_mb: float = 0.0, user: int | None = None) -> None:
        m = self._cur.setdefault(tenant, RoundMetrics())
        m.requests += 1
        m.lat_sum += latency
        m.data_mb += data_mb
        if user is not None:
            m.users = max(m.users, user)
        violated = latency > slo
        if violated:
            m.violations += 1
        self.total_requests += 1
        self.total_violations += int(violated)

    def record_batch(self, tenant: str, latencies, slo: float,
                     data_mb: float = 0.0) -> int:
        lat = np.asarray(latencies, np.float64)
        m = self._cur.setdefault(tenant, RoundMetrics())
        n = int(lat.size)
        viol = int((lat > slo).sum())
        m.requests += n
        m.lat_sum += float(lat.sum())
        m.data_mb += data_mb
        m.violations += viol
        self.total_requests += n
        self.total_violations += viol
        return viol

    def record_batch_sums(self, tenant: str, n: int, lat_sum: float,
                          violations: int, data_mb: float = 0.0,
                          users: int | None = None) -> None:
        m = self._cur.setdefault(tenant, RoundMetrics())
        m.requests += n
        m.lat_sum += lat_sum
        m.data_mb += data_mb
        m.violations += violations
        if users is not None:
            m.users = users
        self.total_requests += n
        self.total_violations += violations

    def set_users(self, tenant: str, users: int) -> None:
        self._cur.setdefault(tenant, RoundMetrics()).users = users

    # ---- round boundary -------------------------------------------------
    def roll_round(self) -> dict[str, RoundMetrics]:
        self._prev = self._cur
        self._cur = {t: RoundMetrics() for t in self._prev}
        return self._prev

    def prev(self, tenant: str) -> RoundMetrics:
        return self._prev.get(tenant, RoundMetrics())

    def current(self, tenant: str) -> RoundMetrics:
        return self._cur.get(tenant, RoundMetrics())

    @property
    def node_violation_rate(self) -> float:
        return (self.total_violations / self.total_requests
                if self.total_requests else 0.0)
