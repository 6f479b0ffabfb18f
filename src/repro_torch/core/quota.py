"""Resource pool accounting: FR (free resources) + per-tenant quotas.

Invariants (property-tested):
  * Σ_s R_s + FR == node capacity, always, on both dimensions;
  * no quota goes negative;
  * alloc beyond FR raises (the auto-scaler must evict first — Procedure 2).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.types import Quota, ResourceUnit


class PoolError(RuntimeError):
    pass


@dataclass
class NodeCapacity:
    slots: int
    pages: int


class ResourcePool:
    def __init__(self, capacity: NodeCapacity, uR: ResourceUnit = ResourceUnit()):
        self.capacity = capacity
        self.uR = uR
        self._alloc: dict[str, Quota] = {}
        # running Σ_s R_s so FR probes are O(1) — Procedure 2 probes FR
        # inside its eviction loop, which made rounds O(N²) when ``free``
        # re-summed the registry every call. check_invariants() still
        # recounts from scratch and cross-checks these totals.
        self._used_slots = 0
        self._used_pages = 0
        # per-tenant R_s in uR units, maintained on every mutation so the
        # round hot path's ``units()`` probe skips the Quota division math
        # (cross-checked by check_invariants)
        self._units: dict[str, int] = {}
        # mutation epoch: invariants cannot break without a mutation, so
        # check_invariants() is a no-op between changes
        self._mutations = 0
        self._checked_at = -1

    # ---- views
    @property
    def free(self) -> Quota:
        """FR."""
        return Quota(self.capacity.slots - self._used_slots,
                     self.capacity.pages - self._used_pages)

    @property
    def free_units(self) -> int:
        # same integer math as self.free.units(self.uR), without building
        # the intermediate Quota — Procedure 2 probes this in its loop
        uR = self.uR
        return min((self.capacity.slots - self._used_slots)
                   // (uR.slots if uR.slots > 0 else 1),
                   (self.capacity.pages - self._used_pages)
                   // (uR.pages if uR.pages > 0 else 1))

    def quota(self, tenant: str) -> Quota:
        return self._alloc[tenant]

    def units(self, tenant: str) -> int:
        return self._units[tenant]

    def tenants(self) -> list[str]:
        return list(self._alloc)

    @property
    def used_units(self) -> int:
        """Σ_s R_s in uR units (allocation pressure, for placement).

        Deliberately NOT derived from the running slot/page totals:
        per-tenant units take a min across dimensions, and a sum of
        mins only equals the min of sums while every quota is a whole
        uR multiple — an invariant worth not betting placement on.
        O(N) over the cached per-tenant units; only placement probes
        pay it."""
        return sum(self._units.values())

    def can_admit(self, units: int) -> bool:
        """Feasibility probe: would ``admit`` succeed right now?"""
        q = Quota(0, 0).add_units(units, self.uR)
        f = self.free
        return q.slots <= f.slots and q.pages <= f.pages

    # ---- mutations
    def admit(self, tenant: str, units: int) -> Quota:
        if tenant in self._alloc:
            raise PoolError(f"{tenant} already allocated")
        q = Quota(0, 0).add_units(units, self.uR)
        f = self.free
        if q.slots > f.slots or q.pages > f.pages:
            raise PoolError(f"admit {tenant}: need {q}, free {f}")
        self._alloc[tenant] = q
        self._units[tenant] = q.units(self.uR)
        self._used_slots += q.slots
        self._used_pages += q.pages
        self._mutations += 1
        return q.copy()

    def grow(self, tenant: str, units: int) -> Quota:
        q = self._alloc[tenant]
        add = Quota(0, 0).add_units(units, self.uR)
        f = self.free
        if add.slots > f.slots or add.pages > f.pages:
            raise PoolError(f"grow {tenant} by {units}u: need {add}, free {f}")
        new = Quota(q.slots + add.slots, q.pages + add.pages)
        self._alloc[tenant] = new
        # growth is never clamped → unit count rises by exactly units
        # (same integer identities as the shrink fast path)
        self._units[tenant] += units
        self._used_slots += add.slots
        self._used_pages += add.pages
        self._mutations += 1
        return new.copy()

    def shrink(self, tenant: str, units: int) -> Quota:
        q = self._alloc[tenant]
        ds, dp = units * self.uR.slots, units * self.uR.pages
        if ds <= q.slots and dp <= q.pages:
            # un-clamped: both dimensions drop by exactly units·uR, so the
            # unit count drops by exactly units (⌊(a−n·s)/s⌋ = ⌊a/s⌋−n and
            # min(a−n, b−n) = min(a,b)−n are integer identities) — the
            # same result sub_units + units() re-derive, minus the math
            new = Quota(q.slots - ds, q.pages - dp)
            self._units[tenant] -= units
        else:
            new = q.sub_units(units, self.uR)
            self._units[tenant] = new.units(self.uR)
        self._alloc[tenant] = new
        self._used_slots -= q.slots - new.slots
        self._used_pages -= q.pages - new.pages
        self._mutations += 1
        return new.copy()

    def resize(self, capacity: NodeCapacity) -> None:
        """Replace the node capacity (fault injection: degradation /
        restoration). Allocations are untouched — the pool may come out
        overcommitted (negative FR), which ``check_invariants`` reports;
        the controller's contraction cascade must evict back to a
        feasible allocation before the next round check."""
        self.capacity = capacity
        self._mutations += 1

    def release(self, tenant: str) -> Quota:
        q = self._alloc.pop(tenant)
        self._units.pop(tenant, None)
        self._used_slots -= q.slots
        self._used_pages -= q.pages
        self._mutations += 1
        return q

    def check_invariants(self, deep: bool = False) -> None:
        """Recount Σ_s R_s and cross-check the running totals (every
        round); ``deep`` additionally re-derives every tenant's cached
        unit count (property tests). A no-op when nothing has mutated
        since the last check — invariants cannot break without one."""
        if self._mutations == self._checked_at and not deep:
            return
        checked = self._mutations        # committed only if checks pass:
        used_s = used_p = 0              # a detected violation must keep
        #                                  raising on re-probe
        for t, q in self._alloc.items():
            used_s += q.slots
            used_p += q.pages
            if q.slots < 0 or q.pages < 0:
                raise PoolError(f"negative quota for {t}: {q}")
        if deep:
            for t, q in self._alloc.items():
                if self._units[t] != q.units(self.uR):
                    raise PoolError(
                        f"units cache drifted for {t}: {self._units[t]} "
                        f"vs recount {q.units(self.uR)}")
        if (used_s, used_p) != (self._used_slots, self._used_pages):
            raise PoolError(
                f"running totals drifted: {self._used_slots}/"
                f"{self._used_pages} vs recount {used_s}/{used_p}")
        f = self.free
        if f.slots < 0 or f.pages < 0:
            raise PoolError(f"overcommitted: free {f}")
        self._checked_at = checked
