"""Quota-aware continuous-batching scheduler.

Per-tenant quotas come from DYVERSE (Quota.slots = concurrent decode
sequences; Quota.pages = KV pages). When a quota shrinks below current
usage the scheduler preempts the YOUNGEST sequences (they lose the least
work) back to the queue — that is the engine-level actuation of a
DYVERSE scale-down, and it is control-plane-only.

Page accounting is *worst-case at admission*: an active sequence
reserves ``ceil((prompt + max_new_tokens) / page_size)`` pages — the
most it can ever hold — for its whole residency, not its instantaneous
``context_len``. Reserving the instantaneous footprint would admit
requests against pages their neighbours are about to grow into: active
requests gain a token per decode step, so ``Σ context pages`` rises
between scaling rounds with no admission (or preemption) check in
between, silently overcommitting ``quota.pages``. With worst-case
reservation, ``pages_used ≤ quota.pages`` is a step-time invariant —
decode growth can never exceed what admission already accounted for.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

from repro_torch.core.types import Quota
from repro_torch.serving.request import Phase, Request, RequestState


def reserved_pages(rs: RequestState, page_size: int) -> int:
    """Worst-case KV pages a request can ever occupy: the full prompt
    plus every token it is allowed to generate."""
    peak = len(rs.req.prompt) + rs.req.max_new_tokens
    return math.ceil(max(peak, 1) / page_size)


@dataclass
class TenantQueues:
    quota: Quota
    waiting: deque = field(default_factory=deque)       # RequestState
    active: list[RequestState] = field(default_factory=list)

    def pages_used(self, page_size: int) -> int:
        """Pages reserved by the active set (worst-case at admission —
        see module docstring)."""
        return sum(reserved_pages(r, page_size) for r in self.active)


class QuotaScheduler:
    def __init__(self, page_size: int = 16):
        self.page_size = page_size
        self.tenants: dict[str, TenantQueues] = {}

    # ---- tenant lifecycle -------------------------------------------------
    def add_tenant(self, name: str, quota: Quota) -> None:
        self.tenants[name] = TenantQueues(quota=quota)

    def remove_tenant(self, name: str) -> list[RequestState]:
        """Terminate (Procedure 3): all requests are evicted to the Cloud."""
        tq = self.tenants.pop(name, None)
        if tq is None:
            return []
        out = list(tq.active) + list(tq.waiting)
        for r in out:
            r.phase = Phase.EVICTED
            r.batch_slot = -1
        return out

    def set_quota(self, name: str, quota: Quota) -> list[RequestState]:
        """DYVERSE vertical scaling actuation. Returns preempted requests.

        Preemption is loss-less: a victim keeps its ``generated`` tokens
        and ``first_token_t``; on re-admission the engine re-prefills the
        full decoded context so the continuation is bitwise-identical to
        an unpreempted run (pinned by the preemption regression test)."""
        tq = self.tenants.get(name)
        if tq is None:
            return []
        tq.quota = quota
        preempted: list[RequestState] = []
        # slots shrink → preempt youngest
        while len(tq.active) > quota.slots:
            preempted.append(self._preempt_youngest(tq))
        # pages shrink → preempt youngest until within budget
        while tq.pages_used(self.page_size) > quota.pages and tq.active:
            preempted.append(self._preempt_youngest(tq))
        return preempted

    def _preempt_youngest(self, tq: TenantQueues) -> RequestState:
        victim = max(tq.active, key=lambda r: r.req.arrival_t)
        tq.active.remove(victim)
        victim.phase = Phase.QUEUED
        victim.batch_slot = -1
        tq.waiting.appendleft(victim)
        return victim

    # ---- request flow -----------------------------------------------------
    def submit(self, req: Request) -> RequestState:
        rs = RequestState(req=req)
        self.tenants[req.tenant].waiting.append(rs)
        return rs

    def requeue(self, rs: RequestState) -> None:
        """Re-enqueue a migrated request (federation failover / Procedure-3
        re-placement) WITHOUT building a new Request — arrival_t and the
        accumulated queueing time must survive the move."""
        rs.phase = Phase.QUEUED
        rs.batch_slot = -1
        self.tenants[rs.req.tenant].waiting.append(rs)

    def admit_waiting(self, name: str,
                      now: float | None = None) -> list[RequestState]:
        """Move waiting→active while slot & page quotas allow. Returns the
        newly admitted requests (they need prefill). Pages are reserved
        worst-case (prompt + max_new_tokens), matching ``pages_used``.

        With ``now`` given, requests still inside a retry backoff
        (``not_before > now``) are skipped over WITHOUT consuming a
        slot — FIFO order among the rest is preserved, and the deferred
        requests return to the head of the queue in their original
        order. With every ``not_before`` at 0 (the default) behavior is
        identical to the pre-timeout scheduler."""
        tq = self.tenants[name]
        admitted = []
        deferred: list[RequestState] = []
        while tq.waiting:
            cand: RequestState = tq.waiting[0]
            if now is not None and cand.not_before > now:
                deferred.append(tq.waiting.popleft())
                continue
            need_pages = reserved_pages(cand, self.page_size)
            if len(tq.active) + 1 > tq.quota.slots:
                break
            if tq.pages_used(self.page_size) + need_pages > tq.quota.pages:
                break
            tq.waiting.popleft()
            cand.phase = Phase.PREFILL
            tq.active.append(cand)
            admitted.append(cand)
        for rs in reversed(deferred):
            tq.waiting.appendleft(rs)
        return admitted

    def finish(self, name: str, rs: RequestState, now: float) -> None:
        tq = self.tenants[name]
        if rs in tq.active:
            tq.active.remove(rs)
        rs.phase = Phase.DONE
        rs.finish_t = now

    # ---- views ------------------------------------------------------------
    def active(self, name: str) -> list[RequestState]:
        return self.tenants[name].active

    def depth(self, name: str) -> int:
        return len(self.tenants[name].waiting)
