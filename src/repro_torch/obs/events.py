"""Typed structured events for the flight recorder.

One :class:`Event` per control-plane or federation decision, stamped
with the virtual clock (``t``), the controller round index (``round``,
-1 when emitted outside a round), the node name, the tenant and its
monitor slot (-1 when slot-less, e.g. the reference control plane),
and a free-form ``cause`` string (eviction reason, fault window id,
placement source...). ``detail`` carries event-specific numbers
(units granted, queue depths, per-phase walls) and is ``None`` when
empty so an event costs one small object.
"""
from __future__ import annotations

from dataclasses import dataclass

# The event vocabulary. Emitters may only use kinds listed here —
# pinned by tests so the docs/exporter stay in sync with the code.
EVENT_KINDS = frozenset({
    # placement / lifecycle (EdgeFederation + ServingFederation)
    "placement",            # cause: admit|replace|failover|cloud|recover
    # Procedure 1/2/3 (DyverseController, both control planes)
    "scale_up", "scale_down", "donation",
    "terminate",            # cause: the Procedure-3 reason string
    # fault model
    "node_fail", "node_recover", "node_degrade", "node_restore",
    "wan_fault",            # cause: start|end
    # serving control loop
    "serving_admit", "serving_preempt", "serving_retry",
    "serving_timeout", "serving_shed", "serving_cloud",
    # spans (exported as Chrome-trace "X" slices, not instants)
    "round",                # one controller round; detail: phase walls
    "chunk",                # one engine chunk;     detail: wall
})

_SPAN_KINDS = frozenset({"round", "chunk"})


@dataclass(slots=True)
class Event:
    """One flight-recorder entry (see module docstring for stamps)."""

    kind: str
    t: float = 0.0            # virtual-clock seconds
    round: int = -1           # controller round index (-1: outside)
    node: str | None = None   # None: federation-level event
    tenant: str | None = None
    slot: int = -1            # monitor slot id (-1: slot-less)
    cause: str | None = None
    detail: dict | None = None

    @property
    def is_span(self) -> bool:
        return self.kind in _SPAN_KINDS

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "t": self.t, "round": self.round,
             "node": self.node, "tenant": self.tenant,
             "slot": self.slot, "cause": self.cause}
        if self.detail:
            d["detail"] = self.detail
        return d
