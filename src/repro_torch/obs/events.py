"""Typed structured events for the flight recorder.

One :class:`Event` per control-plane or federation decision, engine
call or request milestone, stamped with its emitter's clock (``t``: the
virtual clock for the simulators and the serving federation,
``time.perf_counter`` for the serving engine), the controller round
index (``round``, -1 when emitted outside a round), the node name, the
tenant and its monitor slot (-1 when slot-less, e.g. the reference
control plane), and a free-form ``cause`` string (eviction reason,
fault window id, placement source...). ``detail`` carries
event-specific numbers (units granted, queue depths, per-phase walls)
and is ``None`` when empty so an event costs one small object.

A span's ``t`` stamps its end and ``detail["dur"]`` its length, both in
seconds. The serving engine's spans:

- ``engine_step``: one ``MultiTenantEngine.step()``; ``step`` is its
  index. The ``prefill``, ``decode`` and ``round`` spans inside it are
  its children.
- ``prefill``: one request's prefill; ``rid``, ``ctx`` (tokens fed),
  ``resumed``, and its phases, which run back to back from the span's
  start in this order: ``inputs`` (the tokens to the device),
  ``forward`` (the model's prefill enqueued), ``insert`` (its cache
  into the batch cache), ``first`` (the first token read on the host,
  where the host waits for the device; a resumed prefill has none).
- ``decode``: one tenant's decode step; ``rids`` (the active rows'
  request ids in slot order; each row's token time is the span's end),
  ``rows``, ``ctx_sum`` (their summed lengths), ``graph`` (1 where the
  step replayed its captured CUDA graph, 0 where it ran eagerly), and
  its phases, back to back from the span's start: ``inputs`` (last
  tokens and positions copied to the step's static device buffers),
  ``forward`` (the model's decode enqueued: eagerly, kernel by kernel,
  or under replay the one graph launch, and a capture where one
  happens), ``wait`` (the next tokens read on the host, where the host
  waits for the device: under replay, the device running the whole
  step), ``finish`` (the per-row bookkeeping: finished requests
  retired and reported to the monitor).
- ``round``: one controller round; its detail is
  :attr:`~repro_torch.core.types.RoundReport.phases`, where
  ``classification``, ``eviction`` and ``actuation`` lie inside
  ``scaling``.

A phase's self time is its wall; a span's self time is its ``dur`` less
its phases. The engine's instants carry the request's ``rid`` too:
``serving_admit`` (``wait_s``, admission time less arrival on the
engine's request clock) and ``serving_preempt`` (``generated``).
``decode_capture`` is a tenant's decode step captured as a CUDA graph,
stamped at the end of the ``forward`` phase that holds it: ``wall``
(seconds the capture took) and ``captures`` (the tenant's count).
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
    "engine_step",          # one serving-engine step
    "prefill",              # one request's prefill; detail: phase walls
    "decode",               # one tenant's decode step; detail: phase walls
    "decode_capture",       # a tenant's decode step captured; detail: wall
})

_SPAN_KINDS = frozenset({"round", "chunk", "engine_step", "prefill",
                         "decode"})


@dataclass(slots=True)
class Event:
    """One flight-recorder entry (see module docstring for stamps)."""

    kind: str
    t: float = 0.0            # seconds on the emitter's clock
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
