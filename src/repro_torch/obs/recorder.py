"""The flight recorder: a bounded ring of typed events + metrics.

One :class:`FlightRecorder` instance observes one run (one policy ×
scaling-policy federation). It is shared by the federation, every
node, and every controller; all of them hold it as an optional
attribute that defaults to ``None`` — the tracing-off hot path is a
single ``x is None`` predicate and allocates nothing.

The recorder itself draws no RNG and never feeds back into control
decisions; it only appends to a ``deque(maxlen=...)`` ring and bumps
plain-int counters.
"""
from __future__ import annotations

from collections import deque

from repro_torch.obs.events import EVENT_KINDS, Event
from repro_torch.obs.metrics import MetricsRegistry

DEFAULT_CAPACITY = 65536


class FlightRecorder:
    """Bounded event ring + metrics registry + virtual-clock cursor.

    ``now`` is the current virtual-clock time, advanced by whichever
    layer drives the clock (federation chunk loop / node run loop);
    emitters that don't know the time inherit it (the controller emits
    mid-round with only its round index).
    """

    __slots__ = ("events", "capacity", "dropped", "now", "metrics")

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self.events: deque[Event] = deque(maxlen=self.capacity)
        self.dropped = 0          # ring-evicted event count
        self.now = 0.0            # virtual-clock cursor
        self.metrics = MetricsRegistry()

    def __len__(self) -> int:
        return len(self.events)

    def emit(self, kind: str, *, t: float | None = None,
             round: int = -1, node: str | None = None,
             tenant: str | None = None, slot: int = -1,
             cause: str | None = None, **detail) -> None:
        """Append one event. ``t=None`` stamps the clock cursor."""
        assert kind in EVENT_KINDS, f"unknown event kind {kind!r}"
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(Event(
            kind=kind, t=self.now if t is None else float(t),
            round=round, node=node, tenant=tenant, slot=slot,
            cause=cause, detail=detail or None))
        self.metrics.counter(f"events.{kind}").inc()

    def observe_phase(self, phase: str, wall_s: float) -> None:
        """Record one per-round phase wall into the histogram bank."""
        self.metrics.histogram(f"phase.{phase}").observe(wall_s)

    def counts(self) -> dict[str, int]:
        """Event counts by kind (from the metrics counters)."""
        out = {}
        for name, c in self.metrics._counters.items():
            if name.startswith("events."):
                out[name[len("events."):]] = c.value
        return dict(sorted(out.items()))

    def events_list(self) -> list[Event]:
        return list(self.events)
