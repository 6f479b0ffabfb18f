"""What one run recorded, handed to every per-layer metric's reader.

Spans are host-clock (``time.perf_counter``) intervals that the
benchmark's own code takes around its calls into the program's layers;
the trace, when the run is traced, holds the device's operations on the
same clock (:mod:`bench.tracing`), and ``events`` the program's own
spans and instants (its ``repro_torch.obs.FlightRecorder``, attached to
the engine for the loop of a traced run), also on that clock."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Record:
    cell: str
    cfg: dict                       # the configuration file's keys
    window: tuple[float, float]     # the measured window [w0, w1)
    t_stop: float                   # when the run stopped waiting
    requests: list[dict]            # every request offered (bench.stats)
    steps: list[tuple] = field(default_factory=list)     # (t0, t1)
    prefills: list[tuple] = field(default_factory=list)  # (t0, t1, tenant, rid, ctx, resumed)
    decodes: list[tuple] = field(default_factory=list)   # (t0, t1, tenant, lengths)
    rounds: list[tuple] = field(default_factory=list)    # (t0, t1)
    quotas: list[tuple] = field(default_factory=list)    # (t0, {tenant: slots})
    trace: object | None = None     # bench.tracing.Trace, traced runs only
    arch: object | None = None      # the configuration's bench/arch/<arch>.py
    events: list | None = None      # the program's events, traced runs only
    events_dropped: int = 0         # events the recorder's ring let go

    def in_window(self, spans):
        w0, w1 = self.window
        return [s for s in spans if w0 <= s[0] < w1]

    def host_window(self) -> tuple[float, float]:
        """The part of the window that the host spans' metrics read: all
        of it in an untraced run; in a traced run the part before the
        loop began to start the profiler, free of its cost on the host."""
        w0, w1 = self.window
        tr = self.trace
        if tr is None:
            return (w0, w1)
        return (w0, min(w1, tr.t0 if tr.begun is None else tr.begun))

    def untraced(self, spans, start=lambda s: s[0]):
        """The spans whose ``start(span)`` lies in :meth:`host_window`."""
        a, b = self.host_window()
        return [s for s in spans if a <= start(s) < b]

    def program_spans(self, kind: str) -> list | None:
        """The program's events of ``kind`` that began in
        :meth:`host_window` (a span begins at ``t - detail["dur"]``, an
        instant at ``t``); None in a run without them, or where the
        recorder dropped any."""
        if self.events is None or self.events_dropped:
            return None
        return self.untraced(
            [e for e in self.events if e.kind == kind],
            start=lambda e: e.t - (e.detail or {}).get("dur", 0.0))

    def quota_min(self) -> dict:
        """Each tenant's smallest slot quota after the window's rounds."""
        out: dict = {}
        for t0, q in self.quotas:
            if self.window[0] <= t0 < self.window[1]:
                for n, v in q.items():
                    out[n] = min(out.get(n, v), v)
        return out
