"""repro_torch.obs — flight-recorder observability for the DYVERSE repro.

Zero-overhead-when-off instrumentation threaded through the
controller, both federations, and the engine backends:

- :class:`FlightRecorder` — a bounded ring of typed structured
  :class:`Event` records (placement / eviction / scale_up /
  scale_down / donation / terminate, node fail/recover/degrade, WAN
  fault windows, serving admit/preempt/retry/timeout/shed/
  cloud_fallback, per-round spans), each stamped with the virtual
  clock, round index, node, tenant slot, and cause.
- :class:`MetricsRegistry` — counters / gauges / histograms, with the
  p50/p95/p99 band math (:func:`percentile_bands`) unified out of
  ``repro_torch.serving.federation``.
- Exporters — JSONL event logs (:func:`write_events_jsonl`) and
  Chrome-trace / Perfetto ``trace.json`` (:func:`write_chrome_trace`):
  rounds as spans, events as instants, one track per node. Load the
  file at https://ui.perfetto.dev or ``chrome://tracing``.

Contract: tracing draws no RNG and perturbs no control decision —
every bitwise pin (engine trio, both control planes, serving
determinism) holds with tracing on, and the off path is a single
``is None`` predicate on the hot loops.
"""
from repro_torch.obs.events import EVENT_KINDS, Event  # noqa: F401
from repro_torch.obs.export import (chrome_trace_events,  # noqa: F401
                                    events_to_dicts, write_chrome_trace,
                                    write_events_jsonl)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, percentile_bands)
from repro_torch.obs.recorder import FlightRecorder  # noqa: F401

__all__ = [
    "EVENT_KINDS", "Event", "FlightRecorder",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "percentile_bands",
    "chrome_trace_events", "events_to_dicts",
    "write_chrome_trace", "write_events_jsonl",
]
