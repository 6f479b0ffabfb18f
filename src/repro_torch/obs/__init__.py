"""repro_torch.obs — flight-recorder observability for the DYVERSE repro.

Zero-overhead-when-off instrumentation threaded through the
controller, both federations, the simulator backends and the serving
engine:

- :class:`FlightRecorder` — a bounded ring of typed structured
  :class:`Event` records (placement / eviction / scale_up /
  scale_down / donation / terminate, node fail/recover/degrade, WAN
  fault windows, serving admit/preempt/retry/timeout/shed/
  cloud_fallback, and the spans ``round``, ``chunk``, ``engine_step``,
  ``prefill`` and ``decode``), each stamped with its emitter's clock,
  round index, node, tenant slot, and cause.
- :class:`MetricsRegistry` — counters / histograms, with the
  p50/p95/p99 band math (:func:`percentile_bands`) unified out of
  ``repro_torch.serving.federation``.
- Exporters — JSONL event logs (:func:`write_events_jsonl`) and
  Chrome-trace / Perfetto ``trace.json`` (:func:`write_chrome_trace`):
  spans as slices, events as instants, one track per node. Load the
  file at https://ui.perfetto.dev or ``chrome://tracing``.

Clocks: an event's ``t`` is on its emitter's clock. The simulators and
the serving federation stamp their virtual clock; the serving engine
(:class:`~repro_torch.serving.engine.MultiTenantEngine`) stamps
``time.perf_counter``, the host clock a device trace is aligned to.

Tracing one engine::

    from repro_torch.obs import FlightRecorder, write_chrome_trace
    rec = FlightRecorder()
    engine.attach_recorder(rec)      # or MultiTenantEngine(recorder=rec)
    engine.run(100)
    engine.attach_recorder(None)     # back to the off path
    write_chrome_trace("trace.json", {"engine": rec.events_list()})

Contract: tracing draws no RNG and perturbs no control decision —
every bitwise pin (engine trio, both control planes, serving
determinism, the serving engine's tokens) holds with tracing on, and
the off path is a single ``is None`` predicate on the hot loops.
"""
from repro_torch.obs.events import EVENT_KINDS, Event  # noqa: F401
from repro_torch.obs.export import (chrome_trace_events,  # noqa: F401
                                    events_to_dicts, write_chrome_trace,
                                    write_events_jsonl)
from repro_torch.obs.metrics import (Counter, Histogram,  # noqa: F401
                                     MetricsRegistry, percentile_bands)
from repro_torch.obs.recorder import FlightRecorder  # noqa: F401

__all__ = [
    "EVENT_KINDS", "Event", "FlightRecorder",
    "Counter", "Histogram", "MetricsRegistry",
    "percentile_bands",
    "chrome_trace_events", "events_to_dicts",
    "write_chrome_trace", "write_events_jsonl",
]
