"""Per-layer metrics, one reader a file, found by the metric's name.

Each file defines ``read(rec) -> float | None`` over a
:class:`bench.record.Record`; a reader that finds nothing to read
returns None, and the metric is left out of the run's line."""
