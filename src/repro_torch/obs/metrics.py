"""Metrics registry: counters, gauges, histograms, percentile bands.

:func:`percentile_bands` is the single p50/p95/p99 band computation —
unified out of ``repro_torch.serving.federation`` (token-latency bands) so
every band in the repo comes from the same ``np.percentile`` call and
stays bitwise-comparable across reports.
"""
from __future__ import annotations

import numpy as np


def percentile_bands(values) -> dict[str, float]:
    """The repo-wide p50/p95/p99 band summary of a sample.

    Matches the historical serving-federation output exactly:
    ``np.percentile`` (linear interpolation) over the raw sample plus
    the count as a float. ``values`` may be any sequence/array;
    empty input raises (callers filter empties, as serving always did).
    """
    a = np.asarray(values, dtype=np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)),
            "n": float(a.size)}


class Counter:
    """Monotonic event counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-value-wins instantaneous measurement."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Raw-sample histogram summarised via :func:`percentile_bands`."""

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: list[float] = []

    def observe(self, v: float) -> None:
        self.values.append(v)

    def extend(self, vs) -> None:
        self.values.extend(vs)

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    def bands(self) -> dict[str, float] | None:
        if not self.values:
            return None
        return percentile_bands(self.values)


class MetricsRegistry:
    """Get-or-create registry of named counters/gauges/histograms."""

    __slots__ = ("_counters", "_gauges", "_histograms")

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name)
        return h

    def snapshot(self) -> dict:
        """JSON-ready dump of every metric (histograms as bands)."""
        return {
            "counters": {n: c.value
                         for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value
                       for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.bands()
                           for n, h in sorted(self._histograms.items())},
        }
