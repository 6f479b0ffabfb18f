"""Proactive autoscaling: per-tenant demand forecasting (ROADMAP item).

DYVERSE's Procedure 2 is purely reactive — a tenant is scaled only
*after* its `VR_s` shows violations, so every correction is paid for in
SLO misses first. Gupta et al. ("Proactive and Reactive Autoscaling
Techniques for Edge Computing", PAPERS.md) show forecast-driven scaling
cuts violation rates at equal resource budgets. This module supplies the
forecasting half of that seam; the :class:`~repro_torch.core.controller.
DyverseController` consumes it through its ``scaling_policy`` knob
(``"reactive"`` | ``"proactive"`` | ``"hybrid"``).

Three layers:

* :class:`RoundHistory` — a ring buffer of slot-aligned dense numpy
  metric columns (requests, VR_s, aL_s, allocated uR), one row per
  scaling round, appended at every ``roll_round`` and growing in
  lockstep with the control plane's :class:`~repro_torch.core.monitor.
  SlotTable`. ``born`` re-initialises a slot when its tenant changes, so
  LIFO slot reuse never leaks one tenant's history into another's
  forecast.
* :class:`Forecaster` — a protocol over :class:`HistoryWindow` (the
  gathered (rounds × tenants) window): each implementation predicts the
  whole fleet's next-round metrics as a handful of array ops over the
  tenant axis (the only Python loop is over the ≤``window`` history
  rows). Ships ``last_value``, ``ewma``, ``linear_trend`` (Holt double
  exponential smoothing) and ``seasonal_naive`` (keyed to the game
  workload's 300 s burst cycle — 5 rounds at the 60 s cadence the
  proactive scenarios run).
* :class:`ForecastEngine` — controller-side glue: owns the history, the
  forecaster, and the per-slot smoothed |VR̂ − VR| forecast error the
  ``hybrid`` policy gates on (fall back to reactive scaling wherever the
  forecast has been unreliable).

Recording history is deterministic numpy on values the Monitor already
holds — it draws no randomness and emits no actions, which is what lets
the controller append every round while keeping ``scaling_policy=
"reactive"`` bitwise-identical to the pre-forecast code path (pinned by
the neutrality tests in tests/test_control_plane.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.monitor import SlotTable

#: the controller's ScalingPolicy seam (see module docstring)
SCALING_POLICIES = ("reactive", "proactive", "hybrid")


@dataclass(slots=True)
class HistoryWindow:
    """The gathered forecast input: chronological (rounds × tenants)
    matrices of the last ``depth`` rounds for one set of slots (oldest
    row first), plus a validity mask — row r is valid for tenant j only
    if the tenant already occupied its slot in that round (``born``
    fences off the previous occupant's rows after slot reuse)."""

    requests: np.ndarray          # (d, n) float64 — Request_s per round
    vr: np.ndarray                # (d, n) float64 — VR_s per round
    avg_latency: np.ndarray       # (d, n) float64 — aL_s per round
    units: np.ndarray             # (d, n) float64 — allocated uR per round
    valid: np.ndarray             # (d, n) bool

    @property
    def depth(self) -> int:
        return self.requests.shape[0]


@dataclass(slots=True)
class ForecastFrame:
    """One next-round prediction per tenant (aligned with the slot index
    array the window was gathered for)."""

    requests: np.ndarray          # predicted Request_s
    vr: np.ndarray                # predicted VR_s
    avg_latency: np.ndarray      # predicted aL_s


class RoundHistory:
    """Ring buffer of per-round, slot-aligned metric columns.

    Shares the control plane's :class:`SlotTable`: one slot id indexes a
    tenant's Monitor metrics, controller state, AND its forecast
    history, and the buffers grow in lockstep when the table doubles.
    Rows are full-capacity columns; appending is four row-copies, so the
    per-round cost is independent of fleet size."""

    COLUMNS = ("requests", "vr", "avg_latency", "units")

    def __init__(self, slots: SlotTable, window: int = 16):
        if window < 2:
            raise ValueError(f"forecast window must be >= 2, got {window}")
        self.slots = slots
        self.window = window
        self.count = 0                # rounds appended, monotonic
        cap = slots.capacity
        for f in self.COLUMNS:
            setattr(self, f, np.zeros((window, cap), np.float64))
        # first absolute round each slot's CURRENT occupant participates
        # in — rows before it belong to a previous occupant (or nobody)
        self.start = np.zeros(cap, np.int64)
        slots.attach(self)

    def _grow_columns(self, cap: int) -> None:
        for f in self.COLUMNS:
            old = getattr(self, f)
            new = np.zeros((self.window, cap), np.float64)
            new[:, : old.shape[1]] = old
            setattr(self, f, new)
        # slots that have never existed are born "now": none of the
        # already-appended rounds belong to whoever acquires them
        grown = np.full(cap, self.count, np.int64)
        grown[: self.start.size] = self.start
        self.start = grown

    @property
    def depth(self) -> int:
        """Rounds available to a forecaster (≤ window)."""
        return min(self.count, self.window)

    def born(self, slot: int) -> None:
        """(Re)initialise a slot for a new occupant: its history starts
        at the next appended round, and stale rows are zeroed."""
        self.start[slot] = self.count
        for f in self.COLUMNS:
            getattr(self, f)[:, slot] = 0.0

    def append(self, requests: np.ndarray, vr: np.ndarray,
               avg_latency: np.ndarray, units: np.ndarray) -> None:
        """Close one scaling round: full-capacity metric columns land in
        the ring (the caller guarantees slot alignment)."""
        row = self.count % self.window
        self.requests[row] = requests
        self.vr[row] = vr
        self.avg_latency[row] = avg_latency
        self.units[row] = units
        self.count += 1

    def gather(self, idx: np.ndarray) -> HistoryWindow:
        """Chronological window for the given slot ids, oldest row
        first, with the per-slot validity mask forecasters honour."""
        d = self.depth
        rounds = np.arange(self.count - d, self.count)
        rows = rounds % self.window
        sel = np.ix_(rows, idx)
        return HistoryWindow(
            requests=self.requests[sel], vr=self.vr[sel],
            avg_latency=self.avg_latency[sel], units=self.units[sel],
            valid=rounds[:, None] >= self.start[idx][None, :])


# ----------------------------------------------------------- forecasters
@runtime_checkable
class Forecaster(Protocol):
    """Predicts the fleet's next-round metrics from a gathered window.
    Implementations must be pure functions of the window (no RNG, no
    retained state) so both control planes produce identical forecasts
    from identical histories."""

    name: str

    def predict(self, win: HistoryWindow) -> ForecastFrame: ...


class _PerMetricForecaster:
    """Base: applies one vectorized extrapolation to each metric column
    (requests, VR, aL). Subclasses implement ``_extrapolate`` on a
    (rounds × tenants) matrix + validity mask."""

    def predict(self, win: HistoryWindow) -> ForecastFrame:
        return ForecastFrame(
            requests=self._extrapolate(win.requests, win.valid),
            vr=self._extrapolate(win.vr, win.valid),
            avg_latency=self._extrapolate(win.avg_latency, win.valid))

    def _extrapolate(self, M: np.ndarray, valid: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def _last_valid(M: np.ndarray, valid: np.ndarray) -> np.ndarray:
        out = np.zeros(M.shape[1], np.float64)
        for t in range(M.shape[0]):
            out = np.where(valid[t], M[t], out)
        return out


class LastValueForecaster(_PerMetricForecaster):
    """Naive persistence: next round = the last observed round. With a
    depth-1 history this reproduces exactly the metrics Procedure 2's
    reactive branch reads, so it is the natural baseline forecaster."""

    name = "last_value"

    def _extrapolate(self, M, valid):
        return self._last_valid(M, valid)


class EwmaForecaster(_PerMetricForecaster):
    """Exponentially weighted moving average over the window: smooths
    jitter-driven round-to-round noise, at the cost of lagging genuine
    trends (alpha→1 degenerates to last_value)."""

    name = "ewma"

    def __init__(self, alpha: float = 0.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"ewma alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha

    def _extrapolate(self, M, valid):
        d, n = M.shape
        s = np.zeros(n, np.float64)
        seen = np.zeros(n, bool)
        for t in range(d):
            v = valid[t]
            s = np.where(v & seen, self.alpha * M[t] + (1 - self.alpha) * s,
                         np.where(v, M[t], s))
            seen = seen | v
        return s


class LinearTrendForecaster(_PerMetricForecaster):
    """Holt double exponential smoothing (level + trend): anticipates a
    metric that is *rising* across rounds — the regime where reactive
    scaling is always one violated round late."""

    name = "linear_trend"

    def __init__(self, alpha: float = 0.5, beta: float = 0.3):
        self.alpha = alpha
        self.beta = beta

    def _extrapolate(self, M, valid):
        d, n = M.shape
        level = np.zeros(n, np.float64)
        trend = np.zeros(n, np.float64)
        seen = np.zeros(n, bool)
        for t in range(d):
            v = valid[t]
            upd = v & seen
            new_level = np.where(
                upd, self.alpha * M[t] + (1 - self.alpha) * (level + trend),
                np.where(v, M[t], level))
            trend = np.where(upd,
                             self.beta * (new_level - level)
                             + (1 - self.beta) * trend,
                             np.where(v, 0.0, trend))
            level = new_level
            seen = seen | v
        return level + trend


class SeasonalNaiveForecaster(_PerMetricForecaster):
    """Cycle-aware persistence: next round = the value one season ago.
    The default season of 5 rounds matches the game workload's 300 s
    burst cycle at the 60 s round cadence the proactive scenarios run —
    after one full cycle, the forecaster pre-scales for each burst peak
    it has already seen. Falls back to last_value until a slot has a
    full season of its own history."""

    name = "seasonal_naive"

    def __init__(self, season: int = 5):
        if season < 1:
            raise ValueError(f"season must be >= 1, got {season}")
        self.season = season

    def _extrapolate(self, M, valid):
        d = M.shape[0]
        last = self._last_valid(M, valid)
        if d < self.season:
            return last
        row = d - self.season
        return np.where(valid[row], M[row], last)


#: forecaster registry: name → zero-arg factory with paper-scenario
#: defaults; resolve_forecaster also accepts ready-made instances
FORECASTERS: dict[str, type] = {
    f.name: f for f in (LastValueForecaster, EwmaForecaster,
                        LinearTrendForecaster, SeasonalNaiveForecaster)
}


def resolve_forecaster(spec: "str | Forecaster") -> Forecaster:
    """Registry lookup for string names; pass-through for instances
    (anything exposing ``name`` + ``predict``)."""
    if isinstance(spec, str):
        try:
            return FORECASTERS[spec]()
        except KeyError:
            raise ValueError(
                f"forecaster {spec!r} not in {sorted(FORECASTERS)}") from None
    if not isinstance(spec, Forecaster):
        raise TypeError(f"not a Forecaster: {spec!r}")
    return spec


class ForecastEngine:
    """Controller-side glue around one node's forecasts.

    Owns the :class:`RoundHistory`, the resolved :class:`Forecaster`,
    and the per-slot forecast-error EWMA (smoothed |VR̂ − VR|) that the
    ``hybrid`` scaling policy gates on: a tenant whose recent forecasts
    missed by more than the error band is scaled reactively until the
    forecast becomes trustworthy again."""

    def __init__(self, slots: SlotTable, forecaster: "str | Forecaster",
                 window: int = 16, error_alpha: float = 0.5):
        self.history = RoundHistory(slots, window)
        self.forecaster = resolve_forecaster(forecaster)
        self.error_alpha = error_alpha
        cap = slots.capacity
        # last round's VR prediction per slot (NaN = none outstanding)
        self.pred_vr = np.full(cap, np.nan)
        self.err_vr = np.zeros(cap)      # smoothed |VR̂ − VR| per slot
        self.scored_rounds = 0           # rounds with a prediction scored
        slots.attach(self)

    def _grow_columns(self, cap: int) -> None:
        pred = np.full(cap, np.nan)
        pred[: self.pred_vr.size] = self.pred_vr
        self.pred_vr = pred
        err = np.zeros(cap)
        err[: self.err_vr.size] = self.err_vr
        self.err_vr = err

    def born(self, slot: int) -> None:
        """A new tenant occupies ``slot``: fresh history, no outstanding
        prediction, clean error estimate."""
        self.history.born(slot)
        self.pred_vr[slot] = np.nan
        self.err_vr[slot] = 0.0

    def observe(self, requests: np.ndarray, vr: np.ndarray,
                avg_latency: np.ndarray, units: np.ndarray) -> None:
        """Close a round: score any outstanding VR predictions against
        the realised VR (updating the per-slot error EWMA), then append
        the round to the history ring."""
        scored = ~np.isnan(self.pred_vr)
        if scored.any():
            a = self.error_alpha
            err = np.abs(self.pred_vr - vr)
            self.err_vr = np.where(scored, a * err + (1 - a) * self.err_vr,
                                   self.err_vr)
            self.pred_vr.fill(np.nan)
            self.scored_rounds += 1
        self.history.append(requests, vr, avg_latency, units)

    def predict(self, idx: np.ndarray) -> ForecastFrame:
        """Next-round forecast for the given slots, clamped to sane
        ranges (VR ∈ [0, 1]; requests/aL ≥ 0 — trend extrapolation can
        otherwise go negative). The VR prediction is remembered per slot
        so the next ``observe`` can score it."""
        raw = self.forecaster.predict(self.history.gather(idx))
        frame = ForecastFrame(
            requests=np.maximum(raw.requests, 0.0),
            vr=np.clip(raw.vr, 0.0, 1.0),
            avg_latency=np.maximum(raw.avg_latency, 0.0))
        self.pred_vr[idx] = frame.vr
        return frame
