"""Regression differ: campaign report vs the persisted baselines.

Two baseline families, both read through the tolerant loader
(:func:`repro_torch.campaign.benchio.load_bench` — a missing, corrupt, or
unsupported-version file degrades to "no baseline", never a crash):

* the PREVIOUS campaign report (``BENCH_torchcampaign.json``) — cells
  match on full cell id plus equal ``duration_s``/``tenants`` (so a
  quick run never compares against a full run's numbers), VR
  regressions beyond ``Tolerances.vr_pp`` percentage points fail, and
  walls are compared (ratio > ``Tolerances.wall_ratio``) only when BOTH
  runs are full-mode on the same ``cpu_model`` and the same card (name
  and power limit, or no card on either);
* the per-section trajectories (``BENCH_torchscenarios.json``,
  ``BENCH_torchforecast.json``, ``BENCH_torchresilience.json``,
  ``BENCH_torchserving.json``) — a baseline row matches a cell when every
  identity field the row carries (scenario / engine / policy /
  scaling_policy / forecaster / placement / duration_s / tenants,
  with per-section implicit defaults for fields the historical writers
  omitted) equals the cell's. Tolerance-contract engines (torch) are
  skipped here: their documented ±2pp band vs the bitwise reference is
  wider than the regression tolerance, so comparing them against
  engine-less baseline rows would manufacture false regressions.

Regressions are VR increases beyond tolerance; VR *decreases* beyond
tolerance are reported as improvements (informational). Everything
that could not be compared lands in ``notes`` — the differ never
silently skips a baseline.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.campaign.benchio import load_section, machine_info
from repro_torch.campaign.report import CampaignReport, _contract

#: sections whose trajectories the differ reads (beyond the previous
#: campaign report itself).
TRAJECTORY_SECTIONS = ("scenarios", "forecast", "resilience", "serving")

#: identity fields a baseline row may pin (compared only when present
#: in BOTH the row and the cell record).
IDENTITY_FIELDS = ("scenario", "engine", "policy", "scaling_policy",
                   "forecaster", "placement", "duration_s", "tenants")

#: the machine fields that must be equal for two walls to be compared.
HOST_FIELDS = ("cpu_model", "gpu_name", "gpu_power_limit")

#: what the historical per-section writers left implicit.
SECTION_DEFAULTS = {
    "scenarios": {"scaling_policy": "reactive"},
    "forecast": {"policy": "sdps"},
    "resilience": {"scaling_policy": "reactive"},
    "serving": {"scaling_policy": "reactive"},
}


@dataclass(frozen=True)
class Tolerances:
    """The configurable regression-gate tolerances."""

    #: allowed VR increase, in percentage points (0.5 → +0.005 abs).
    vr_pp: float = 0.5
    #: allowed wall-clock ratio (new/old) before a wall regression.
    wall_ratio: float = 1.75
    #: ignore wall ratios when the old wall is below this floor (timer
    #: noise dominates sub-50ms cells).
    wall_floor_s: float = 0.05

    @property
    def vr_abs(self) -> float:
        return self.vr_pp / 100.0


@dataclass
class DiffResult:
    regressions: list = field(default_factory=list)
    improvements: list = field(default_factory=list)
    notes: list = field(default_factory=list)
    compared: int = 0

    @property
    def ok(self) -> bool:
        return not self.regressions

    def render(self) -> str:
        lines = [f"regression diff: {self.compared} comparisons, "
                 f"{len(self.regressions)} regressions, "
                 f"{len(self.improvements)} improvements"]
        for r in self.regressions:
            lines.append(f"  REGRESSION  {r}")
        for i in self.improvements:
            lines.append(f"  improvement {i}")
        for n in self.notes:
            lines.append(f"  note        {n}")
        return "\n".join(lines)


def _vr_compare(out: DiffResult, label: str, cell: dict, old_vr: float,
                tol: Tolerances) -> None:
    new_vr = cell.get("violation_rate")
    if new_vr is None or old_vr is None:
        return
    out.compared += 1
    delta = new_vr - old_vr
    if delta > tol.vr_abs:
        out.regressions.append(
            f"{cell['cell']}: VR {old_vr:.4f} -> {new_vr:.4f} "
            f"(+{delta * 100:.2f}pp > {tol.vr_pp}pp) vs {label}")
    elif delta < -tol.vr_abs:
        out.improvements.append(
            f"{cell['cell']}: VR {old_vr:.4f} -> {new_vr:.4f} "
            f"({delta * 100:.2f}pp) vs {label}")


def diff_previous_campaign(report: CampaignReport, prev: dict | None,
                           tol: Tolerances, out: DiffResult) -> None:
    """Diff against the previous ``BENCH_torchcampaign.json`` payload."""
    if prev is None:
        out.notes.append("no previous campaign baseline")
        return
    prev_rows = {r.get("cell"): r for r in prev["rows"]
                 if isinstance(r, dict) and r.get("status") == "ok"}
    same_host = _same_host(prev.get("machine", {}), machine_info())
    walls_comparable = (not report.quick and not prev.get("quick", False)
                        and same_host)
    matched = 0
    for cell in report.ok:
        old = prev_rows.get(cell["cell"])
        if old is None:
            continue
        if (old.get("duration_s") != cell.get("duration_s")
                or old.get("tenants") != cell.get("tenants")):
            out.notes.append(
                f"{cell['cell']}: previous campaign ran a different "
                f"size (quick/full mismatch) — VR not compared")
            continue
        matched += 1
        _vr_compare(out, "previous campaign", cell,
                    old.get("violation_rate"), tol)
        old_wall = old.get("wall_s")
        new_wall = cell.get("wall_s")
        if (walls_comparable and old_wall and new_wall
                and old_wall >= tol.wall_floor_s):
            out.compared += 1
            if new_wall > old_wall * tol.wall_ratio:
                out.regressions.append(
                    f"{cell['cell']}: wall {old_wall:.2f}s -> "
                    f"{new_wall:.2f}s (x{new_wall / old_wall:.2f} > "
                    f"x{tol.wall_ratio}) vs previous campaign")
    if not walls_comparable:
        out.notes.append("walls not compared vs previous campaign "
                         "(quick mode, or another host or card)")
    if not matched:
        out.notes.append("no comparable cells in the previous campaign")


def diff_trajectories(report: CampaignReport, root: str,
                      tol: Tolerances, out: DiffResult) -> None:
    """Diff VRs against the per-section BENCH trajectories."""
    for section in TRAJECTORY_SECTIONS:
        payload = load_section(section, root)
        if payload is None:
            out.notes.append(f"no {section} baseline (missing or "
                             f"unsupported BENCH_torch{section}.json)")
            continue
        defaults = SECTION_DEFAULTS.get(section, {})
        matched = 0
        for row in payload["rows"]:
            if not isinstance(row, dict):
                continue
            eff = {**defaults, **row}
            for cell in report.ok:
                if _contract(cell.get("engine")) == "tolerance":
                    continue
                if any(eff[f] != cell.get(f) for f in IDENTITY_FIELDS
                       if f in eff and f in cell):
                    continue
                matched += 1
                _vr_compare(out, f"BENCH_torch{section}", cell,
                            eff.get("violation_rate"), tol)
        if not matched:
            why = ("quick-mode sizes differ from the full-mode "
                   "trajectory" if report.quick else "no overlap")
            out.notes.append(
                f"no cells comparable to BENCH_torch{section} ({why})")


def diff_report(report: CampaignReport, *, root: str = ".",
                prev: dict | None = None,
                tol: Tolerances = Tolerances()) -> DiffResult:
    """The full differ: previous campaign + per-section trajectories.
    ``prev`` is the previous ``BENCH_torchcampaign.json`` payload (pass it
    BEFORE overwriting the file with this run's report)."""
    out = DiffResult()
    diff_previous_campaign(report, prev, tol, out)
    diff_trajectories(report, root, tol, out)
    return out


def _same_host(a: dict, b: dict) -> bool:
    """Walls compare only on one CPU model and one card (or none)."""
    return all(a.get(f) == b.get(f) for f in HOST_FIELDS)
