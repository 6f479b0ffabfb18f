"""Campaign aggregation: cell records → one ``CampaignReport``.

A report rolls the executor's per-cell records up into grouped tables
(per scenario, engine-contract consistency groups, per-axis VR
marginals, token-level latency bands next to the model-based ones) and
one persistable payload (``BENCH_torchcampaign.json``, written
through :mod:`repro_torch.campaign.benchio`).

Determinism: :meth:`CampaignReport.canonical_json` is the byte-stable
view — every wall-clock / host-dependent field (:data:`VOLATILE_KEYS`)
is stripped recursively and keys are sorted, so two runs of the same
spec on the same code produce IDENTICAL canonical bytes even though
their walls and measured round overheads differ.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

from repro_torch.campaign.spec import FILTER_AXES
from repro_torch.sim.engines import ENGINE_BACKENDS

#: fields excluded from the canonical (byte-stable) view: wall clocks,
#: measured overheads, host fingerprints, and tracebacks.
VOLATILE_KEYS = frozenset({
    "wall_s", "walls", "machine", "written_at", "campaign_wall_s",
    "workers", "traceback", "max_round_overhead_s",
    "mean_round_overhead_s", "mean_overhead_per_server_s", "trace_path",
})

#: |ΔVR| allowed between a "tolerance"-contract engine and its bitwise
#: reference on the same cell (the torch engine's 2pp bound, the one the
#: reference documents for its jax engine).
TOLERANCE_CONTRACT_VR = 0.02


def strip_volatile(obj):
    """Recursively drop :data:`VOLATILE_KEYS` from nested dicts/lists."""
    if isinstance(obj, dict):
        return {k: strip_volatile(v) for k, v in obj.items()
                if k not in VOLATILE_KEYS}
    if isinstance(obj, (list, tuple)):
        return [strip_volatile(v) for v in obj]
    return obj


def _contract(engine: str) -> str:
    entry = ENGINE_BACKENDS.get(engine)
    # metadata attribute exists on LazyEntry too — never loads the
    # torch backend
    return getattr(entry, "contract", "unknown")


@dataclass
class CampaignReport:
    """One campaign's aggregated result."""

    name: str
    quick: bool
    records: list = field(default_factory=list)
    masked: list = field(default_factory=list)      # (cell_id, reason)
    filtered: int = 0
    campaign_wall_s: float = 0.0
    workers: int = 0

    # ------------------------------------------------------------ views
    @property
    def ok(self) -> list:
        return [r for r in self.records if r.get("status") == "ok"]

    @property
    def failed(self) -> list:
        return [r for r in self.records if r.get("status") != "ok"]

    def payload(self) -> dict:
        """The section payload persisted as ``BENCH_torchcampaign.json``
        (wrap with :func:`repro_torch.campaign.benchio.bench_payload`)."""
        return {
            "campaign": self.name,
            "quick": self.quick,
            "n_cells": len(self.records),
            "n_ok": len(self.ok),
            "n_failed": len(self.failed),
            "n_masked": len(self.masked),
            "n_filtered": self.filtered,
            "campaign_wall_s": self.campaign_wall_s,
            "workers": self.workers,
            "masked": [list(m) for m in self.masked],
            "rows": self.records,
        }

    def canonical_json(self) -> str:
        """Byte-stable serialization: same spec + same code ⇒ identical
        bytes (volatile fields stripped, keys sorted)."""
        return json.dumps(strip_volatile(self.payload()), sort_keys=True,
                          indent=None, separators=(",", ":"))

    # ------------------------------------------------------ consistency
    def consistency_violations(self) -> list[str]:
        """Cross-engine / cross-control-plane disagreements among ok
        cells that differ ONLY on that axis: bitwise-contract engines
        must agree exactly, tolerance-contract engines within
        :data:`TOLERANCE_CONTRACT_VR`; control planes must agree
        exactly. Token-level engines are a different system and are
        never compared."""
        out: list[str] = []

        def group_by(drop_axis: str) -> dict:
            groups: dict = {}
            for r in self.ok:
                if _contract(r["engine"]) == "token-level":
                    continue
                key = tuple((a, r.get(a)) for a in FILTER_AXES
                            if a != drop_axis)
                key += (("options", json.dumps(r.get("options", []))),)
                groups.setdefault(key, []).append(r)
            return groups

        for grp in group_by("engine").values():
            refs = [r for r in grp if _contract(r["engine"]) == "bitwise"]
            if not refs:
                continue
            ref = refs[0]
            for r in grp:
                if r is ref:
                    continue
                dv = abs(r["violation_rate"] - ref["violation_rate"])
                contract = _contract(r["engine"])
                if contract == "bitwise" and dv != 0.0:
                    out.append(
                        f"bitwise engines disagree on {r['cell']}: "
                        f"VR {r['violation_rate']:.4f} vs "
                        f"{ref['engine']} {ref['violation_rate']:.4f}")
                elif contract == "tolerance" and dv > TOLERANCE_CONTRACT_VR:
                    out.append(
                        f"tolerance engine {r['engine']} off by "
                        f"{dv:.4f} VR (> {TOLERANCE_CONTRACT_VR}) on "
                        f"{r['cell']} vs {ref['engine']}")
        for grp in group_by("control_plane").values():
            ref = grp[0]
            for r in grp[1:]:
                if r["violation_rate"] != ref["violation_rate"]:
                    out.append(
                        f"control planes disagree on {r['cell']}: "
                        f"VR {r['violation_rate']:.4f} vs "
                        f"{ref['control_plane']} "
                        f"{ref['violation_rate']:.4f}")
        return out

    def gate_failures(self) -> list[str]:
        """Everything the CI gate fails on: failed cells, non-finite
        VRs, conservation violations, consistency disagreements."""
        out = [f"cell {r['cell']}: {r['status']}"
               + (f" ({r['error']})" if r.get("error") else "")
               for r in self.failed]
        for r in self.ok:
            vr = r.get("violation_rate")
            if vr is None or not math.isfinite(vr):
                out.append(f"cell {r['cell']}: non-finite VR {vr!r}")
            if r.get("requests_conserved") is False:
                out.append(f"cell {r['cell']}: request conservation "
                           f"violated")
        out.extend(self.consistency_violations())
        return out

    # -------------------------------------------------------- marginals
    def marginals(self) -> dict[str, dict]:
        """Per-axis mean-VR marginals over ok cells:
        ``{axis: {value: {mean_vr, n}}}``."""
        out: dict[str, dict] = {}
        for axis in FILTER_AXES:
            by_val: dict = {}
            for r in self.ok:
                by_val.setdefault(r.get(axis), []).append(
                    r["violation_rate"])
            out[axis] = {
                str(v): {"mean_vr": sum(vrs) / len(vrs), "n": len(vrs)}
                for v, vrs in sorted(by_val.items(), key=lambda kv:
                                     str(kv[0]))}
        return out

    # ----------------------------------------------------------- render
    def render(self) -> str:
        lines = [
            f"campaign {self.name!r} ({'quick' if self.quick else 'full'})"
            f": {len(self.ok)}/{len(self.records)} cells ok, "
            f"{len(self.masked)} masked, {self.filtered} filtered, "
            f"wall {self.campaign_wall_s:.1f}s "
            f"({self.workers} workers)",
            "",
        ]
        if self.records:
            cw = max(len(r["cell"]) for r in self.records)
            hdr = (f"{'cell':<{cw}}  {'status':<7}  {'VR':>7}  "
                   f"{'worst band':>10}  {'wall_s':>7}")
            lines += [hdr, "-" * len(hdr)]
            for r in self.records:
                if r.get("status") == "ok":
                    bands = r.get("band_fractions") or {}
                    worst = max(bands, key=bands.get) if bands else "-"
                    lines.append(
                        f"{r['cell']:<{cw}}  {'ok':<7}  "
                        f"{r['violation_rate']:>7.4f}  {worst:>10}  "
                        f"{r.get('wall_s', 0.0):>7.2f}")
                else:
                    lines.append(
                        f"{r['cell']:<{cw}}  {r['status']:<7}  "
                        f"{'-':>7}  {'-':>10}  {'-':>7}"
                        + (f"  {r['error']}" if r.get("error") else ""))
        token_rows = [r for r in self.ok if r.get("token_latency_bands")]
        if token_rows:
            lines += ["", "token-level latency p50/p95/p99 per tenant "
                          "class (s, real decode timelines):"]
            for r in token_rows:
                cells = "  ".join(
                    f"{cls} {b['p50']:.2f}/{b['p95']:.2f}/{b['p99']:.2f} "
                    f"(n={int(b['n'])})"
                    for cls, b in sorted(r["token_latency_bands"].items()))
                lines.append(f"  {r['cell']}: {cells}")
        lines += ["", "per-axis mean-VR marginals (ok cells):"]
        for axis, vals in self.marginals().items():
            if len(vals) < 2:
                continue
            cells = "  ".join(f"{v}={d['mean_vr']:.4f}(n={d['n']})"
                              for v, d in vals.items())
            lines.append(f"  {axis:<14} {cells}")
        fails = self.gate_failures()
        if fails:
            lines += ["", f"GATE FAILURES ({len(fails)}):"]
            lines += [f"  - {f}" for f in fails]
        return "\n".join(lines)


def build_report(name: str, records: list, *, quick: bool,
                 masked: list = (), filtered: int = 0,
                 campaign_wall_s: float = 0.0,
                 workers: int = 0) -> CampaignReport:
    """The executor-output → report constructor used by the CLI and
    tests."""
    return CampaignReport(name=name, quick=quick, records=list(records),
                          masked=list(masked), filtered=filtered,
                          campaign_wall_s=campaign_wall_s,
                          workers=workers)
