"""Collate dry-run JSONs into the §Dry-run / §Roofline tables (the JAX
package's ``benchmarks/roofline_report.py``; the port's dry-run writes
under ``results/torch_dryrun``).

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline_report [single|multi]
"""
from __future__ import annotations

import glob
import json
import os

OUT = "results/torch_dryrun"


def load_results(out_dir=OUT, mesh="single", tag=None):
    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("mesh") != mesh:
            continue
        if tag and r.get("tag") not in (tag, "extrapolated"):
            continue
        rows.append(r)
    return rows


def roofline_table(out_dir=OUT, mesh="single"):
    rows = load_results(out_dir, mesh)
    out = []
    for r in rows:
        if r.get("status") == "skipped":
            out.append({"arch": r["arch"], "shape": r["shape"],
                        "status": "skipped (full attention, see DESIGN.md)"})
            continue
        if r.get("status") != "ok":
            out.append({"arch": r["arch"], "shape": r["shape"],
                        "status": f"ERROR: {r.get('error', '?')[:80]}"})
            continue
        out.append({
            "arch": r["arch"], "shape": r["shape"], "tag": r.get("tag"),
            "status": "ok",
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "dominant": r["dominant"],
            "useful_flops_frac": r.get("useful_flops_frac"),
            "roofline_frac": r.get("roofline_frac"),
        })
    return out


def markdown_table(rows):
    cols = ["arch", "shape", "compute_s", "memory_s", "collective_s",
            "dominant", "useful_flops_frac", "roofline_frac", "status"]
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "|".join(["---"] * len(cols)) + "|"]
    for r in rows:
        vals = []
        for c in cols:
            v = r.get(c)
            if isinstance(v, float):
                v = f"{v:.4g}"
            vals.append(str(v) if v is not None else "—")
        lines.append("| " + " | ".join(vals) + " |")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    mesh = sys.argv[1] if len(sys.argv) > 1 else "single"
    print(markdown_table(roofline_table(mesh=mesh)))
