"""Insert the roofline table + perf log into the markers of a markdown
file (the JAX package's ``benchmarks/fill_experiments.py``, on the
port's ``results/torch_dryrun`` and ``results/torch_hillclimb``).

  PYTHONPATH=src python -m repro_torch.benchmarks.fill_experiments \\
      [EXPERIMENTS.md]

Replaces ``<!-- ROOFLINE_TABLE -->`` with the single-mesh roofline
table and the multi-pod coherence count, and ``<!-- PERF_LOG -->``
with the hillclimb report.
"""
from __future__ import annotations

import re
import sys


def fill(path: str = "EXPERIMENTS.md") -> None:
    from repro_torch.benchmarks.hillclimb import report as hillclimb_report
    from repro_torch.benchmarks.roofline_report import (OUT, markdown_table,
                                                        roofline_table)

    with open(path) as f:
        text = f.read()

    table = markdown_table(roofline_table(mesh="single"))
    multi = roofline_table(mesh="multi")
    ok_multi = sum(1 for r in multi if r.get("status") == "ok")
    skip_multi = sum(1 for r in multi
                     if str(r.get("status", "")).startswith("skipped"))
    table += (f"\n\nMulti-pod (2×16×16 = 512 chips) coherence pass: "
              f"**{ok_multi} cells compiled OK, {skip_multi} recorded skips** "
              f"(scan-layers mode; per-cell JSON in {OUT}/*multi*).")

    text = re.sub(r"<!-- ROOFLINE_TABLE -->", lambda m: table, text)
    try:
        perf = hillclimb_report()
    except Exception as e:
        perf = f"(hillclimb results pending: {e})"
    text = re.sub(r"<!-- PERF_LOG -->", lambda m: perf, text)

    with open(path, "w") as f:
        f.write(text)
    print(f"{path} updated")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    fill(argv[0] if argv else "EXPERIMENTS.md")


if __name__ == "__main__":
    main()
