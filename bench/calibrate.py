"""Readings for the limit of ``correct``: the program's widest logit gap
and the control's, on several seeds, in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 20]

Each seed is a whole run of the cell at its own load and sizes (a
shorter window, long enough to finish its longest requests), followed by
the reference and the control (the reference in float8 products) on
the same sample. One JSON line a seed. The benchmark's own runs never
read the control."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch

    from bench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", type=int, default=1)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    for seed in (int(x) for x in a.seeds.split(",")):
        out = harness.run(ROOT, a.workload, seed, a.seconds, False,
                          t_start=time.perf_counter(),
                          control=bool(a.control),
                          log=lambda m: print(m, file=sys.stderr, flush=True))
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "program": out["samples"]["gaps"],
                          "control": out.get("control"),
                          "samples": out["samples"],
                          "metrics": {k: v["value"] for k, v
                                      in out["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
