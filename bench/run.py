"""Run one cell of the benchmark once and print its result's line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``; ``checks`` last: each number compared beside its
limit, which also close standard error). Exits non-zero, printing no
result, without a CUDA device, or when JAX or the JAX package is
loaded once the window has closed. The kernels' build directory and
every cache stay inside the checkout."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
os.environ["REPRO_TORCH_BUILD_DIR"] = str(BUILD / "repro_torch")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch
    from bench import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == a.workload),
                None)
    if cell is None:
        print(f"unknown workload {a.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run(ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                      t_start=T_START,
                      log=lambda m: print(m, file=sys.stderr, flush=True))
    s = out["samples"]
    print("[samples] " + " ".join(f"{k}={v}" for k, v in s.items()))
    for k, v in out["checks"].items():
        print(f"[check] {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
