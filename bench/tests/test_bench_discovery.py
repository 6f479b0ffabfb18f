"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and new entries, and the harness finds each by its
name; no file the benchmark has is edited."""
import json
import shutil

from bench import harness, traffic
from bench.record import Record
from bench.tests.small import ROOT, run


def _copy(tmp_path):
    dst = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def _digest(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted((root / "bench").rglob("*")) if p.is_file()}


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = _copy(tmp_path)
    before = _digest(root)
    cfg = json.loads((root / "bench/configs/granite-8b.json").read_text())
    (root / "bench/configs/granite-8b-b.json").write_text(
        json.dumps({**cfg, "name": "granite-8b-b"}))
    t = json.loads((root / "bench/traffic/granite.code.json").read_text())
    (root / "bench/traffic/granite.burst.json").write_text(
        json.dumps({**t, "rate_per_s": 2.5}))
    (root / "bench/metrics/steps_per_s.py").write_text(
        "def read(rec):\n"
        "    w0, w1 = rec.window\n"
        "    return len(rec.in_window(rec.steps)) / (w1 - w0)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({**spec["configs"][1], "name": "granite-8b-b",
                            "file": "bench/configs/granite-8b-b.json"})
    spec["workloads"].append({"name": "granite.burst",
                              "config": "granite-8b-b",
                              "traffic": "granite.burst", "chips": 1,
                              "why": "a test cell"})
    spec["per_layer"].append({"name": "steps_per_s", "unit": "1/s",
                              "better": "higher", "source": "program_span",
                              "layer": "engine", "moves": "tpot_p95_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    _, entry, c, tt = harness.load_spec(root, "granite.burst")
    assert c["name"] == "granite-8b-b" and tt["rate_per_s"] == 2.5
    assert traffic.load(root, "granite.burst") == tt
    read = harness.load_metric(root, "steps_per_s")
    rec = Record("granite.burst", c, (0.0, 2.0), 2.0, [],
                 steps=[(0.1, 0.2), (0.5, 0.6), (2.5, 2.6)])
    assert read(rec) == 1.0
    out = run("granite.burst", 4, root=root)
    assert out["correct"] and out["attempted"] == round(4.0 * 3.0)
    after = _digest(root)
    assert all(after[p] == b for p, b in before.items())
