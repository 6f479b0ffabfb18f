"""A later change adds a configuration, a traffic mix, a per-layer
metric, or a whole architecture with a reader of the program's own
events, as new files and new entries, and the harness finds each by its
name; no file the benchmark has is edited."""
import json
import shutil

import pytest

from bench import harness, modules, traffic
from bench.record import Record
from bench.tests.small import FIXTURE, HYBRID, ROOT, TRAFFIC, run


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


def test_new_architecture_and_event_reader_are_found_by_name(tmp_path):
    """The hybrid family (Mamba-2 layers, one shared attention block every
    ``attn_every``): its program module, plain reference and counts, a
    configuration, a traffic mix, and a reader of the program's decode
    spans, copied in from ``fixtures/hybrid`` as new files."""
    import torch
    root = _copy(tmp_path)
    before = _digest(root)
    added = [p.relative_to(FIXTURE) for p in sorted(FIXTURE.rglob("*"))
             if p.is_file() and "__pycache__" not in p.parts]
    for rel in added:
        assert not (root / rel).exists(), rel
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(FIXTURE / rel, root / rel)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "zamba2-2.7b",
                            "source": "https://huggingface.co/Zyphra/Zamba2-2.7B",
                            "file": "bench/configs/zamba2-2.7b.json",
                            "reduced": [], "why": "a test configuration"})
    spec["workloads"].append({"name": "zamba2.chat", "config": "zamba2-2.7b",
                              "traffic": "zamba2.chat", "chips": 1,
                              "why": "a test cell"})
    spec["per_layer"].append({"name": "eager_decode_steps", "unit": "steps",
                              "better": "lower", "source": "program_span",
                              "layer": "engine", "moves": "tpot_p50_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    _, _, cfg, _ = harness.load_spec(root, "zamba2.chat")
    arch = modules.program(cfg, root)
    for c in (cfg, {**cfg, **HYBRID}):
        assert arch.attention_layers(c) == \
            c["num_hidden_layers"] / c["attn_every"] < c["num_hidden_layers"]
    out = run("zamba2.chat", 4, cfg=HYBRID, root=root)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == round(4.0 * 3.0)

    # the reader, on a record that carries the program's events
    torch.set_num_threads(2)
    s = harness.Setup(root, "zamba2.chat", 5, device="cpu", cfg_over=HYBRID,
                      traffic_over=TRAFFIC)
    reqs = traffic.generate(s.t, 3.0, s.traffic_ss, s.cfg["vocab_size"])
    rec = harness.open_loop(s, reqs, 3.0, events=True)
    read = harness.load_metric(root, "eager_decode_steps")
    assert read(rec) == len(rec.untraced(rec.decodes)) > 0
    after = _digest(root)
    assert all(after[p] == b for p, b in before.items())


@pytest.mark.parametrize("arch,said", [(None, 'no "arch" key'),
                                       ("mamba", '"arch" \'mamba\' names no'),
                                       ("../metrics/mfu", "names no")])
def test_a_configuration_without_its_architecture_stops_the_run(arch, said):
    cfg = {"name": "x"} if arch is None else {"name": "x", "arch": arch}
    for load in (modules.program, modules.reference):
        with pytest.raises(SystemExit, match=said):
            load(cfg)
