"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: ``repro_torch`` begins with ``repro``), no reference
(every ``bench/reference/*.py``, the hybrid fixture's too) loads anything
of the program, and nothing comes from the old ``benchmarks/`` folder."""
import json
import subprocess
import sys

from bench.tests.small import FIXTURE, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

_PROBE = r"""
import importlib, json, sys
from pathlib import Path
sys.path[:0] = [{root!r}, {src!r}]
for name in {mods!r}:
    importlib.import_module(name)
{extra}
files = [str(getattr(m, "__file__", "") or "") for m in list(sys.modules.values())]
print(json.dumps({{"mods": sorted(sys.modules), "files": files}}))
"""


def _loaded(mods, extra=""):
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"), mods=mods,
                         extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_and_metrics_load_no_jax_nor_the_jax_package():
    metrics = sorted(p.stem for p in (ROOT / "bench/metrics").glob("*.py")
                     if p.stem != "__init__")
    archs = sorted(p.stem for p in (ROOT / "bench/arch").glob("*.py")
                   if p.stem != "__init__")
    extra = ("from bench import harness, modules\n"
             f"for m in {metrics!r}: harness.load_metric(Path({str(ROOT)!r}), m)\n"
             f"for a in {archs!r}:\n"
             "    modules.program({'arch': a}).program_config\n"
             "    modules.reference({'arch': a}).logits_at\n"
             "import runpy\n"
             f"runpy.run_path({str(ROOT / 'bench/run.py')!r}, run_name='probe')\n"
             "from bench import harness\n"
             "from repro_torch.serving.engine import MultiTenantEngine\n")
    got = _loaded(["bench.harness", "bench.check", "bench.tracing",
                   "bench.reference.model", "bench.reference.weights",
                   "bench.sweep", "bench.calibrate"], extra)
    bad = [m for m in got["mods"] if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert "repro_torch" in got["mods"]
    old = str(ROOT / "benchmarks")
    assert not [f for f in got["files"] if f.startswith(old + "/")]
    assert "benchmarks" not in {m.split(".")[0] for m in got["mods"]}


def test_reference_loads_nothing_of_the_program():
    refs = sorted(p for p in [*(ROOT / "bench/reference").glob("*.py"),
                              *(FIXTURE / "bench/reference").glob("*.py")])
    assert len(refs) >= 5
    extra = ("from bench import modules\n"
             f"for i, p in enumerate({[str(p) for p in refs]!r}):\n"
             "    modules.load(Path(p), f'probe_ref{i}')\n")
    got = _loaded(["bench.reference.weights"], extra)
    tops = {m.split(".")[0] for m in got["mods"]}
    assert not tops & {"repro_torch", *FORBIDDEN}
    assert {"bench.reference.model", "bench.reference.weights"} <= \
        set(got["mods"])


def test_harness_refuses_a_forbidden_module_loaded_by_then():
    from bench import harness
    sys.modules["jax_probe_not_jax"] = sys
    try:
        assert "jax_probe_not_jax" not in harness.forbidden_modules()
        sys.modules["jax"] = sys
        assert "jax" in harness.forbidden_modules()
    finally:
        sys.modules.pop("jax", None)
        sys.modules.pop("jax_probe_not_jax", None)
