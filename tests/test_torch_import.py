"""The port stands alone: importing ``repro_torch`` (the sim path, the
serving path, the campaign harness, the benchmarks, the training path,
the sharding layer and the examples) loads neither jax nor the JAX
package, no port source
imports either, and the GPU engine refuses to run without a card unless
the caller asks for the CPU."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import sys
import repro_torch, repro_torch.sim, repro_torch.core, repro_torch.obs
import repro_torch.kernels.fleet
import repro_torch.sim.engines.torch_backend
import repro_torch.kernels.attention, repro_torch.models
import repro_torch.serving.engine, repro_torch.serving.federation
import repro_torch.launch.serve, repro_torch.configs
import repro_torch.campaign, repro_torch.benchmarks.run
import repro_torch.benchmarks.campaign, repro_torch.benchmarks.federation_bench
import repro_torch.benchmarks.serving_bench, repro_torch.benchmarks.paper_figs
import repro_torch.training.optimizer, repro_torch.training.train_step
import repro_torch.training.checkpoint, repro_torch.data.pipeline
import repro_torch.parallel.compression, repro_torch.launch.train
import repro_torch.parallel.sharding, repro_torch.launch.mesh
import repro_torch.launch.specs
import repro_torch.examples.quickstart, repro_torch.examples.train_100m
import repro_torch.examples.elastic_restart
import repro_torch.examples.multitenant_serve
import repro_torch.examples.federation_demo
import torch.distributed
assert not torch.distributed.is_initialized()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(",".join(bad))
"""

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
    r"|from\s+repro\b(?!_))", re.M)


def test_import_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ""


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PORT.rglob("*.py"))
    + [ROOT / "chip_smoke.py"]))
def test_source_imports_neither_jax_nor_reference(path):
    src = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(src), path
    assert not re.search(r"\bfrom repro\.|\bimport repro\b(?!_)", src), path


def test_torch_engine_without_cuda_raises(monkeypatch):
    from repro_torch.sim import SCENARIOS, run_scenario

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = dataclasses.replace(SCENARIOS["paper_face_detection"],
                             engine="torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_scenario(sc, quick=True)
    # an explicit GPU device is refused the same way
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario(dataclasses.replace(
            sc, backend_options={"device": "cuda:0"}), quick=True)


def test_train_launcher_without_cuda_raises(monkeypatch):
    from repro_torch.launch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--reduced", "--steps", "1", "--device", "cuda:0"])


def test_kernel_wrappers_refuse_mixed_devices():
    from repro_torch.kernels import fleet

    a = torch.zeros(4, dtype=torch.float32)
    with pytest.raises(ValueError):
        fleet.latency_scale(a, a, torch.zeros((4, 2)), a.to(torch.float64))
