"""The port's benchmark runner and bench sections against the JAX
package's (CPU).

``repro_torch.benchmarks`` carries the reference's ``benchmarks``
package over; ``torch_scale_sweep`` (section ``scale``) takes the place
of ``jax_scale_sweep`` (``jaxscale``) and every section that runs the
torch or serving engine takes a ``device``. On the CPU the numpy
sections equal the reference's exactly; the torch engine (its kernels'
plain versions) is within 1e-3 VR of the reference's jax engine on the
same stream fleet and within the sweep's own 0.02 of batched. The
runner writes only ``BENCH_torch*.json``, and in quick mode none."""
import json
import math
from pathlib import Path

import pytest
import torch

from benchmarks import federation_bench as RF
from benchmarks import paper_figs as RP
from repro_torch.benchmarks import campaign as PC
from repro_torch.benchmarks import federation_bench as PF
from repro_torch.benchmarks import paper_figs as PP
from repro_torch.benchmarks import run as PRUN
from repro_torch.benchmarks import serving_bench as PS

ROOT = Path(__file__).resolve().parents[1]
CPU_VR_TOL = 1e-3           # torch engine on the CPU vs the reference's jax


def _root_bench_files() -> list[str]:
    return sorted(p.name for p in ROOT.glob("BENCH_*.json"))


def test_torch_scale_sweep_quick_on_cpu_equals_reference():
    """The quick row: its own |ΔVR| ≤ 0.02 assert holds, batched equals
    the reference's batched, torch is within 1e-3 of jax."""
    rows = PF.torch_scale_sweep(quick=True, device="cpu")
    ref = RF.jax_scale_sweep(quick=True)
    assert len(rows) == len(ref) == 1
    for got, want in zip(rows, ref):
        assert got["device"] == "cpu"
        for k in ("workload", "n_nodes", "tenants_per_node", "duration_s",
                  "round_interval", "policy", "tenant_seconds"):
            assert got[k] == want[k], k
        assert math.isfinite(got["torch_vr"])
        assert abs(got["vr_delta"]) <= 0.02
        assert got["batched_vr"] == want["batched_vr"]
        assert abs(got["torch_vr"] - want["jax_vr"]) <= CPU_VR_TOL
        assert got["torch_wall_s"] > 0 and got["batched_wall_s"] > 0


def test_torch_scale_sweep_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PF.torch_scale_sweep(quick=True)


def test_torch_scale_sweep_vr_bound_is_enforced(monkeypatch):
    """A divergent engine fails the sweep instead of persisting a row."""
    real = PF._fleet_fed

    def skewed(*args, **kw):
        fed = real(*args, **kw)
        if args[6] == "torch":
            run = fed.run

            def run_skewed():
                res = run()
                res.violation_rate += 0.05
                return res
            fed.run = run_skewed
        return fed

    monkeypatch.setattr(PF, "_fleet_fed", skewed)
    with pytest.raises(AssertionError, match="VR divergence"):
        PF.torch_scale_sweep(quick=True, device="cpu")


def test_run_quick_writes_nothing_at_the_root(tmp_path, monkeypatch):
    before = _root_bench_files()
    monkeypatch.chdir(tmp_path)
    PRUN.main(["--quick", "--only", "fig2,scale", "--device", "cpu"])
    assert not list(tmp_path.glob("BENCH_*"))
    assert _root_bench_files() == before
    results = json.loads((tmp_path / "results" /
                          "torch_benchmarks.json").read_text())
    assert set(results) == {"fig2", "fig2x", "scale"}
    assert results["scale"][0]["device"] == "cpu"


def test_run_full_mode_persists_only_port_files(tmp_path, monkeypatch):
    """Full mode writes ``BENCH_torch<section>.json`` (here with a
    stubbed sweep) and never a reference file name."""
    row = {"workload": "stream", "n_nodes": 1, "tenants_per_node": 1,
           "round_interval": 1, "policy": "none", "tenant_seconds": 1,
           "torch_wall_s": 1.0, "torch_ts_per_s": 1.0,
           "batched_ts_per_s": 1.0, "speedup_torch_vs_batched": 1.0,
           "device": "cpu", "vr_delta": 0.0}
    monkeypatch.setattr(PF, "torch_scale_sweep",
                        lambda quick, device: [dict(row, device=device)])
    monkeypatch.chdir(tmp_path)
    PRUN.main(["--only", "scale", "--device", "cpu"])
    assert sorted(p.name for p in tmp_path.glob("BENCH_*")) == [
        "BENCH_torchscale.json"]
    payload = json.loads((tmp_path / "BENCH_torchscale.json").read_text())
    assert payload["section"] == "scale"
    assert payload["rows"][0]["device"] == "cpu"


def test_fig3_timeline_equals_reference():
    assert PP.fig3_timeline() == RP.fig3_timeline()


def test_fig2_rows_match_reference_shape():
    got = PP.fig2_priority_scaling_to_1024(device="cpu")
    ref = RP.fig2_priority_scaling_to_1024()
    assert [r["tenants"] for r in got] == [r["tenants"] for r in ref]
    assert all(r["score_update_us"] > 0 for r in got)


def test_forecast_sweep_quick_equals_reference():
    """A bench section over a registry grid: VRs, latencies and counts
    equal the reference's (walls and overheads aside)."""
    def strip(rows):
        return [{k: v for k, v in r.items()
                 if "wall" not in k and "overhead" not in k} for r in rows]
    assert strip(PF.forecast_sweep(quick=True, device="cpu")) == \
        strip(RF.forecast_sweep(quick=True))


def test_serving_federation_on_cpu_equals_reference_trajectory():
    """The serving bench's outcomes on the CPU, two runs, equal the
    reference's committed ``BENCH_serving.json`` rows (read only):
    outcomes depend on the virtual clock and token counts alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny tensors: threads only add overhead
    try:
        rows = PS.serving_federation(device="cpu", repeats=2)
    finally:
        torch.set_num_threads(threads)
    ref = json.loads((ROOT / "BENCH_serving.json").read_text())["rows"]
    keys = ("scenario", "policy", "violation_rate", "total_requests",
            "completed", "cloud_requests", "tokens", "failovers")
    assert [{k: r[k] for k in keys} for r in rows] == \
        [{k: r[k] for k in keys} for r in ref]
    assert all(r["repeats"] == 2 and r["device"] == "cpu" for r in rows)


def test_campaign_cli_lists_the_reference_cells(capsys):
    from benchmarks import campaign as RC

    assert PC.main(["--dry-run"]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if not ln.startswith("#")]
    assert RC.main(["--dry-run"]) == 0
    ref = [ln for ln in capsys.readouterr().out.splitlines()
           if not ln.startswith("#")]
    assert got == [ln.replace("/jax/", "/torch/") for ln in ref]
    assert any("/torch/" in ln for ln in got)


def test_campaign_cli_quick_on_cpu(tmp_path):
    """The CLI gate end to end on a small campaign: exit 0, the report
    persisted under the port's name only."""
    rc = PC.main(["--campaign", "forecast", "--quick", "--workers", "0",
                  "--device", "cpu", "--root", str(tmp_path)])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.glob("BENCH_*")) == [
        "BENCH_torchcampaign.json"]
    payload = json.loads((tmp_path / "BENCH_torchcampaign.json").read_text())
    assert payload["n_cells"] == payload["n_ok"] > 0


@pytest.mark.cuda
def test_cuda_fanout_from_a_parent_holding_a_context():
    """On the card: the torch cells of the ci campaign fanned out from a
    parent that has initialised CUDA end ok, within 1e-3 VR of the same
    cells run inline on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py covers the card)")
    import repro_torch.campaign as P
    from repro_torch.campaign.registry import TORCH_GRID

    torch.zeros(1, device="cuda")
    assert torch.cuda.is_initialized()
    cells = P.expand_grid(TORCH_GRID)[0]
    fan = P.run_cells(P.on_device(cells, "cuda"), quick=True, workers=2,
                      cell_timeout_s=600.0)
    cpu = P.run_cells(P.on_device(cells, "cpu"), quick=True, workers=0)
    for g, c in zip(fan, cpu):
        assert g["status"] == "ok", g
        assert abs(g["violation_rate"] - c["violation_rate"]) <= CPU_VR_TOL
