"""The port's campaign harness against the JAX package's (CPU).

``repro_torch.campaign`` carries ``repro.campaign`` over as numpy, with
``"torch"`` in place of ``"jax"`` on the engine axis and ``scale_kernel``
in place of ``pallas``/``use_pallas``. So, on the same specs:

* every campaign expands to the reference's cells and masks, under
  that renaming;
* records of the numpy engines' cells equal the reference's field by
  field (volatile fields stripped), and a numpy-only report's canonical
  JSON is byte-equal;
* the torch engine's cells on ``device="cpu"`` are within 1e-3 VR of the
  reference's jax cells (``paper_face_detection`` is a stream fleet;
  PERF.md §2), and the serving cells' records equal the reference's;
* fault isolation, the BENCH I/O and the differ behave as the
  reference's tests say (tests/test_campaign.py), with the port's file
  names (``BENCH_torch*.json``) and its start method (never a fork of
  the caller)."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.campaign as R
import repro.campaign.registry as RR
import repro_torch.campaign as P
import repro_torch.campaign.registry as PR
import torch_campaign_cells as cells_fn
from repro_torch.campaign import executor
from repro_torch.campaign.benchio import SCHEMA_VERSION
from repro_torch.campaign.diff import TRAJECTORY_SECTIONS
from repro_torch.campaign.report import strip_volatile
from repro_torch.campaign.spec import OPTION_ENGINES

ROOT = Path(__file__).resolve().parents[1]
CPU_VR_TOL = 1e-3           # torch engine on the CPU vs the reference's jax
OPTION_NAMES = {"pallas": "scale_kernel", "use_pallas": "scale_kernel"}

TINY = dict(scenarios=("paper_game_32",), engines=("vectorized", "batched"),
            policies=("sdps",), scaling_policies=("reactive",))
P_TINY = P.SweepGrid(**TINY)


def _ported_key(key: tuple) -> tuple:
    """A reference cell key under ``jax`` -> ``torch`` and the option
    renaming."""
    *axes, options = key
    axes[1] = "torch" if axes[1] == "jax" else axes[1]
    return (*axes, tuple((OPTION_NAMES.get(k, k), v) for k, v in options))


def _ported_text(s: str) -> str:
    for a, b in OPTION_NAMES.items():
        s = s.replace(f"'{a}'", f"'{b}'").replace(f"+{a}=", f"+{b}=")
    return s.replace("/jax/", "/torch/").replace("jax", "torch")


# ------------------------------------------------------------ expansion
@pytest.mark.parametrize("name", sorted(RR.CAMPAIGNS))
def test_campaign_cells_equal_reference(name):
    """Cell keys, cell ids, masked cells and their reasons."""
    assert sorted(PR.CAMPAIGNS) == sorted(RR.CAMPAIGNS)
    ref, ref_masked, ref_filtered = R.expand_campaign(
        RR.CAMPAIGNS[name], verbose=True)
    got, masked, filtered = P.expand_campaign(PR.CAMPAIGNS[name],
                                              verbose=True)
    assert [c.key for c in got] == [_ported_key(c.key) for c in ref]
    assert [c.cell_id for c in got] == [_ported_text(c.cell_id)
                                        for c in ref]
    assert masked == [(_ported_text(c), _ported_text(why))
                      for c, why in ref_masked]
    assert filtered == ref_filtered


def test_masking_never_emits_invalid_cells():
    cells, masked = P.expand_grid(PR.MAIN_GRID)
    for cell in cells:
        serving_sc = cell.scenario.serving is not None
        assert serving_sc == (cell.engine == "serving"), cell.cell_id
        if cell.engine == "serving":
            assert cell.scaling_policy == "reactive"
            assert cell.control_plane == "array"
    assert masked, "the main grid must mask something"
    emitted = {c.cell_id for c in cells}
    assert emitted.isdisjoint({cid for cid, _ in masked})


def test_masking_engine_options():
    grid = P.SweepGrid(scenarios=("paper_game_32",),
                       engines=("vectorized", "batched", "torch"),
                       policies=("sdps",), scaling_policies=("reactive",),
                       backend_options=((), (("scale_kernel", True),),
                                        (("jit_scale", 4),),
                                        (("device", "cpu"),)))
    cells, masked = P.expand_grid(grid)
    for cell in cells:
        for k, _ in cell.options:
            assert cell.engine in OPTION_ENGINES[k], cell.cell_id
    # every (engine, option) combination outside the table was masked
    assert any("scale_kernel" in cid for cid, _ in masked)
    assert any("jit_scale" in cid for cid, _ in masked)
    assert any("device" in cid and "/batched/" in cid for cid, _ in masked)
    assert not any("scale_kernel" in c.cell_id and c.engine != "torch"
                   for c in cells)


def test_masking_engine_options_equal_reference():
    """The option table masks the same cells as the reference's, with
    ``pallas`` read as ``scale_kernel``."""
    kw = dict(scenarios=("paper_game_32",), policies=("sdps",),
              scaling_policies=("reactive",))
    ref, ref_masked = R.expand_grid(R.SweepGrid(
        engines=("vectorized", "batched", "jax"),
        backend_options=((), (("pallas", True),), (("jit_scale", 4),)),
        **kw))
    got, masked = P.expand_grid(P.SweepGrid(
        engines=("vectorized", "batched", "torch"),
        backend_options=((), (("scale_kernel", True),),
                         (("jit_scale", 4),)), **kw))
    assert [c.key for c in got] == [_ported_key(c.key) for c in ref]
    assert masked == [(_ported_text(c), _ported_text(why))
                      for c, why in ref_masked]


def test_filters_and_zero_cell_error():
    spec = P.CampaignSpec(name="t", grids=(P_TINY,),
                          include=({"engine": "batched"},))
    assert [c.engine for c in P.expand_campaign(spec)] == ["batched"]
    with pytest.raises(ValueError, match="zero cells"):
        P.expand_campaign(P.CampaignSpec(
            name="t0", grids=(P_TINY,),
            exclude=({"scenario": "paper_game_32"},)))


def test_on_device_leaves_cell_identity():
    """The device goes on the scenario of each torch and serving cell,
    never into the cell's options: ids and keys stay the reference's."""
    cells = P.expand_campaign(PR.CAMPAIGNS["ci"])
    placed = P.on_device(cells, "cpu")
    assert [c.key for c in placed] == [c.key for c in cells]
    assert [c.cell_id for c in placed] == [c.cell_id for c in cells]
    for c in placed:
        opts = c.scenario_with_axes().backend_options
        assert (opts.get("device") == "cpu") == (c.engine in
                                                 ("torch", "serving"))
    assert {c.engine for c in placed} >= {"torch", "serving", "batched"}


# -------------------------------------------------------------- records
#: the numpy engines' grids of the ci campaign (serving cells left out)
NUMPY_GRIDS = ("MAIN_GRID", "CTRL_GRID", "ENGINE_GRID_QUICK")


def _numpy_cells(pkg, registry, grid):
    cells, _ = pkg.expand_grid(getattr(registry, grid))
    return [c for c in cells if c.engine != "serving"]


@pytest.fixture(scope="module")
def numpy_records():
    return {grid: (R.run_cells(_numpy_cells(R, RR, grid), quick=True,
                               workers=0),
                   P.run_cells(_numpy_cells(P, PR, grid), quick=True,
                               workers=0))
            for grid in NUMPY_GRIDS}


@pytest.mark.parametrize("grid", NUMPY_GRIDS)
def test_numpy_cell_records_equal_reference(numpy_records, grid):
    ref, got = numpy_records[grid]
    assert len(got) == len(ref) > 0
    for r, g in zip(ref, got):
        assert g["status"] == "ok", g
        assert strip_volatile(g) == strip_volatile(r), g["cell"]


def test_numpy_report_canonical_json_byte_equal(numpy_records):
    ref = [r for grid in NUMPY_GRIDS for r in numpy_records[grid][0]]
    got = [r for grid in NUMPY_GRIDS for r in numpy_records[grid][1]]
    a = R.build_report("numpy", ref, quick=True, workers=0)
    b = P.build_report("numpy", got, quick=True, workers=0)
    assert b.canonical_json() == a.canonical_json()
    assert b.gate_failures() == [] == a.gate_failures()


def test_torch_grid_on_cpu_within_tolerance_of_jax():
    ref = R.run_cells(R.expand_grid(RR.JAX_GRID)[0], quick=True, workers=0)
    cells = P.on_device(P.expand_grid(PR.TORCH_GRID)[0], "cpu")
    got = P.run_cells(cells, quick=True, workers=0)
    assert [g["cell"] for g in got] == [_ported_text(r["cell"])
                                        for r in ref]
    for r, g in zip(ref, got):
        assert g["status"] == "ok", g
        if g["engine"] == "batched":
            assert strip_volatile(g) == strip_volatile(r)
        else:
            assert abs(g["violation_rate"] - r["violation_rate"]) \
                <= CPU_VR_TOL, (g["cell"], g["violation_rate"],
                                r["violation_rate"])
    rep = P.build_report("torch", got, quick=True)
    assert rep.consistency_violations() == []
    assert rep.gate_failures() == []


#: both serving scenarios, one policy each (the other two ci cells take
#: the reference ~16 s more; tests/test_torch_serving_federation.py
#: holds every policy of both scenarios to the reference)
SERVING_CELLS = ("serving_edge_pair/serving/array/least_loaded/none/",
                 "serving_timeout_retry/serving/array/least_loaded/sdps/")


def test_serving_cells_on_cpu_equal_reference():
    ref = [c for c in R.expand_grid(RR.MAIN_GRID)[0]
           if c.cell_id.startswith(SERVING_CELLS)]
    cells = [c for c in P.on_device(P.expand_grid(PR.MAIN_GRID)[0], "cpu")
             if c.cell_id.startswith(SERVING_CELLS)]
    assert len(cells) == len(ref) == 2
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny tensors: threads only add overhead
    try:
        got = P.run_cells(cells, quick=True, workers=0)
    finally:
        torch.set_num_threads(threads)
    want = R.run_cells(ref, quick=True, workers=0)
    for r, g in zip(want, got):
        assert g["status"] == "ok", g
        assert strip_volatile(g) == strip_volatile(r), g["cell"]


def test_torch_cell_without_cuda_is_an_error(monkeypatch):
    """A torch cell asked to run on the card without one fails as an
    ``error`` record; it is not re-run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cells = [c for c in P.on_device(P.expand_grid(PR.TORCH_GRID)[0],
                                    "cuda") if c.engine == "torch"]
    recs = P.run_cells(cells[:1], quick=True, workers=0)
    assert recs[0]["status"] == "error"
    assert "CUDA is not available" in recs[0]["error"]
    rep = P.build_report("t", recs, quick=True)
    assert any("error" in f for f in rep.gate_failures())


# ---------------------------------------------------------- determinism
def test_byte_identical_report():
    """Same grid + seed ⇒ byte-identical canonical CampaignReport —
    across process fan-out AND inline execution, despite differing
    wall clocks."""
    cells = P.expand_campaign(P.CampaignSpec(name="tiny", grids=(P_TINY,)))
    reports = []
    for workers in (2, 0):
        recs = P.run_cells(cells, quick=True, workers=workers,
                           cell_timeout_s=300.0)
        reports.append(P.build_report(
            "tiny", recs, quick=True, workers=workers,
            campaign_wall_s=float(workers)))
    assert all(r["status"] == "ok" for rep in reports for r in rep.records)
    assert reports[0].canonical_json() == reports[1].canonical_json()
    assert reports[0].consistency_violations() == []
    assert reports[0].gate_failures() == []


def test_fanout_after_the_rng_pool_started():
    """The reference's flaky byte-identity test (ROADMAP §3, C2) hangs
    when a batched run in the same process has started the simulator's
    process-wide RNG thread pool (``sim/edgesim.py`` ``_rng_pool``): a
    forked child inherits the pool without its threads, and its first
    jitter fill waits forever (a ``timeout`` record). The port's
    children are not forks of the caller, so the pool does not follow
    them."""
    from repro_torch.sim import edgesim

    grid = P.SweepGrid(scenarios=("paper_game_32",), engines=("batched",),
                       policies=("sdps",), scaling_policies=("reactive",))
    cells = P.expand_campaign(P.CampaignSpec(name="pool", grids=(grid,)))
    inline = P.run_cells(cells, quick=True, workers=0)
    assert any(pool._threads for pool in edgesim._RNG_POOLS.values())
    fan = P.run_cells(cells, quick=True, workers=2, cell_timeout_s=60.0)
    assert fan[0]["status"] == "ok", fan
    assert strip_volatile(fan) == strip_volatile(inline)


# ------------------------------------------------------- fault isolation
def _tiny_cells():
    cells = P.expand_campaign(P.CampaignSpec(name="t", grids=(P_TINY,)))
    assert len(cells) == 2
    return cells


def test_raising_cell_does_not_abort_siblings():
    cells = _tiny_cells()
    recs = P.run_cells(cells, quick=True, workers=2, cell_timeout_s=60.0,
                       cell_fn=cells_fn.raise_on_batched)
    by_engine = {r["engine"]: r for r in recs}
    assert by_engine["vectorized"]["status"] == "ok"
    assert by_engine["batched"]["status"] == "error"
    assert "boom" in by_engine["batched"]["error"]
    # records come back in cell order regardless of finish order
    assert [r["cell"] for r in recs] == [c.cell_id for c in cells]


def test_crashing_cell_recorded_not_fatal():
    recs = P.run_cells(_tiny_cells(), quick=True, workers=2,
                       cell_timeout_s=60.0,
                       cell_fn=cells_fn.crash_on_batched)
    by_engine = {r["engine"]: r for r in recs}
    assert by_engine["vectorized"]["status"] == "ok"
    assert by_engine["batched"]["status"] == "crash"
    assert by_engine["batched"]["exitcode"] == 3


def test_timeout_cell_recorded_not_fatal():
    recs = P.run_cells(_tiny_cells(), quick=True, workers=2,
                       cell_timeout_s=10.0, cell_fn=cells_fn.hang_on_batched)
    by_engine = {r["engine"]: r for r in recs}
    assert by_engine["vectorized"]["status"] == "ok"
    assert by_engine["batched"]["status"] == "timeout"
    rep = P.build_report("t", recs, quick=True)
    assert any("timeout" in f for f in rep.gate_failures())


# ----------------------------------------------------- the start method
@pytest.mark.parametrize("cuda_initialized", [False, True])
def test_executor_never_forks_the_caller(monkeypatch, cuda_initialized):
    """A parent holding a CUDA context (chip_smoke.py's, after its GPU
    phases) cannot hand it to a forked child; nor may a parent's thread
    pools leave locks held in one. Children come from a fork server."""
    monkeypatch.setattr(torch.cuda, "is_initialized",
                        lambda: cuda_initialized)
    assert executor._mp_context().get_start_method() != "fork"


def test_kernels_built_in_the_parent_only_for_card_cells(monkeypatch):
    """Cells bound for the card make the parent build the kernels once
    before the first child starts; CPU and numpy cells build nothing."""
    from repro_torch.kernels import fleet

    builds = []
    monkeypatch.setattr(fleet, "build", lambda *a, **k: builds.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cells = P.expand_grid(PR.TORCH_GRID)[0]
    executor._build_kernels_for(P.on_device(cells, "cpu"))
    executor._build_kernels_for([c for c in cells if c.engine == "batched"])
    assert builds == []
    executor._build_kernels_for(P.on_device(cells, "cuda"))
    assert len(builds) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    executor._build_kernels_for(P.on_device(cells, "cuda"))
    assert len(builds) == 1         # no card: the cell errs in its child


def test_children_run_one_torch_thread():
    recs = P.run_cells(_tiny_cells(), quick=True, workers=2,
                       cell_timeout_s=60.0, cell_fn=cells_fn.child_state)
    assert all(r["status"] == "ok" for r in recs), recs
    assert {r["threads"] for r in recs} == {1}
    assert not any(r["cuda_initialized"] for r in recs)


_FAN_OUT_AND_EXIT = """
import sys
sys.path.insert(0, {tests!r})
from multiprocessing import forkserver, resource_tracker
import repro_torch.campaign as P
import torch_campaign_cells as cells_fn
grid = P.SweepGrid(**{tiny!r})
cells = P.expand_campaign(P.CampaignSpec(name="t", grids=(grid,)))
recs = P.run_cells(cells, quick=True, workers=2, cell_timeout_s=60.0,
                   cell_fn=cells_fn.fake_ok)
assert [r["status"] for r in recs] == ["ok", "ok"], recs
print(forkserver._forkserver._forkserver_pid,
      resource_tracker._resource_tracker._pid)
"""


def test_no_process_outlives_a_fanned_out_run():
    """A program that fanned cells out and ends leaves no process behind:
    the fork server (and the resource tracker it brought up) would
    otherwise outlive it while tearing its preloaded torch down. The
    program prints both pids; once it has exited neither may exist, not
    even as an unreaped zombie."""
    code = _FAN_OUT_AND_EXIT.format(tests=str(ROOT / "tests"), tiny=TINY)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    pids = [int(p) for p in out.stdout.split()]
    assert len(pids) == 2, out.stdout
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    executor.shutdown()             # and in this process, mid-run
    recs = P.run_cells(_tiny_cells(), quick=True, workers=2,
                       cell_timeout_s=60.0, cell_fn=cells_fn.fake_ok)
    assert [r["status"] for r in recs] == ["ok", "ok"]


# ----------------------------------------------------------- bench I/O
def test_benchio_roundtrip(tmp_path):
    path = P.write_bench("unit", [{"a": 1}], root=str(tmp_path),
                         quiet=True, extra_field="x")
    assert Path(path).name == "BENCH_torchunit.json"
    payload = P.load_bench(path)
    assert payload["schema_version"] == SCHEMA_VERSION
    assert payload["rows"] == [{"a": 1}]
    assert payload["extra_field"] == "x"
    assert payload["section"] == "unit"
    assert "cpus" in payload["machine"]
    assert P.load_section("unit", root=str(tmp_path)) == payload


def test_benchio_tolerant_loader(tmp_path):
    assert P.load_section("missing", root=str(tmp_path)) is None
    bad = tmp_path / "BENCH_torchcorrupt.json"
    bad.write_text("{not json")
    assert P.load_bench(str(bad)) is None
    future = tmp_path / "BENCH_torchfuture.json"
    future.write_text(json.dumps(
        {"schema_version": SCHEMA_VERSION + 1, "rows": []}))
    assert P.load_bench(str(future)) is None
    legacy = tmp_path / "BENCH_torchlegacy.json"
    legacy.write_text(json.dumps({"section": "legacy", "rows": [{}]}))
    assert P.load_bench(str(legacy))["rows"] == [{}]
    shaped = tmp_path / "BENCH_torchshape.json"
    shaped.write_text(json.dumps({"rows": "nope"}))
    assert P.load_bench(str(shaped)) is None


def test_bench_path_never_names_a_reference_file():
    reference = {p.name for p in ROOT.glob("BENCH_*.json")
                 if not p.name.startswith("BENCH_torch")}
    assert reference, "the reference's trajectories are in the repo"
    sections = {p[len("BENCH_"):-len(".json")] for p in reference}
    for section in sections | {"scale", "serving", "campaign", "unit"}:
        name = Path(P.bench_path(section, str(ROOT))).name
        assert name.startswith("BENCH_torch"), name
        assert name not in reference, name


class _Smi:
    def __init__(self, stdout):
        self.stdout = stdout


def test_machine_info_card_fields_only_with_cuda(monkeypatch):
    from repro_torch.campaign import benchio

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    info = benchio.machine_info()
    assert "cpu_model" in info or "cpus" in info
    assert not any(k.startswith("gpu") for k in info)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(benchio.subprocess, "run", lambda *a, **k: _Smi(
        "NVIDIA H100 80GB HBM3, 700.00 W\n"))
    info = benchio.machine_info()
    assert info["gpu_name"] == "NVIDIA H100 80GB HBM3"
    assert info["gpu_power_limit"] == "700.00 W"

    def no_smi(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(benchio.subprocess, "run", no_smi)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "Card")
    info = benchio.machine_info()
    assert info["gpu_name"] == "Card" and info["gpu_power_limit"] is None


# ------------------------------------------------------------- differ
@pytest.fixture
def baselines(tmp_path):
    """The reference's committed trajectories, read as the port's own
    baselines (copies under the port's names; the originals are only
    read)."""
    for section in TRAJECTORY_SECTIONS:
        shutil.copy(ROOT / f"BENCH_{section}.json",
                    tmp_path / f"BENCH_torch{section}.json")
    return tmp_path


def _records_from_scenarios_baseline(root):
    payload = P.load_section("scenarios", root=str(root))
    recs = []
    for row in payload["rows"]:
        recs.append({
            "cell": f"{row['scenario']}/baseline",
            "scenario": row["scenario"], "engine": "batched",
            "control_plane": "array", "placement": row["placement"],
            "policy": row["policy"], "scaling_policy": "reactive",
            "forecaster": "ewma", "seed": 7, "options": [],
            "status": "ok", "duration_s": row["duration_s"],
            "tenants": row["tenants"],
            "violation_rate": row["violation_rate"],
            "requests_conserved": True, "wall_s": 0.1,
        })
    return recs


def test_real_trajectories_loadable(baselines):
    for section in TRAJECTORY_SECTIONS:
        payload = P.load_section(section, root=str(baselines))
        assert payload is not None and payload["rows"], section


def test_differ_passes_on_real_trajectories(baselines):
    recs = _records_from_scenarios_baseline(baselines)
    rep = P.build_report("diff", recs, quick=False)
    diff = P.diff_report(rep, root=str(baselines), prev=None)
    assert diff.compared >= len(recs)
    assert diff.ok, diff.render()


def test_differ_fails_on_injected_vr_regression(baselines):
    recs = _records_from_scenarios_baseline(baselines)
    recs[0]["violation_rate"] += 0.05       # +5pp, tolerance is 0.5pp
    rep = P.build_report("diff", recs, quick=False)
    diff = P.diff_report(rep, root=str(baselines), prev=None)
    assert not diff.ok
    assert any(recs[0]["scenario"] in r and "VR" in r
               for r in diff.regressions), diff.render()
    loose = P.diff_report(rep, root=str(baselines), prev=None,
                          tol=P.Tolerances(vr_pp=10.0))
    assert loose.ok


def test_differ_improvement_is_not_fatal(baselines):
    recs = _records_from_scenarios_baseline(baselines)
    recs[0]["violation_rate"] = max(0.0, recs[0]["violation_rate"] - 0.05)
    rep = P.build_report("diff", recs, quick=False)
    diff = P.diff_report(rep, root=str(baselines), prev=None)
    assert diff.ok
    assert diff.improvements


def test_differ_vs_previous_campaign(baselines):
    recs = _records_from_scenarios_baseline(baselines)
    rep = P.build_report("prev", recs, quick=False)
    extra = {k: v for k, v in rep.payload().items() if k != "rows"}
    P.write_bench("campaign", rep.records, root=str(baselines), quiet=True,
                  **extra)
    prev = P.load_section("campaign", root=str(baselines))
    diff = P.diff_report(rep, root=str(baselines), prev=prev)
    assert diff.ok and diff.compared >= len(recs)
    bad = json.loads(json.dumps(rep.records))
    bad[0]["violation_rate"] += 0.05
    diff2 = P.diff_report(P.build_report("next", bad, quick=False),
                          root=str(baselines), prev=prev)
    assert not diff2.ok
    assert any("previous campaign" in r for r in diff2.regressions)
    small = json.loads(json.dumps(rep.records))
    for r in small:
        r["duration_s"] = 60
        r["violation_rate"] += 0.2
    diff3 = P.diff_report(P.build_report("quick", small, quick=True),
                          root=str(baselines), prev=prev)
    assert not any("previous campaign" in r for r in diff3.regressions)


@pytest.mark.parametrize("other", [None, "gpu_name", "gpu_power_limit",
                                   "cpu_model"])
def test_differ_compares_walls_on_one_host_and_card(baselines, other):
    """Walls compare only when the CPU model and the card (name and
    power limit) are the same in both runs."""
    from repro_torch.campaign import benchio

    recs = _records_from_scenarios_baseline(baselines)
    rep = P.build_report("prev", recs, quick=False)
    prev = benchio.bench_payload("campaign", rep.records, quick=False)
    prev["machine"].update(gpu_name="NVIDIA H100 80GB HBM3",
                           gpu_power_limit="700.00 W")
    here = dict(prev["machine"])
    if other is not None:
        prev["machine"][other] = "another"
    slow = json.loads(json.dumps(rep.records))
    for r in slow:
        r["wall_s"] *= 2.0                  # x2 > the 1.75 tolerance
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(benchio, "machine_info", lambda: here)
        mp.setattr("repro_torch.campaign.diff.machine_info", lambda: here)
        diff = P.diff_report(P.build_report("next", slow, quick=False),
                             root=str(baselines), prev=prev)
    walls = [r for r in diff.regressions if "wall" in r]
    if other is None:
        assert walls, diff.render()
    else:
        assert not walls
        assert any("walls not compared" in n for n in diff.notes)


def test_report_contract_reads_the_port_registry():
    from repro_torch.campaign.report import TOLERANCE_CONTRACT_VR, _contract

    assert TOLERANCE_CONTRACT_VR == 0.02
    assert _contract("torch") == "tolerance"
    assert _contract("batched") == "bitwise"
    assert _contract("serving") == "token-level"
    base = {"scenario": "s", "control_plane": "array", "placement": "p",
            "policy": "sdps", "scaling_policy": "reactive",
            "forecaster": "ewma", "seed": 7, "options": [], "status": "ok"}
    recs = [dict(base, cell="b", engine="batched", violation_rate=0.10),
            dict(base, cell="t", engine="torch", violation_rate=0.13)]
    rep = P.build_report("c", recs, quick=True)
    assert any("tolerance engine torch" in v
               for v in rep.consistency_violations())
    recs[1]["violation_rate"] = 0.115
    assert P.build_report("c", recs, quick=True).consistency_violations() \
        == []


def test_records_pickle_through_a_child_unchanged():
    """A cell's resolved scenario travels to its child: a scenario that
    is in no registry runs there all the same."""
    sc = dataclasses.replace(
        P.expand_grid(P_TINY)[0][0].scenario, name="not_registered")
    grid = P.SweepGrid(scenarios=(sc,), engines=("batched",),
                       policies=("sdps",), scaling_policies=("reactive",))
    cells = P.expand_campaign(P.CampaignSpec(name="inline", grids=(grid,)))
    fan = P.run_cells(cells, quick=True, workers=1, cell_timeout_s=120.0)
    inline = P.run_cells(cells, quick=True, workers=0)
    assert fan[0]["status"] == "ok", fan
    assert strip_volatile(fan) == strip_volatile(inline)
