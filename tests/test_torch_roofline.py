"""The port's roofline benches (``repro_torch.benchmarks.roofline_report``,
``hillclimb``, ``fill_experiments`` and ``run``'s roofline section)
against the reference's on the same dry-run JSON, and the dense decode
of the sharded layouts against the reference's ``decode_attention`` and
the paged kernel's plain version."""
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

_xla_flags = os.environ.get("XLA_FLAGS")
from benchmarks import fill_experiments as RFE  # noqa: E402
from benchmarks import hillclimb as RH  # noqa: E402  (sets XLA_FLAGS)
from benchmarks import roofline_report as RR  # noqa: E402

# nothing here compiles on the reference's 512 host devices
if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

from repro.models import attention as RA  # noqa: E402

from repro_torch.benchmarks import fill_experiments as PFE  # noqa: E402
from repro_torch.benchmarks import hillclimb as PH  # noqa: E402
from repro_torch.benchmarks import roofline_report as PR  # noqa: E402
from repro_torch.benchmarks import run as PRUN  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402


def _row(arch, shape, mesh, i, **kw):
    """A dry-run cell's JSON, its terms made from ``i``."""
    terms = {"compute_s": 0.0123 * (i + 1), "memory_s": 0.987 / (i + 2),
             "collective_s": 0.0456 * (i % 3 + 0.5)}
    r = {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
         "tag": "baseline", **terms,
         "dominant": max(terms, key=terms.get),
         "useful_flops_frac": 0.5 + 0.01 * i,
         "roofline_frac": 0.003 * (i + 1)}
    r.update(kw)
    return r


def _write_dryrun(out_dir):
    rows = [
        _row("tinyllama-1.1b", "train_4k", "single", 0),
        _row("granite-8b", "train_4k", "single", 1, tag="extrapolated"),
        _row("olmoe-1b-7b", "decode_32k", "single", 2,
             useful_flops_frac=None),
        {"arch": "granite-8b", "shape": "long_500k", "mesh": "single",
         "status": "skipped", "reason": "full attention"},
        {"arch": "whisper-small", "shape": "prefill_32k", "mesh": "single",
         "status": "error", "error": "RuntimeError: " + "x" * 120},
        _row("tinyllama-1.1b", "train_4k", "multi", 3),
        _row("zamba2-2.7b", "long_500k", "multi", 4),
        {"arch": "arctic-480b", "shape": "long_500k", "mesh": "multi",
         "status": "skipped"},
    ]
    os.makedirs(out_dir, exist_ok=True)
    for r in rows:
        name = f"{r['arch']}__{r['shape']}__{r['mesh']}__x.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(r, f)


def _write_hillclimb(out_dir):
    rows = []
    for i, (cell, arch, shape, tag, _, hyp) in enumerate(RH.RUNS):
        r = _row(arch, shape, "single", i, cell=cell, tag=tag,
                 hypothesis=hyp)
        if tag == "opt2_bf16_sp":
            r = {"cell": cell, "arch": arch, "shape": shape, "tag": tag,
                 "status": "error", "error": "ValueError: " + "y" * 90}
        rows.append(r)
    os.makedirs(out_dir, exist_ok=True)
    for r in rows:
        with open(os.path.join(out_dir, f"{r['cell']}__{r['arch']}__"
                               f"{r['shape']}__{r['tag']}.json"), "w") as f:
            json.dump(r, f)


def test_runs_tables_equal():
    assert PH.RUNS == RH.RUNS


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_roofline_table_text_equals_reference(tmp_path, mesh):
    _write_dryrun(tmp_path / "dryrun")
    got = PR.markdown_table(PR.roofline_table(str(tmp_path / "dryrun"),
                                              mesh))
    want = RR.markdown_table(RR.roofline_table(str(tmp_path / "dryrun"),
                                               mesh))
    assert got == want
    assert PR.load_results(str(tmp_path / "dryrun"), mesh, "baseline") == \
        RR.load_results(str(tmp_path / "dryrun"), mesh, "baseline")


def test_hillclimb_report_equals_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_hillclimb(RH.OUT)
    _write_hillclimb(PH.OUT)
    assert PH.OUT == "results/torch_hillclimb"
    text = PH.report()
    assert text == RH.report()
    assert text.count("### Cell") == 3


def test_fill_experiments_text_equals_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_dryrun("results/dryrun")
    _write_dryrun(PR.OUT)
    _write_hillclimb(RH.OUT)
    _write_hillclimb(PH.OUT)
    template = ("# Experiments\n\n## Roofline\n<!-- ROOFLINE_TABLE -->\n\n"
                "## Perf\n<!-- PERF_LOG -->\n")
    (tmp_path / "EXPERIMENTS.md").write_text(template)
    RFE.main()
    want = (tmp_path / "EXPERIMENTS.md").read_text()
    (tmp_path / "mine.md").write_text(template)
    PFE.main(["mine.md"])
    got = (tmp_path / "mine.md").read_text()
    assert "<!--" not in got and "1 recorded skips" in got
    assert got.replace(PR.OUT, "results/dryrun") == want


def test_run_roofline_section_counts_ok_cells(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.chdir(tmp_path)
    _write_dryrun(PR.OUT)
    PRUN.main(["--only", "roofline"])
    out = capsys.readouterr().out
    assert re.search(r"^roofline/cells_ok,0\.0,3 cells with roofline terms",
                     out, re.M)
    saved = json.loads((tmp_path / "results/torch_benchmarks.json")
                       .read_text())
    assert len(saved["roofline"]) == 5


# ------------------------------------------------------------ dense decode
def _decode_inputs(seed, B=3, S=40, H=8, KH=2, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    lens = np.array([1, 17, S])[:B].astype(np.int32)
    return q, k, v, lens


@pytest.mark.parametrize("partials", [False, True])
@pytest.mark.parametrize("grouped", [False, True])
def test_dense_decode_matches_reference_and_paged_plain(partials, grouped):
    """The dense decode in each (partials, grouped) layout against the
    reference's ``decode_attention`` in the same layout (f32, CPU, within
    1e-5) and against the paged kernel's plain version, which serves
    plain tensors."""
    for seed, (H, KH) in enumerate(((8, 2), (4, 4), (6, 1))):
        q, k, v, lens = _decode_inputs(seed, H=H, KH=KH)
        want = np.asarray(RA.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens), partials=partials, grouped=grouped))
        got = PA.dense_decode_attention(
            torch.tensor(q), torch.tensor(k), torch.tensor(v),
            torch.tensor(lens), partials=partials, grouped=grouped)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        paged = PA.decode_attention(torch.tensor(q), torch.tensor(k),
                                    torch.tensor(v), torch.tensor(lens),
                                    partials=partials, grouped=grouped)
        np.testing.assert_allclose(got.numpy(), paged.numpy(), rtol=1e-5,
                                   atol=1e-5)
