"""The control: the reference put in the program's place in float8
products reads a wider gap than the program. At the test size on the
CPU here; at each cell's own size on the card (``-m cuda``), where the
control has to fail the cell's limit and the program pass it."""
import time

import pytest

from bench.tests.small import DENSE, MOE, ROOT, run


@pytest.mark.parametrize("cell,cfg", [("granite.code", DENSE),
                                      ("olmoe.docqa", MOE)])
def test_control_reads_wider_than_the_program(cell, cfg):
    """On the number the cell compares (its traffic file's ``check``)."""
    from bench import harness
    number = harness.load_spec(ROOT, cell)[3]["check"]["number"]
    for seed in (41, 42, 43):
        out = run(cell, seed, cfg=cfg, control=True)
        assert out["control"][number] > out["samples"]["gaps"][number]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["olmoe.docqa", "granite.code"])
def test_control_fails_the_limit_at_the_cells_size(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell's own size")
    from bench import harness
    out = harness.run(ROOT, cell, 977, 20.0, False,
                      t_start=time.perf_counter(), control=True)
    number = harness.load_spec(ROOT, cell)[3]["check"]["number"]
    compared = out["checks"][f"logit_gap_{number}"]
    assert out["correct"]
    assert out["control"][number] > compared["limit"] >= compared["value"]
