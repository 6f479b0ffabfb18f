"""A run with the timed path broken underneath comes out not correct:
the harness's look for a chip is skipped (the CPU, the kernels' plain
versions, the test size of :mod:`bench.tests.small`), the rest of a run
is driven as the benchmark drives it, and the cell's own limit judges.
The faults a served model can have: a token altered where it is
produced, and a decode step that returns its state (the KV cache)
unchanged."""
import pytest
import torch

from bench.tests.small import DENSE, MOE, run

CELLS = [("granite.code", DENSE), ("olmoe.docqa", MOE)]


def _each_runtime(eng, wrap):
    for rt in eng.tenants.values():
        rt._decode = wrap(rt._decode)


def token_altered(eng):
    def wrap(decode):
        def f(params, cache, token, pos):
            logits, cache = decode(params, cache, token, pos)
            return torch.roll(logits, 1, dims=-1), cache
        return f
    _each_runtime(eng, wrap)


def state_unchanged(eng):
    def wrap(decode):
        def f(params, cache, token, pos):
            logits, _ = decode(params, {k: v.clone() for k, v in
                                        cache.items()}, token, pos)
            return logits, cache
        return f
    _each_runtime(eng, wrap)


@pytest.mark.parametrize("cell,cfg", CELLS)
def test_sound_run_is_correct(cell, cfg):
    out = run(cell, 31, cfg=cfg)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0


@pytest.mark.parametrize("fault", [token_altered, state_unchanged])
@pytest.mark.parametrize("cell,cfg", CELLS)
def test_fault_is_not_correct(cell, cfg, fault):
    out = run(cell, 31, cfg=cfg, fault=fault)
    assert not out["correct"], out["checks"]
