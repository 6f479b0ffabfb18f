"""The training launcher's step deadline times the interval the JAX
package's does: from the batch to the step's return, before any read of
the step's metrics. Both launchers' ``main`` run with the same stub step
and a stub pipeline whose batches cost nothing (the reference's
``jax.jit`` left out, so the stub runs as written): a fast step whose
metrics are slow to read as floats misses no deadline in either
package, and a slow step misses in both and, after three misses, halves
the batch (degraded mode)."""
import sys
import time

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as RT
import repro_torch.launch.train as PT

DEADLINE_S = 0.2
SLOW_S = 0.3


class SlowFloat:
    """A metric whose conversion to a float takes ``delay`` seconds, as
    reading a device value back waits for the step to finish."""

    def __init__(self, delay: float):
        self.delay = delay

    def __float__(self):
        time.sleep(self.delay)
        return 1.0


def stub_step(step_s: float, read_s: float):
    """A ``make_train_step`` whose step takes ``step_s`` and whose metrics
    take ``read_s`` each to read."""
    def make(model, tc):
        def step(state, batch):
            time.sleep(step_s)
            return state, {k: SlowFloat(read_s)
                           for k in ("loss", "lr", "total_loss")}
        return step
    return make


class StubPipe:
    """A pipeline of one fixed batch, as numpy (the reference's launcher
    slices it in degraded mode) or torch (the port's)."""

    def __init__(self, to):
        self.b = {k: to(np.zeros((4, 16), np.int32))
                  for k in ("tokens", "labels")}

    def batch(self, step):
        return self.b


class _NoJit:
    """``jax`` with ``jit`` returning the function as it is."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(f, **_):
        return f


ARGS = ["--reduced", "--steps", "4", "--seq", "16", "--batch", "4",
        "--step-deadline-s", str(DEADLINE_S)]


def run_reference(monkeypatch, capsys, step_s, read_s) -> str:
    monkeypatch.setattr(RT, "jax", _NoJit())
    monkeypatch.setattr(RT, "make_train_step", stub_step(step_s, read_s))
    monkeypatch.setattr(RT, "make_pipeline",
                        lambda *a, **k: StubPipe(np.asarray))
    monkeypatch.setattr(sys, "argv", ["train"] + ARGS)
    RT.main()
    return capsys.readouterr().out


def run_port(monkeypatch, capsys, step_s, read_s) -> str:
    monkeypatch.setattr(PT, "make_train_step", stub_step(step_s, read_s))
    monkeypatch.setattr(PT, "make_pipeline",
                        lambda *a, **k: StubPipe(torch.from_numpy))
    PT.main(ARGS + ["--device", "cpu"])
    return capsys.readouterr().out


@pytest.mark.parametrize("run", [run_reference, run_port])
def test_deadline_excludes_reading_the_metrics(monkeypatch, capsys, run):
    out = run(monkeypatch, capsys, step_s=0.0, read_s=SLOW_S)
    assert out.count("loss=") == 4, out
    assert "DEADLINE MISS" not in out, out


@pytest.mark.parametrize("run", [run_reference, run_port])
def test_slow_steps_miss_and_degrade(monkeypatch, capsys, run):
    out = run(monkeypatch, capsys, step_s=SLOW_S, read_s=0.0)
    assert out.count("DEADLINE MISS") == 4, out
    assert "[3/3]" in out
    assert out.count("degraded mode: halving per-step batch") == 1, out
    assert out.index("[3/3]") < out.index("degraded mode")
