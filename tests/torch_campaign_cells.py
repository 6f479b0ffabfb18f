"""Injected ``cell_fn``s for the port's campaign executor tests.

The executor's children are started by a fork server, so a ``cell_fn``
is pickled by reference: these live at module level, in a module that
imports only the port (a child that unpickles one imports this file,
not the test module with the JAX package behind it)."""
import os
import time


def fake_ok(cell, quick):
    rec = cell.record_stub()
    rec.update(status="ok", violation_rate=0.1, duration_s=1.0,
               tenants=1, n_nodes=1, wall_s=0.0, requests_conserved=True)
    return rec


def raise_on_batched(cell, quick):
    if cell.engine == "batched":
        raise RuntimeError("boom")
    return fake_ok(cell, quick)


def crash_on_batched(cell, quick):
    if cell.engine == "batched":
        os._exit(3)                 # simulated hard crash
    return fake_ok(cell, quick)


def hang_on_batched(cell, quick):
    if cell.engine == "batched":
        time.sleep(600.0)
    return fake_ok(cell, quick)


def child_state(cell, quick):
    """What the child sees: its torch threads and whether it inherited
    a CUDA context (a fork of a parent holding one would)."""
    import torch

    rec = fake_ok(cell, quick)
    rec.update(threads=torch.get_num_threads(),
               cuda_initialized=torch.cuda.is_initialized(),
               pid=os.getpid())
    return rec
