"""Process fan-out for campaign cells: timeout + crash isolation.

One child process per cell, results shipped back over a ``Pipe``, and
a sliding window of ``workers`` concurrent children multiplexed with
:func:`multiprocessing.connection.wait`. Three failure modes are
captured as structured records instead of killing the campaign:

* the cell raises — the child catches ``BaseException`` and reports
  ``status="error"`` with the message and traceback;
* the child dies outright (segfault, ``os._exit``) — the parent sees
  EOF on the pipe and reports ``status="crash"`` with the exit code;
* the cell overruns ``cell_timeout_s`` — the parent terminates the
  child and reports ``status="timeout"``.

``workers <= 0`` runs every cell inline in the parent (no processes,
no timeout enforcement) — the mode tests use for determinism checks.

Per-cell seeds are deterministic because the seed IS an axis of the
cell: the child runs ``cell.scenario_with_axes()`` (which pins
``scenario.seed`` to the cell's seed) and every engine derives its RNG
streams from that.

Children are never forked from the caller. A process that holds a CUDA
context cannot hand it to a forked child (its first CUDA call fails),
and a fork copies the state of the caller's threads but not the
threads: once a batched run has started the simulator's process-wide
RNG thread pool (:func:`repro_torch.sim.edgesim._rng_pool`), a forked
child's first jitter fill waits forever for workers it does not have.
Children come from a fork server instead (a fresh interpreter that has
imported torch and this module and touched no device); so each
cell, with its resolved :class:`~repro_torch.sim.scenario.Scenario`,
and ``cell_fn`` are pickled, and a ``cell_fn`` must be a module-level
function. A child runs torch on one thread, as a DataLoader worker
does. When a cell will run on the card the parent builds the kernels
before the first child starts, so the children load the libraries
rather than each start their own ``nvcc`` processes. The fork server
(and the resource tracker, where a fan-out started it) would outlive a
caller that exits, so :func:`shutdown` stops both and runs at exit.
"""
from __future__ import annotations

import atexit
import dataclasses
import functools
import multiprocessing
import os
import time
import traceback
from multiprocessing import forkserver, resource_tracker

import torch

from repro_torch.campaign.spec import DEVICE_ENGINES, RunSpec


def artifact_dir_for(cell_id: str, artifacts_dir: str) -> str:
    """Filesystem-safe per-cell artifact directory (cell ids contain
    ``/`` separators)."""
    return os.path.join(artifacts_dir, cell_id.replace("/", "_"))


def run_cell(cell: RunSpec, quick: bool,
             artifacts_dir: str | None = None) -> dict:
    """Run one cell to a structured record (the default ``cell_fn``).

    With ``artifacts_dir`` the cell runs under a flight recorder
    (``scenario.trace=True`` — observability-only, results unchanged)
    and writes a Chrome-trace ``trace.json`` per cell under
    ``<artifacts_dir>/<sanitized cell id>/``; the record carries its
    path as ``trace_path``."""
    from repro_torch.sim.engines import resolve_engine
    from repro_torch.sim.scenario import run_scenario

    sc = cell.scenario_with_axes()
    if artifacts_dir is not None:
        sc = dataclasses.replace(sc, trace=True)
    t0 = time.perf_counter()
    res = run_scenario(sc, policies=(cell.policy,),
                       scaling_policies=(cell.scaling_policy,),
                       quick=quick)
    wall = time.perf_counter() - t0
    ran = res.scenario
    rec = cell.record_stub()
    rec.update(
        status="ok",
        duration_s=float(resolve_engine(ran.engine).scenario_duration(ran)),
        tenants=ran.fleet.size,
        n_nodes=ran.topology.n_nodes,
        wall_s=wall,
    )
    rec.update(res.outcomes[cell.policy].to_record())
    if artifacts_dir is not None:
        cell_dir = artifact_dir_for(cell.cell_id, artifacts_dir)
        os.makedirs(cell_dir, exist_ok=True)
        trace_path = os.path.join(cell_dir, "trace.json")
        res.write_trace(trace_path)
        rec["trace_path"] = trace_path
    return rec


def _failure_record(cell: RunSpec, status: str, **extra) -> dict:
    rec = cell.record_stub()
    rec.update(status=status, **extra)
    return rec


def _cell_worker(conn, cell: RunSpec, quick: bool, cell_fn) -> None:
    torch.set_num_threads(1)
    try:
        rec = cell_fn(cell, quick)
    except BaseException as e:  # noqa: BLE001 — isolation is the point
        rec = _failure_record(cell, "error", error=f"{type(e).__name__}: {e}",
                              traceback=traceback.format_exc())
    try:
        conn.send(rec)
    finally:
        conn.close()


def _mp_context():
    """The children's start method: a fork server, never a fork of the
    caller (see the module docstring)."""
    ctx = multiprocessing.get_context("forkserver")
    # the server imports torch and this module once, so a child starts
    # in a fraction of a second, not the ~6 s that importing torch takes
    # on an H100 host. torch is named first: with this module alone
    # (Python 3.12.3 there) the server held no torch and every child
    # imported it. Takes effect at the server's first start.
    ctx.set_forkserver_preload(["torch", __name__])
    return ctx


# whether a fan-out started the resource tracker (shutdown stops only
# what a fan-out started), and whether shutdown is registered at exit
_OWN_TRACKER = False
_AT_EXIT = False


def _start_servers() -> None:
    """Start the resource tracker and the fork server before the first
    child, noting which of them this fan-out started."""
    global _OWN_TRACKER, _AT_EXIT
    if resource_tracker._resource_tracker._pid is None:
        _OWN_TRACKER = True
    forkserver.ensure_running()
    if not _AT_EXIT:
        atexit.register(shutdown)
        _AT_EXIT = True


def shutdown() -> None:
    """Stop the fork server, and the resource tracker if a fan-out
    started it, and wait for both to exit: the server would otherwise
    outlive a caller that ends, tearing its preloaded torch down after
    the caller has gone. Runs at exit once a fan-out has started; a
    later fan-out starts both anew."""
    global _OWN_TRACKER
    forkserver._forkserver._stop()
    if _OWN_TRACKER:
        resource_tracker._resource_tracker._stop()
        _OWN_TRACKER = False


def _runs_on_cuda(cell: RunSpec) -> bool:
    if cell.engine not in DEVICE_ENGINES:
        return False
    device = cell.scenario_with_axes().backend_options.get("device", "cuda")
    return torch.device(device).type == "cuda"


def _build_kernels_for(cells: list[RunSpec]) -> None:
    """Build the kernels in the parent when a cell will run on the card
    (and a card is there: without one the cell raises in its child and
    is recorded as an error, never re-run on the CPU)."""
    if torch.cuda.is_available() and any(map(_runs_on_cuda, cells)):
        from repro_torch.kernels import fleet
        fleet.build()


def run_cells(cells: list[RunSpec], *, quick: bool = False,
              workers: int = 2, cell_timeout_s: float = 900.0,
              cell_fn=run_cell, progress=None,
              artifacts_dir: str | None = None) -> list[dict]:
    """Run every cell, returning one record per cell IN CELL ORDER no
    matter how the children finish. ``progress`` (optional) is called
    with each finished record. ``artifacts_dir`` makes the default
    ``cell_fn`` trace every cell and drop a per-cell ``trace.json``
    there (ignored for a custom ``cell_fn``)."""
    if artifacts_dir is not None and cell_fn is run_cell:
        cell_fn = functools.partial(run_cell, artifacts_dir=artifacts_dir)
    if workers <= 0:
        out = []
        for cell in cells:
            try:
                rec = cell_fn(cell, quick)
            except BaseException as e:  # noqa: BLE001
                rec = _failure_record(cell, "error",
                                      error=f"{type(e).__name__}: {e}",
                                      traceback=traceback.format_exc())
            if progress is not None:
                progress(rec)
            out.append(rec)
        return out

    _build_kernels_for(cells)
    ctx = _mp_context()
    _start_servers()
    records: list = [None] * len(cells)
    pending = list(enumerate(cells))     # not yet launched
    live: dict = {}                      # conn -> (idx, proc, deadline)

    def launch(idx: int, cell: RunSpec) -> None:
        parent, child = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_cell_worker,
                           args=(child, cell, quick, cell_fn),
                           name=f"campaign-{cell.cell_id}")
        proc.start()
        child.close()
        live[parent] = (idx, proc, time.monotonic() + cell_timeout_s)

    def finish(conn, rec: dict) -> None:
        idx, proc, _ = live.pop(conn)
        conn.close()
        proc.join()
        records[idx] = rec
        if progress is not None:
            progress(rec)

    def stop(proc) -> None:
        proc.terminate()
        proc.join(5.0)
        if proc.is_alive():             # pragma: no cover — stuck child
            proc.kill()
            proc.join()

    try:
        while pending or live:
            while pending and len(live) < workers:
                launch(*pending.pop(0))
            now = time.monotonic()
            budget = max(0.05, min(dl for _, _, dl in live.values()) - now)
            ready = multiprocessing.connection.wait(list(live),
                                                    timeout=budget)
            for conn in ready:
                idx, proc, _ = live[conn]
                try:
                    rec = conn.recv()
                except EOFError:
                    proc.join()
                    rec = _failure_record(
                        cells[idx], "crash",
                        error=f"worker died (exitcode {proc.exitcode})",
                        exitcode=proc.exitcode)
                finish(conn, rec)
            now = time.monotonic()
            for conn in [c for c, (_, _, dl) in live.items() if dl <= now]:
                idx, proc, _ = live[conn]
                stop(proc)
                finish(conn, _failure_record(
                    cells[idx], "timeout",
                    error=f"cell exceeded {cell_timeout_s:.0f}s timeout"))
    finally:
        # interrupted (^C, or a progress callback that raised): no
        # child outlives the run
        for conn, (_, proc, _) in live.items():
            stop(proc)
            conn.close()
    return records
