"""Mesh definitions over ``torch.distributed`` (the JAX package's
``launch/mesh.py``).

Functions, not module-level constants: importing this module starts no
process group. A mesh is built over the ranks of the default process
group, which :func:`init_process_group` brings up from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
where none is. A run of one rank that no group was brought up for
(one card, or the CPU, started without ``torchrun``) gets a mesh of one
rank with no group behind it, on which every placement is Replicate.
The backend is NCCL on ``cuda`` and gloo on ``cpu``; NCCL takes one
rank a card. The dry-run alone builds its meshes over
:func:`fake_process_group`, a group of any size that moves no data.
"""
from __future__ import annotations

import contextlib
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import Mesh


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device="cuda") -> bool:
    """Bring up the default process group for ``device`` where none is:
    torchrun's ranks, else one rank on a free local port. Returns True
    when this call created it (the caller then destroys it with
    :func:`destroy_process_group`)."""
    if dist.is_initialized():
        return False
    dev = torch.device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        rank, world, init = 0, 1, f"tcp://localhost:{port}"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend_for(dev), init_method=init, rank=rank,
                            world_size=world)
    return True


@contextlib.contextmanager
def fake_process_group(world: int):
    """A default process group of ``world`` ranks that moves no data
    (torch's fake backend over a ``FakeStore``), this process its rank
    0, destroyed on exit: the dry-run's, which accounts one rank's share
    of a production mesh that no run has. Raises where a group is up
    already; it never joins or replaces one."""
    if dist.is_initialized():
        raise RuntimeError("a process group is up already; the dry-run "
                           "brings up its own fake one")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def world_size() -> int:
    """The ranks of this run: the default group's, else torchrun's
    ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape: tuple, axis_names: tuple, device="cuda") -> Mesh:
    """A ``shape`` mesh named ``axis_names`` over the default group's
    ranks (brought up if need be), which must number ``prod(shape)``;
    with one rank and no group, a mesh without one."""
    from torch.distributed.device_mesh import init_device_mesh

    need, world = int(np.prod(shape)), world_size()
    if need != world:
        raise RuntimeError(
            f"a {dict(zip(axis_names, shape))} mesh needs {need} ranks; "
            f"this run has {world} (start it with torchrun "
            f"--nproc-per-node {need}, one rank a card)")
    if world == 1 and not dist.is_initialized():
        return Mesh(None, axis_names, np.zeros(shape, int))
    init_process_group(device)
    dm = init_device_mesh(torch.device(device).type, tuple(shape),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(dm, axis_names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's production layout: 16×16 = 256 ranks a pod;
    multi-pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device="cuda") -> Mesh:
    """Whatever ranks were launched (one when the process was not started
    by torchrun): (1, n) data×model."""
    return make_mesh((1, world_size()), ("data", "model"), device)


def mesh_axis_size(mesh, *names: str) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n = 1
    for name in names:
        n *= sizes.get(name, 1)
    return n
