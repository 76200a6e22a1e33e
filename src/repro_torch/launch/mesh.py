"""Device meshes: the production 16×16 and 2×16×16 meshes over a fake
process group of 256 or 512 ranks (the dry run's counterpart of the
reference's 512 placeholder host devices), and a small mesh over the ranks
that exist.

The PyTorch counterpart of ``repro/launch/mesh.py``.  Neither mesh function
starts a process group: the caller does (``fake_world``, or
``torch.distributed.init_process_group`` with its own backend).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "fake_world"]


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16×16 = 256 ranks per pod; multi-pod adds a leading 2-pod axis.  The
    world must already hold 256 (512) ranks: ``fake_world`` gives them.
    The mesh is a ``cpu`` one: in the fake world it only carries shapes
    (``meta`` tensors), so no device backs it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh("cpu", shape, axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device=None) -> DeviceMesh:
    """Small ``(data, model)`` mesh over the ranks of the running process
    group (tests, the one-card smoke run); ``data`` is clipped to the ranks
    there are.  ``device`` None means CUDA (raises without a card); pass
    ``"cpu"`` for a gloo world on the CPU."""
    n = dist.get_world_size()
    data = min(data, n // model) or 1
    return _mesh(resolve_device(device).type, (data, model),
                 ("data", "model"))


def _mesh(device_type: str, shape: tuple, axes: tuple) -> DeviceMesh:
    ranks = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


@contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A process group of ``world_size`` ranks in which this process is rank
    0 and every collective returns at once without moving data: enough to
    place ``meta`` DTensors and trace the collectives a step issues.  Torn
    down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
