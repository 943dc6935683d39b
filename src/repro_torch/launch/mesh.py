"""The dry run's meshes: the reference's production and debug meshes, as
:class:`~repro_torch.distributed.mesh.DeviceMesh`\\ es over ``meta``
devices.  A port of ``repro.launch.mesh``.

Single pod: 16 x 16 = 256 devices over ("data", "model").  Multi-pod:
2 x 16 x 16 = 512 over ("pod", "data", "model"), the "pod" axis pure DP.
These shapes are the configuration the dry run reports, kept as the
reference's: on DGX H100 nodes of 8 cards, every 16-wide axis spans
nodes (``launch.step_analysis`` prices each axis at one card's network
port).  No card is touched: a ``meta`` device holds shapes only, so a
512-device mesh costs nothing to build on any host.

The trace of a partitioned program (``launch.dryrun``) runs as rank 0 of
the mesh: :func:`fake_dtensor_mesh` gives a ``torch.distributed``
``DeviceMesh`` with the same axis names and sizes over the ``fake``
process-group backend (one process as rank 0 of a world of 512, the
mesh on its first 256 or 512 ranks, no communication).  The ``meta``-device :class:`DeviceMesh` stays for the
code that reads only names and sizes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

from ..distributed.mesh import DeviceMesh, make_spmm_mesh

__all__ = ["make_production_mesh", "make_debug_mesh", "mesh_axis_sizes",
           "make_spmm_mesh", "fake_dtensor_mesh"]

_META = torch.device("meta")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DeviceMesh((_META,) * math.prod(shape), axes, shape)


def mesh_axis_sizes(mesh: Any) -> Dict[str, int]:
    return dict(mesh.shape)


def make_debug_mesh(n_data: int = 2, n_model: int = 4,
                    devices: Optional[Sequence[Any]] = None) -> DeviceMesh:
    """A small ("data", "model") mesh: over ``meta`` devices unless
    ``devices`` lists them (row-major, repeats allowed)."""
    n = n_data * n_model
    devs = tuple(devices) if devices is not None else (_META,) * n
    return DeviceMesh(devs, ("data", "model"), (n_data, n_model))


# the fake group's size: the largest production mesh.  Every mesh is made
# on its first ranks, so the group is made once in a process and no mesh's
# subgroups are destroyed under it (DTensor's caches hand back value-equal
# meshes made earlier, whose subgroups must still resolve)
FAKE_WORLD = 512


def _fake_world(world: int) -> None:
    """A ``fake`` process group of at least ``world`` ranks with this
    process as rank 0, replacing any other group this process holds."""
    import torch.distributed as dist
    # the fake backend's store; importing the module also registers the
    # backend on releases that do not ship it built in
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = max(world, FAKE_WORLD)
    if dist.is_initialized():
        if (dist.get_backend() == "fake" and dist.get_world_size() >= world
                and dist.get_rank() == 0):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_dtensor_mesh(mesh: Any, device_type: str = "cuda") -> Any:
    """``mesh``'s names and sizes as a ``torch.distributed`` device mesh
    over the ``fake`` backend, on its first ranks, seen from rank 0.
    ``device_type`` is the mesh's: ``"cuda"`` (the default, also for a
    ``meta`` trace, which touches no card) redistributes between splits
    with an all-to-all, as NCCL does; a ``"cpu"`` mesh gathers and slices
    instead, as gloo has no all-to-all."""
    from torch.distributed.device_mesh import DeviceMesh

    sizes = tuple(int(s) for s in mesh.axis_sizes)
    _fake_world(math.prod(sizes))
    return DeviceMesh(device_type, torch.arange(math.prod(sizes)).reshape(
        sizes), mesh_dim_names=tuple(mesh.axis_names))
