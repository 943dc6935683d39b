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
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

from ..distributed.mesh import DeviceMesh, make_spmm_mesh

__all__ = ["make_production_mesh", "make_debug_mesh", "mesh_axis_sizes",
           "make_spmm_mesh"]

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
