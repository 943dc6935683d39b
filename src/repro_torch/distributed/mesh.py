"""The device mesh of the sharded SpMM executor: one process, one tuple of
devices.

The reference runs a sharded plan as one ``shard_map`` program over a 1-D
``jax.sharding.Mesh``, driven by one controller.  The port keeps that
shape: a mesh is a 1-D tuple of ``torch.device``s, and the sharded
executor (``exec.pipeline``) launches the same per-shard body once per
shard, on that shard's device, from one process.  No process group and no
collective is involved: B reaches each device with ``.to(device)``, and the
packed shard outputs are gathered on the mesh's first device.

A device may repeat.  ``[cuda:0] * 4`` is a 4-way mesh on one card (its
shards run one after the other there), and ``[cpu] * n`` is the CPU mesh
the tests use: the counterpart of the reference's forced host device
count, with no environment to set.

Of the reference's ``distributed/sharding.py`` this is the ``shard_map``
half (the spec helpers are the executor's per-shard slicing); the model
half (``AxisRules``, ``param_specs``, ...) is :mod:`.sharding`.

The LM stack's ``shard_map`` MoE (``models.moe.apply_moe_shard_map``)
runs over a named n-D :class:`DeviceMesh` (``("data", "model")`` by
default, devices again in one process and free to repeat), installed as
the ambient mesh with :func:`use_mesh`, as the reference reads JAX's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SpmmMesh:
    """A 1-D mesh: ``devices[s]`` runs shard ``s``.

    ``axis_names`` and ``shape`` read as the reference's mesh does
    (``prepare_sharded`` reads only those two), so code written against a
    ``jax.sharding.Mesh`` finds the same names here.
    """

    devices: Tuple[torch.device, ...]
    axis_name: str = "data"

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis_name,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device that receives B and holds the assembled result."""
        return self.devices[0]

    @property
    def uniform(self) -> bool:
        """True when every shard runs on one device."""
        return len(set(self.devices)) == 1

    def __repr__(self) -> str:
        return (f"SpmmMesh({self.axis_name}={self.size}: "
                f"{', '.join(str(d) for d in self.devices)})")


def _device_index(d: torch.device) -> torch.device:
    """``cuda`` names the current card: give it its index, so that meshes
    over "cuda" and "cuda:0" compare equal."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_spmm_mesh(n_shards: int = 0, axis_name: str = "data",
                   devices: Optional[Sequence[Any]] = None) -> SpmmMesh:
    """A 1-D mesh for the sharded SpMM executor.

    ``devices`` names each shard's device, repeats allowed (``["cpu"] * 4``
    for the CPU tests, ``["cuda:0"] * 4`` for a 4-way mesh on one card);
    ``n_shards``, when given with it, must equal its length.  Without
    ``devices`` the mesh takes the visible CUDA devices: all of them for
    ``n_shards=0``, else the first ``n_shards``.  Asking for more shards
    than there are cards raises: a smaller mesh is never made quietly, and
    a mesh that repeats a card is asked for by name.
    """
    if devices is not None:
        devs = tuple(_device_index(torch.device(d)) for d in devices)
        if n_shards and n_shards != len(devs):
            raise ValueError(
                f"n_shards={n_shards} disagrees with the {len(devs)} "
                "devices given")
        return SpmmMesh(devs, axis_name)
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_shards or avail
    if n < 1 or n > avail:
        raise ValueError(
            f"requested {n_shards or 'every'} shard(s) but {avail} CUDA "
            "device(s) are visible; pass devices= to place shards (a device "
            "may repeat, e.g. ['cuda:0'] * 4 or ['cpu'] * 4)")
    return SpmmMesh(tuple(torch.device("cuda", i) for i in range(n)),
                    axis_name)


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """An n-D mesh with named axes: ``devices`` row-major over
    ``axis_names`` (sizes ``axis_sizes``); a device may repeat."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data", "model")
    axis_sizes: Tuple[int, ...] = (1, 1)

    def __post_init__(self):
        devs = tuple(_device_index(torch.device(d)) for d in self.devices)
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("one size per axis name")
        if len(devs) != math.prod(self.axis_sizes) or not devs:
            raise ValueError(f"{len(devs)} devices for a mesh of "
                             f"{self.axis_sizes}")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def device(self, coords: Dict[str, int]) -> torch.device:
        """The device at ``coords`` (axis name -> index; axes left out
        are at 0)."""
        idx = 0
        for name, size in zip(self.axis_names, self.axis_sizes):
            i = coords.get(name, 0)
            if not 0 <= i < size:
                raise IndexError(f"{name}={i} outside 0..{size - 1}")
            idx = idx * size + i
        return self.devices[idx]


def make_mesh(axis_sizes: Sequence[int],
              axis_names: Sequence[str] = ("data", "model"),
              devices: Optional[Sequence[Any]] = None) -> DeviceMesh:
    """A named mesh, as ``jax.make_mesh(axis_sizes, axis_names)``.

    ``devices`` lists the mesh's devices row-major, repeats allowed
    (``["cpu"] * 4`` for a 2 x 2 CPU mesh, ``["cuda:0"] * 4`` for one on a
    card); without it the mesh takes the first visible CUDA devices and
    raises when there are fewer than it needs.
    """
    sizes = tuple(int(n) for n in axis_sizes)
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        need = math.prod(sizes)
        if need > avail:
            raise ValueError(
                f"a mesh of {sizes} needs {need} devices and {avail} CUDA "
                "device(s) are visible; pass devices= (a device may repeat)")
        devices = [torch.device("cuda", i) for i in range(need)]
    return DeviceMesh(tuple(devices), tuple(axis_names), sizes)


_AMBIENT: Dict[str, Optional[DeviceMesh]] = {"mesh": None}


@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh]):
    """Install ``mesh`` as the ambient mesh inside the ``with`` block."""
    prev = _AMBIENT["mesh"]
    _AMBIENT["mesh"] = mesh
    try:
        yield mesh
    finally:
        _AMBIENT["mesh"] = prev


def active_mesh() -> Optional[DeviceMesh]:
    return _AMBIENT["mesh"]
