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
half (``AxisRules``, ``param_specs``, ...) belongs to the LM stack.
"""
from __future__ import annotations

import dataclasses
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
