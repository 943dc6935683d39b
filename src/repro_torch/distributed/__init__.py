"""repro_torch.distributed — single-process device meshes: the sharded
SpMM executor's 1-D mesh and the LM stack's named mesh (:mod:`.mesh`),
and the LM stack's sharding rules (:mod:`.sharding`)."""
from .mesh import (
    DeviceMesh, SpmmMesh, active_mesh, make_mesh, make_spmm_mesh, use_mesh,
)

__all__ = ["DeviceMesh", "SpmmMesh", "active_mesh", "make_mesh",
           "make_spmm_mesh", "use_mesh"]
