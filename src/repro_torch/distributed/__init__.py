"""repro_torch.distributed — the single-process device mesh of the sharded
SpMM executor (:mod:`.mesh`)."""
from .mesh import SpmmMesh, make_spmm_mesh

__all__ = ["SpmmMesh", "make_spmm_mesh"]
