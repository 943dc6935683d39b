"""repro_torch.exec — the executor pipeline and its entry points."""
from .api import (
    NeutronSpMM, dispatch_count, execute, execute_matrix_path, execute_sddmm,
    execute_vector_path, fused_trace_count, neutron_spmm,
)

__all__ = ["execute", "execute_sddmm", "execute_matrix_path",
           "execute_vector_path", "neutron_spmm", "NeutronSpMM",
           "dispatch_count", "fused_trace_count"]
