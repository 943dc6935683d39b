"""repro_torch.exec — the executor pipeline and its entry points."""
from .api import (
    NeutronSpMM, dispatch_count, execute, execute_delta_contribution,
    execute_matrix_path, execute_sddmm, execute_sharded, execute_spspmm,
    execute_vector_path, execute_with_delta, fused_trace_count,
    neutron_spmm, sharded_trace_count,
)

__all__ = ["execute", "execute_with_delta", "execute_sharded",
           "execute_delta_contribution",
           "execute_sddmm", "execute_spspmm",
           "execute_matrix_path", "execute_vector_path", "neutron_spmm",
           "NeutronSpMM", "dispatch_count", "fused_trace_count",
           "sharded_trace_count"]
