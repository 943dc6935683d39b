"""repro_torch.exec — the executor pipeline and its entry point."""
from .api import dispatch_count, execute, execute_sddmm, fused_trace_count

__all__ = ["execute", "execute_sddmm", "dispatch_count", "fused_trace_count"]
