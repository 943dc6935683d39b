"""repro_torch.exec — the executor pipeline and its entry point."""
from .api import dispatch_count, execute, fused_trace_count

__all__ = ["execute", "dispatch_count", "fused_trace_count"]
