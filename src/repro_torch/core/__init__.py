"""Host-side plan building: cost model, partition, reorder, reuse, plan IR."""
