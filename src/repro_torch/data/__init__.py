"""Synthetic data (copies of ``repro.data``): the sparse-matrix generators
and the deterministic LM batch pipeline."""
