"""Synthetic sparse-matrix generators (copy of ``repro.data``)."""
