"""Hand-written Hopper kernels, their plain versions and the per-path dispatch.

Importing this package builds nothing: kernels are compiled at first use
(``kernels._build``).
"""
