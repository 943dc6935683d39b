"""repro_torch — PyTorch/CUDA port of NeutronSparse for the NVIDIA H100.

Mirrors ``repro`` (the JAX package, which stays the reference): host plan
building in ``core``, per-path dispatch and the hand-written Hopper kernels
in ``kernels``, the executor in ``exec``, and the ``sparse`` facade on top.
Imports ``torch`` and numpy, never ``jax`` or ``repro``.
"""
