"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch versions.

Every wrapper takes the plain version for tensors on the CPU and launches
its CUDA kernel for tensors on a CUDA device; there is no fallback from one
to the other. ``_build.COUNTERS`` counts launches and plain calls.
"""
