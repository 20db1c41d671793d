"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch versions.

Every wrapper takes the plain version for tensors on the CPU and launches
its CUDA kernel for tensors on a CUDA device; there is no fallback from one
to the other. ``_build.COUNTERS`` counts launches and plain calls.

The four lineage walks are entry points of their own, with
``accel.traverse.bvh_first_hit``'s contract, as the JAX package exports
``pallas_first_hit``.
"""

from atray_tpu_torch.kernels.frustum_walk import frustum_first_hit
from atray_tpu_torch.kernels.packet_walk import packet_first_hit
from atray_tpu_torch.kernels.persistent_wide import persistent_first_hit
from atray_tpu_torch.kernels.wide_frustum import wide_first_hit

__all__ = ["frustum_first_hit", "packet_first_hit", "persistent_first_hit", "wide_first_hit"]
