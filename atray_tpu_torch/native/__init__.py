"""Native host components (the SAH BVH builder), bound with ctypes."""

from atray_tpu_torch.native.bindings import available, build_bvh_native

__all__ = ["available", "build_bvh_native"]
