"""Native host components (the SAH BVH builder and the OBJ parser), bound
with ctypes."""

from atray_tpu_torch.native.bindings import available, build_bvh_native, parse_obj_native

__all__ = ["available", "build_bvh_native", "parse_obj_native"]
