"""Acceleration structures: SAH BVH, leaf packing, 8-wide collapse, shaded
and unshaded wide BVHs, and their refits."""
