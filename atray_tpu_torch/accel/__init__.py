"""Acceleration structures: SAH BVH, 8-wide collapse, shaded leaf records."""
