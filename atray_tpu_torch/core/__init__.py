"""Geometry core: vector helpers and the pinhole camera."""
