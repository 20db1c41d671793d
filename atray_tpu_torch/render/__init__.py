"""Renderer: wavefront bounces with path-replay gradients, per-ray random
numbers, film."""
