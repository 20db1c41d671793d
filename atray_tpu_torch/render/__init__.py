"""Renderer: wavefront bounces with path-replay gradients, per-ray random
numbers, textures, film and BMP output, AOV passes, progressive rendering
and per-chunk telemetry."""
