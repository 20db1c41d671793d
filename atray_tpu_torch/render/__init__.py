"""Forward renderer: wavefront bounces, per-ray random numbers, film."""
