"""The plain reference of the benchmark: a straightforward path tracer in
plain PyTorch (its own camera, random numbers, BVH, Möller–Trumbore and
shading), written apart from ``atray_tpu_torch`` and importing nothing of
it, so that it can judge what the program's timed path produced."""
