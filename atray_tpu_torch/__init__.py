"""ATRay on PyTorch + CUDA: the render, gradient and training paths of
``atray_tpu``.

Module paths mirror the JAX package (``atray_tpu``), which stays the
reference: ``atray_tpu_torch.accel.shaded`` is the counterpart of
``atray_tpu.accel.shaded`` and so on. Scene authoring and BVH building are
host numpy; ``.to(device)`` uploads once. ``render.wavefront.render`` and
``dist.train`` run on the device they are given (``device=None`` means
"cuda"): the hand-written Hopper kernels (``csrc/``) on a CUDA device, their
plain PyTorch versions on the CPU.

Importing this package imports neither ``jax`` nor ``atray_tpu``, and
builds nothing: the CUDA kernels compile at their first launch.
"""
