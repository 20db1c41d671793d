"""ATRay on PyTorch + CUDA: the forward render path of ``atray_tpu``.

Module paths mirror the JAX package (``atray_tpu``), which stays the
reference: ``atray_tpu_torch.accel.shaded`` is the counterpart of
``atray_tpu.accel.shaded`` and so on. Scene authoring and BVH building are
host numpy; ``Scene.to(device)`` and ``ShadedWideBVH.to(device)`` upload
once, and ``render.wavefront.render`` runs on whatever device the scene's
tensors live on: the plain PyTorch versions on the CPU, the hand-written
Hopper kernels (``csrc/``) on a CUDA device.

Importing this package imports neither ``jax`` nor ``atray_tpu``, and
builds nothing: the CUDA kernels compile at their first launch.
"""
