"""Runnable examples of the port, started from the repository root as
modules (``python3 -m atray_tpu_torch.examples.render_demo``)."""
