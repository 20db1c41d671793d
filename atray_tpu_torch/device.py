"""The device an entry point runs on.

``render``, ``camera_rays``, ``make_loss_and_grad`` and every ``.to()`` of
a scene or accel take ``device=None``, which means ``"cuda"``: the port runs
on the card unless the caller asks for the CPU (``device="cpu"``, where the
plain PyTorch versions of the kernels run). Without a CUDA device a request
for one raises; nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``"cuda"``, and a CUDA
    device without an index gets the current one, so that it compares equal
    to the device of the tensors made there. Raises if a CUDA device is
    asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
