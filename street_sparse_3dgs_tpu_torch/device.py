"""Device resolution for the functions that create tensors.

Those functions take ``device=`` and default to ``"cuda"``.  A CUDA device
requested on a machine without one raises: the port never falls back to the
CPU on its own, so a run that reports card numbers really ran on the card.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises if it is CUDA and no CUDA
    device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
