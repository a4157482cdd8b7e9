"""Device resolution for the port's entry points.

Every public constructor that creates tensors takes ``device=`` with the
default ``"cuda"``.  Without a CUDA device that default raises: the port
never carries on silently on the CPU.  Tests and CPU runs pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no CUDA
    device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU")
    return dev
