"""Device resolution shared by the port's entry points.

Every entry point runs on ``"cuda"`` unless the caller names another
device, and never falls back to the CPU on its own: asking for CUDA on a
machine without a card raises.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` (None = ``DEFAULT_DEVICE``) as a ``torch.device``; raises
    ``RuntimeError`` for a CUDA device when no card is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
