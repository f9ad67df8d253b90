"""The device an entry point runs on when the caller names none.

``None`` means the card.  Asking for CUDA without a card raises: there
is no silent fallback to the CPU, so a caller who wants the plain path
passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; asking for CUDA without one raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the port's plain path on the CPU")
    return device
