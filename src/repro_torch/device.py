"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU; asking
for the card where there is none raises instead of carrying on silently
on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain torch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device``. Host data bound
    for a card goes through pinned memory with ``non_blocking=True``, so
    the copy is ordered on the current stream and never waits for it."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.ascontiguousarray(x))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
