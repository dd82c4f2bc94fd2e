"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. Without a
GPU they raise: they never drop to the CPU on their own.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
