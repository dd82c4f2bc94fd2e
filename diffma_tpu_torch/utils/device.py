"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. Without a
GPU they raise: they never drop to the CPU on their own. On the card they
turn TF32 off for cuBLAS and cuDNN, so that every product and convolution
runs in fp32, the precision ``chip_smoke.py`` checks the kernels and the
plain versions at (PyTorch leaves cuDNN's TF32 on by default).
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
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
