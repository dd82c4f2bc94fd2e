"""The reference's products, in fp32 or, for the control, in TF32.

Every matrix product and convolution of the reference goes through a
``Products``. In fp32 (the precision the configurations state) it is plain
``torch.matmul`` and ``F.conv2d`` with TF32 switched off on the card. The
control computes the same products in TF32, the nearest precision below:
each operand rounded to TF32's 10 mantissa bits (round to nearest even),
the sums in fp32, as the card's tensor cores do with TF32 on. The rounding
is done by hand so that the control reads the same on the card and on the
CPU, where its test runs. In TF32 the backward's two products round their
operands the same way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["Products", "round_tf32", "tf32_off"]


def tf32_off() -> None:
    """Every cuBLAS and cuDNN product in fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10 mantissa bits, to nearest even)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` on TF32 operands with fp32 sums; batch dims of equal size."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return (torch.matmul(g, round_tf32(b).transpose(-1, -2)),
                torch.matmul(round_tf32(a).transpose(-1, -2), g))


class Products:
    """Matrix products and convolutions in fp32, or in TF32 with ``tf32``."""

    def __init__(self, tf32: bool = False):
        self.tf32 = bool(tf32)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b``; a and b share their batch dims (no broadcasting)."""
        if not self.tf32:
            return torch.matmul(a, b)
        return _TF32MatMul.apply(a, b)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        """x (..., k) times w (out, k) transposed, plus b."""
        lead = x.shape[:-1]
        y = self.matmul(x.reshape(-1, x.shape[-1]), w.t()).reshape(*lead, w.shape[0])
        return y if b is None else y + b

    def conv2d(self, x, w, b=None, **kw) -> torch.Tensor:
        if self.tf32:
            x, w = round_tf32(x), round_tf32(w)
        return F.conv2d(x, w, b, **kw)
