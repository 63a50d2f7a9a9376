"""Matrix products and convolutions at the reference's precision."""
from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32")
# TF32 keeps 10 of float32's 23 mantissa bits: the 13 low bits are
# rounded off (half away from zero on the magnitude)
_TF32_DROP = 13


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value, as a float32 tensor."""
    bits = x.contiguous().view(torch.int32)
    half = 1 << (_TF32_DROP - 1)
    rounded = (bits + half) & ~((1 << _TF32_DROP) - 1)
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


class _Operand(torch.autograd.Function):
    """An operand of a TF32 product: rounded going forward; its cotangent
    passes through (the product's backward already read TF32 operands)."""

    @staticmethod
    def forward(ctx, x):
        return to_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Product(torch.autograd.Function):
    """The output of a TF32 product: unchanged going forward (float32
    accumulation); its cotangent rounded to TF32 going back, as the
    backward's own TF32 products read it."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return to_tf32(g)


class Numerics:
    """`mm`, `conv2d`: float32 (TF32 off), or as TF32 tensor cores compute
    them (`precision="tf32"`): operands rounded to TF32 and float32
    accumulation, forward and backward alike (the backward's products
    read the rounded operands and a rounded cotangent)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(x) if self.precision == "tf32" else x

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        return _Product.apply(y) if self.precision == "tf32" else y

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._out(self._in(a) @ self._in(b))

    def conv2d(self, x, w, **kw) -> torch.Tensor:
        return self._out(F.conv2d(self._in(x), self._in(w), **kw))


def full_float32():
    """Pins matrix products and cuDNN convolutions to full float32 and
    cuDNN to deterministic algorithms, the precision the configuration
    states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
