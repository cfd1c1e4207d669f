"""Every product of the reference goes through :class:`Products`.

``f32``: a float32 matmul with TF32 off (the reference).
``fp8``: each operand rounded to float8 e4m3 with a per-tensor scale
from its largest magnitude, and each incoming gradient to e5m2, the
products taken in f32 from the rounded values: the usual fp8 training
recipe, one precision below the bf16 products the configurations
state.  It is the correctness check's control.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("f32", "fp8")


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to the format's largest finite value."""
    fmax = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = fmax / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


def _sum_to(x: torch.Tensor, shape) -> torch.Tensor:
    while x.dim() > len(shape):
        x = x.sum(dim=0)
    return x


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8 = _round(a, torch.float8_e4m3fn)
        b8 = _round(b, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b8)
        ctx.shapes = (a.shape, b.shape)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _round(g, torch.float8_e5m2)
        ga = _sum_to(torch.matmul(g8, b8.transpose(-1, -2)), ctx.shapes[0])
        gb = _sum_to(torch.matmul(a8.transpose(-1, -2), g8), ctx.shapes[1])
        return ga, gb


class Products:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"unknown product mode {mode!r}; {MODES}")
        self.mode = mode

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            return _Fp8Matmul.apply(a, b)
        return torch.matmul(a, b)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the reference's matmuls, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
