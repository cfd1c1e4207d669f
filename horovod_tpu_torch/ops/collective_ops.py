"""Reduce operators and the pre/post scale, in torch.

Port of ``ReduceOp`` and its aliases (``horovod_tpu/ops/collective_ops.py
:53-69``) and ``_apply_scale`` (``:72``), plus the one reduction the
eager collectives share: AVERAGE is a SUM followed by a division by the
member count (floor division for integers), on gloo and NCCL alike.
Gloo has no AVG, and one formula keeps the CPU and the card identical.
"""

from __future__ import annotations

import enum

import torch
import torch.distributed as dist


class ReduceOp(enum.IntEnum):
    """Reduction operators (the reference's ``message.h:43`` numbering)."""
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

_DIST_OPS = {ReduceOp.AVERAGE: dist.ReduceOp.SUM, ReduceOp.SUM: dist.ReduceOp.SUM,
             ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def _apply_scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x * factor``; f16/bf16 scale in f32 and round once, integers
    truncate back to their dtype (the JAX package's rules)."""
    if factor == 1.0:
        return x
    if x.dtype in (torch.bfloat16, torch.float16):
        return (x.float() * factor).to(x.dtype)
    if not x.is_floating_point() and not x.is_complex():
        return (x * factor).to(x.dtype)
    return x * factor


def allreduce_(buf: torch.Tensor, op: ReduceOp, n: int) -> torch.Tensor:
    """Reduce ``buf`` in place over the world and return the reduced
    tensor (a new one for AVERAGE)."""
    op = ReduceOp(op)
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP A5)")
    try:
        dist.all_reduce(buf, op=_DIST_OPS[op])
    except RuntimeError as e:
        raise RuntimeError(
            f"allreduce of a {buf.dtype} tensor on {buf.device} failed on "
            f"the {dist.get_backend()} backend: {e}") from e
    if op == ReduceOp.AVERAGE:
        if buf.is_floating_point() or buf.is_complex():
            return buf / n
        return torch.div(buf, n, rounding_mode="floor")
    return buf
