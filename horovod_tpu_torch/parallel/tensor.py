"""Tensor (model) parallelism: Megatron's column / row sharded MLP.

Port of ``horovod_tpu/parallel/tensor.py``: ``column_row_parallel_mlp``
(``:21``), ``shard_columns`` (``:35``) and ``shard_rows`` (``:40``).
Each rank of the ``tp`` line holds a column shard of the up-projection
[d, f/n] and the matching row shard of the down-projection [f/n, d];
the first product needs no communication, the second gives a partial
sum that one allreduce over the line completes.

The gradients follow JAX's under its varying-axes types, where the
replicated loss makes the psum's transpose the identity: the output's
allreduce (:func:`reduce_from`) passes its cotangent back unchanged (a
backward that summed it would scale every gradient by n), and the
replicated input gets the mirror operation (:func:`copy_to`): the
identity forward, the sum of the ranks' partial input gradients in the
backward, so ``x``'s gradient is whole on every rank inside a larger
model.  Each sum is one ``hvd.allreduce`` over the axis's process set,
an engine dispatch as every collective of the port.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from . import axis as _axis
from .. import ops as _ops
from .moe import gelu


def _sum(x: torch.Tensor, ax) -> torch.Tensor:
    if ax.size == 1:
        return x
    return _ops.allreduce(x.contiguous(), op=_ops.Sum,
                          process_set=ax.process_set)


class _ReduceFrom(torch.autograd.Function):
    """Sum over the line; the backward passes the cotangent unchanged."""

    @staticmethod
    def forward(ctx, x, ax):
        return _sum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """The identity; the backward sums the cotangent over the line."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.ax), None


def reduce_from(x: torch.Tensor, ax) -> torch.Tensor:
    """JAX's ``lax.psum`` of a varying value into a replicated one, over
    the resolved axis ``ax`` (``parallel.axis``)."""
    return _ReduceFrom.apply(x, ax)


def copy_to(x: torch.Tensor, ax) -> torch.Tensor:
    """A replicated value entering per-rank work: JAX's implicit cast to
    varying, whose transpose sums over the axis."""
    return _CopyTo.apply(x, ax)


def column_row_parallel_mlp(x: torch.Tensor, w_col: torch.Tensor,
                            w_row: torch.Tensor, *, axis_name: str = "tp",
                            activation: Callable = gelu,
                            mesh=None) -> torch.Tensor:
    """Two-layer MLP with the hidden dim sharded over ``axis_name``: x
    [..., d] replicated, w_col [d, f/n], w_row [f/n, d]; returns [..., d],
    the same on every rank (one allreduce)."""
    ax = _axis(axis_name, mesh)
    h = activation(copy_to(x, ax) @ w_col)
    return reduce_from(h @ w_row, ax)


def _split(w: torch.Tensor, n: int, dim: int) -> List[torch.Tensor]:
    if w.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(w.shape)} does not split "
                         f"into {n} equal shards")
    return list(torch.chunk(w, n, dim=dim))


def shard_columns(w: torch.Tensor, n: int) -> List[torch.Tensor]:
    """Split [d, f] into n column shards [d, f/n]."""
    return _split(w, n, 1)


def shard_rows(w: torch.Tensor, n: int) -> List[torch.Tensor]:
    """Split [f, d] into n row shards [f/n, d]."""
    return _split(w, n, 0)
