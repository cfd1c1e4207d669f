"""Synchronized batch normalization across ranks.

Port of ``horovod_tpu/sync_batch_norm.py``: ``sync_batch_stats``
(``:22``), ``FusedBatchNorm`` (``:58``) and ``SyncBatchNorm`` (``:175``),
the ``hvd.SyncBatchNormalization`` analog.

* ``sync_batch_stats`` reduces the concatenated (sum, sum of squares,
  count) vector with ONE Sum allreduce.  The allreduce is an
  ``autograd.Function`` whose backward allreduces the cotangent of the
  same vector, as the transpose of the JAX package's in-step psum does: a
  rank's statistics feed every rank's loss, so each rank's input gradient
  needs the sum of every rank's statistics-cotangent.  A plain
  ``dist.all_reduce`` would drop those cross-rank terms silently.  Over
  a ``process_set`` the sums run over its members, and a rank outside
  it keeps its own statistics, as ``C.allreduce(members=...)`` gives it
  in JAX (``:48``).
* ``FusedBatchNorm`` takes its statistics in f32 over every axis but the
  last (the features, as flax's), keeps f32 running ``mean`` / ``var``
  buffers updated as ``m * running + (1 - m) * batch`` with the biased
  variance (flax's convention, not ``nn.BatchNorm2d``'s), and applies the
  folded per-channel ``a = scale * rsqrt(var + eps)``, ``b = bias - mean *
  a`` in the apply ``dtype`` (``None``: the input's type promoted with
  f32).
* ``SyncBatchNorm`` is ``FusedBatchNorm`` with sync on.  The flax-only
  keyword arguments the JAX package hands to ``flax.linen.BatchNorm``
  (``axis``, ``axis_index_groups``, ``param_dtype``, ...) are not ported
  (ROADMAP A3) and raise.

Sync never falls back to local statistics: without ``hvd.init()`` it
raises, and a world of one still calls its collective.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from . import ops as _ops
from .process_sets import ProcessSet, global_process_set

# The statistics allreduces made, forward and backward (a step of a
# synchronized network makes one of each per batch norm).
STATS_ALLREDUCES = {"forward": 0, "backward": 0}


class _AllreduceSum(torch.autograd.Function):
    """Sum over the set, forward and backward."""

    @staticmethod
    def forward(ctx, vec, process_set):
        ctx.process_set = process_set
        STATS_ALLREDUCES["forward"] += 1
        return _ops.allreduce(vec, op=_ops.Sum, process_set=process_set)

    @staticmethod
    def backward(ctx, grad):
        STATS_ALLREDUCES["backward"] += 1
        return _ops.allreduce(grad, op=_ops.Sum,
                              process_set=ctx.process_set), None


def sync_batch_stats(x: torch.Tensor, *,
                     reduction_axes: Optional[Sequence[int]] = None,
                     process_set: ProcessSet = global_process_set
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and (biased) variance of ``x`` over ``reduction_axes`` (every
    axis but the last by default) and over every rank, from one
    differentiable Sum allreduce of (sum, sum of squares, count).  Over a
    ``process_set``, a rank outside the set gets its own statistics (and
    its own cotangent back)."""
    if reduction_axes is None:
        reduction_axes = tuple(range(x.dim() - 1))
    reduction_axes = tuple(reduction_axes)
    n_local = 1
    for a in reduction_axes:
        n_local *= x.shape[a]
    s = x.sum(dim=reduction_axes)
    sq = x.square().sum(dim=reduction_axes)
    shape, k = s.shape, s.numel()
    vec = torch.cat([s.reshape(-1), sq.reshape(-1),
                     torch.full((1,), n_local, dtype=x.dtype,
                                device=x.device)])
    vec = _AllreduceSum.apply(vec, process_set)
    s, sq, cnt = vec[:k].reshape(shape), vec[k:2 * k].reshape(shape), vec[-1]
    mean = s / cnt
    # E[x^2] - E[x]^2 can go epsilon-negative in finite precision.
    var = torch.clamp_min(sq / cnt - mean.square(), 0.0)
    return mean, var


class FusedBatchNorm(nn.Module):
    """Batch norm over the last axis with f32 statistics and a folded
    apply (``horovod_tpu/sync_batch_norm.py:99-159``).  ``axis_name`` not
    None synchronizes the statistics over ``process_set`` (the world by
    default);
    ``use_running_average`` is given here or at the call, not both, as
    flax's ``merge_param``."""

    def __init__(self, num_features: int, *,
                 use_running_average: Optional[bool] = None,
                 axis_name: Optional[str] = None, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 use_bias: bool = True, use_scale: bool = True,
                 bias_init: Callable = nn.init.zeros_,
                 scale_init: Callable = nn.init.ones_, device=None,
                 process_set: ProcessSet = global_process_set):
        super().__init__()
        self.use_running_average = use_running_average
        self.axis_name, self.process_set = axis_name, process_set
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("mean", torch.zeros(num_features, **f32))
        self.register_buffer("var", torch.ones(num_features, **f32))
        self.scale = self.bias = None
        with torch.no_grad():
            if use_scale:
                self.scale = nn.Parameter(
                    scale_init(torch.empty(num_features, **f32)))
            if use_bias:
                self.bias = nn.Parameter(
                    bias_init(torch.empty(num_features, **f32)))

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        if (self.use_running_average is None) == (use_running_average
                                                  is None):
            raise ValueError("give use_running_average either to the "
                             "constructor or to the call, exactly once")
        ura = self.use_running_average if use_running_average is None \
            else use_running_average
        if ura:
            mean, var = self.mean, self.var
        else:
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            if self.axis_name is not None:
                mean, var = sync_batch_stats(
                    xf, reduction_axes=axes, process_set=self.process_set)
            else:
                mean = xf.mean(dim=axes)
                var = torch.clamp_min(
                    xf.square().mean(dim=axes) - mean.square(), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        a = torch.rsqrt(var + self.epsilon)
        if self.scale is not None:
            a = a * self.scale
        b = -mean * a
        if self.bias is not None:
            b = b + self.bias
        dtype = self.dtype if self.dtype is not None else \
            torch.promote_types(x.dtype, torch.float32)
        return x.to(dtype) * a.to(dtype) + b.to(dtype)


#: FusedBatchNorm's keyword arguments (SyncBatchNorm takes these only).
_FUSED_KWARGS = frozenset({
    "use_running_average", "axis_name", "momentum", "epsilon", "dtype",
    "use_bias", "use_scale", "bias_init", "scale_init", "device",
    "process_set"})


def SyncBatchNorm(num_features: int, **kwargs) -> FusedBatchNorm:
    """Batch norm synchronized over the world or a ``process_set`` (the
    ``hvd.SyncBatchNormalization`` analog): ``FusedBatchNorm`` with
    ``axis_name="hvd"`` unless the caller names another."""
    unknown = set(kwargs) - _FUSED_KWARGS
    if unknown:
        raise NotImplementedError(
            f"SyncBatchNorm: {sorted(unknown)} are flax BatchNorm options "
            f"the port does not have (ROADMAP A3); it takes "
            f"{sorted(_FUSED_KWARGS)}")
    kwargs.setdefault("axis_name", "hvd")
    return FusedBatchNorm(num_features, **kwargs)
