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
* ``FlaxBatchNorm`` is ``flax.linen.BatchNorm``'s math (flax 0.12.3,
  ``flax/linen/normalization.py`` ``_compute_stats``, ``_normalize``):
  feature ``axis`` an int or a tuple, scale and bias in ``param_dtype``,
  statistics in at least f32 unless ``force_float32_reductions=False``,
  E[x²] − E[x]² clipped at 0 with ``use_fast_variance`` (mean and
  mean-of-squares averaged in ONE collective) or the two-pass variance
  without it, a call-time ``mask=``, and under ``axis_name`` each rank's
  means averaged over its set, or over its group of
  ``axis_index_groups`` (each group a process set, registered when the
  module is built).  As flax's ``pmean``, the average is of the ranks'
  means, not of their samples.
* ``SyncBatchNorm`` is ``FusedBatchNorm`` with sync on; a flax-only
  keyword (``axis``, ``param_dtype``, ``axis_index_groups``,
  ``use_fast_variance``, ``force_float32_reductions``) gives
  ``FlaxBatchNorm`` with sync on, as the JAX package's gives
  ``flax.linen.BatchNorm`` (``:175-190``).

Sync never falls back to local statistics: without ``hvd.init()`` it
raises, and a world of one still calls its collective.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

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


def _canonical_axes(ndim: int, axes) -> Tuple[int, ...]:
    """flax's ``_canonicalize_axes``: non-negative, sorted, unique."""
    if isinstance(axes, int):
        axes = (axes,)
    return tuple(sorted({a + ndim if a < 0 else a for a in axes}))


class FlaxBatchNorm(nn.Module):
    """``flax.linen.BatchNorm``'s fields and math in torch (module
    docstring).  ``num_features`` is the size of the feature axis, or the
    sizes of the feature axes in ascending axis order; the parameters
    ``scale`` / ``bias`` (``param_dtype``) and the buffers ``mean`` /
    ``var`` (f32, or ``param_dtype`` without f32 reductions) have that
    shape.  ``axis_name`` not None synchronizes the statistics over
    ``process_set`` (the world by default) or, with
    ``axis_index_groups``, over this rank's group; the groups must
    partition the world, and ``hvd.init()`` must run before the module is
    built, since registering a group is collective over the world."""

    def __init__(self, num_features: Union[int, Sequence[int]], *,
                 use_running_average: Optional[bool] = None,
                 axis: Union[int, Sequence[int]] = -1,
                 momentum: float = 0.99, epsilon: float = 1e-5,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 use_bias: bool = True, use_scale: bool = True,
                 bias_init: Callable = nn.init.zeros_,
                 scale_init: Callable = nn.init.ones_,
                 axis_name: Optional[str] = None,
                 axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
                 use_fast_variance: bool = True,
                 force_float32_reductions: bool = True, device=None,
                 process_set: ProcessSet = global_process_set):
        super().__init__()
        self.feature_shape = ((num_features,) if isinstance(num_features, int)
                              else tuple(num_features))
        self.use_running_average, self.axis = use_running_average, axis
        self.momentum, self.epsilon = momentum, epsilon
        self.dtype, self.param_dtype = dtype, param_dtype
        self.axis_name, self.process_set = axis_name, process_set
        self.use_fast_variance = use_fast_variance
        self.force_float32_reductions = force_float32_reductions
        self.axis_index_groups = axis_index_groups
        if axis_name is not None and axis_index_groups is not None:
            self.process_set = _group_set(axis_index_groups, process_set)
        stats = dict(dtype=torch.float32 if force_float32_reductions
                     else param_dtype, device=device)
        self.register_buffer("mean", torch.zeros(self.feature_shape, **stats))
        self.register_buffer("var", torch.ones(self.feature_shape, **stats))
        self.scale = self.bias = None
        params = dict(dtype=param_dtype, device=device)
        with torch.no_grad():
            if use_scale:
                self.scale = nn.Parameter(
                    scale_init(torch.empty(self.feature_shape, **params)))
            if use_bias:
                self.bias = nn.Parameter(
                    bias_init(torch.empty(self.feature_shape, **params)))

    def _pmean(self, stacked: torch.Tensor) -> torch.Tensor:
        """Average the stacked local means over the set: ONE collective
        (a Sum whose backward sums the cotangents), in at least f32."""
        if self.axis_name is None:
            return stacked
        wide = stacked.to(torch.promote_types(stacked.dtype, torch.float32))
        n = self.process_set.size() if self.process_set.included() else 1
        total = _AllreduceSum.apply(wide, self.process_set)
        return (total / n).to(stacked.dtype)

    def _stats(self, x, reduction_axes, mask):
        dtype = self.dtype if self.dtype is not None else x.dtype
        if self.force_float32_reductions:
            dtype = torch.promote_types(dtype, torch.float32)
        x = x.to(dtype)
        # jnp.mean sums a half type in f32 and rounds the mean once.
        acc = torch.promote_types(dtype, torch.float32)
        if mask is not None:
            mask = torch.broadcast_to(mask.to(torch.bool), x.shape)
            count = mask.sum(dim=reduction_axes).to(acc)

        def mean(t):
            if mask is None:
                return t.mean(dim=reduction_axes, dtype=acc).to(dtype)
            return (torch.where(mask, t, 0).sum(dim=reduction_axes, dtype=acc)
                    / count).to(dtype)

        if self.use_fast_variance:
            mu, mu2 = self._pmean(torch.stack([mean(x), mean(x.square())]))
            return mu, torch.clamp_min(mu2 - mu.square(), 0.0)
        mu = self._pmean(mean(x)[None])[0]
        shape = [1 if a in reduction_axes else n
                 for a, n in enumerate(x.shape)]
        var = self._pmean(mean((x - mu.reshape(shape)).square())[None])[0]
        return mu, var

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None, *,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (self.use_running_average is None) == (use_running_average
                                                  is None):
            raise ValueError("give use_running_average either to the "
                             "constructor or to the call, exactly once")
        ura = self.use_running_average if use_running_average is None \
            else use_running_average
        feature_axes = _canonical_axes(x.dim(), self.axis)
        reduction_axes = tuple(a for a in range(x.dim())
                               if a not in feature_axes)
        if tuple(x.shape[a] for a in feature_axes) != self.feature_shape:
            raise ValueError(
                f"input {list(x.shape)} has features "
                f"{[x.shape[a] for a in feature_axes]} on axes "
                f"{list(feature_axes)}, the module {list(self.feature_shape)}")
        if ura:
            mean, var = self.mean, self.var
            if not self.force_float32_reductions:
                mean, var = mean.to(self.param_dtype), var.to(self.param_dtype)
        else:
            mean, var = self._stats(x, reduction_axes, mask)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        shape = [1] * x.dim()
        for a in feature_axes:
            shape[a] = x.shape[a]
        y = x - mean.reshape(shape)
        mul = torch.rsqrt(var + self.epsilon).reshape(shape)
        out_dtype = x.dtype
        if self.scale is not None:
            mul = mul * self.scale.reshape(shape)
            out_dtype = torch.promote_types(out_dtype, self.scale.dtype)
        y = y * mul
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
            out_dtype = torch.promote_types(out_dtype, self.bias.dtype)
        if self.dtype is not None:
            out_dtype = self.dtype
        elif not out_dtype.is_floating_point:
            out_dtype = torch.promote_types(out_dtype, torch.float32)
        return y.to(out_dtype)


def _group_set(groups: Sequence[Sequence[int]],
               process_set: ProcessSet) -> ProcessSet:
    """Register every group of ``axis_index_groups`` as a process set, in
    the given order (collective over the world: every rank builds the
    module), and return this rank's."""
    from . import core as _core
    from .process_sets import add_process_set
    if not _core.is_initialized():
        raise ValueError(
            "axis_index_groups needs hvd.init() before the module is "
            "built: each group is registered as a process set on every "
            "rank, in one order")
    if process_set.process_set_id not in (None, 0) or \
            process_set.ranks is not None:
        raise ValueError("give axis_index_groups or a process_set, not both")
    groups = [sorted(int(r) for r in g) for g in groups]
    flat = sorted(r for g in groups for r in g)
    if flat != list(range(_core.num_slots())):
        raise ValueError(f"axis_index_groups {groups} must hold every rank "
                         f"of the world of {_core.num_slots()} once")
    sets = [add_process_set(g) for g in groups]
    me = _core.rank()
    return next(ps for ps, g in zip(sets, groups) if me in g)


#: FusedBatchNorm's keyword arguments (SyncBatchNorm routes here when the
#: caller stays inside them).
_FUSED_KWARGS = frozenset({
    "use_running_average", "axis_name", "momentum", "epsilon", "dtype",
    "use_bias", "use_scale", "bias_init", "scale_init", "device",
    "process_set"})

#: FlaxBatchNorm's: flax.linen.BatchNorm's fields, and the port's
#: ``device`` and ``process_set``.
_FLAX_KWARGS = _FUSED_KWARGS | {
    "axis", "param_dtype", "axis_index_groups", "use_fast_variance",
    "force_float32_reductions"}


def SyncBatchNorm(num_features: Union[int, Sequence[int]], **kwargs
                  ) -> nn.Module:
    """Batch norm synchronized over the world or a ``process_set`` (the
    ``hvd.SyncBatchNormalization`` analog): ``axis_name="hvd"`` unless the
    caller names another.  ``FusedBatchNorm`` when the keywords stay in
    its set, else ``FlaxBatchNorm`` (the JAX package's fallback to
    ``flax.linen.BatchNorm``)."""
    unknown = set(kwargs) - _FLAX_KWARGS
    if unknown:
        raise TypeError(f"SyncBatchNorm: unexpected keyword arguments "
                        f"{sorted(unknown)}; it takes {sorted(_FLAX_KWARGS)}")
    kwargs.setdefault("axis_name", "hvd")
    if set(kwargs) <= _FUSED_KWARGS:
        return FusedBatchNorm(num_features, **kwargs)
    return FlaxBatchNorm(num_features, **kwargs)
