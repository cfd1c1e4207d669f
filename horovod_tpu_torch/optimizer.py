"""The gradient layer: ``DistributedOptimizer`` and its relatives.

Port of ``horovod_tpu/optimizer.py:345-659`` around ``torch.optim``
optimizers.  The semantics are the JAX package's, not Horovod-torch's
per-parameter hooks.

``DistributedOptimizer``:

* ``step()`` adds each parameter's ``grad`` (this pass's gradient; call
  ``zero_grad()`` before each backward) to its own f32 accumulator;
* on every ``backward_passes_per_step``-th call it divides the sums by
  that count, reduces them over the world, writes the result into each
  ``grad``, and calls the wrapped optimizer's ``step()``;
* between those calls neither the parameters nor the wrapped
  optimizer's state change (``:480-489``).

Gradients reduce as ``_allreduce_tree`` reduces them (``:231-290``):
Average and Sum under an elementwise compressor (``Compression.none``,
``fp16``, ``bf16``) are bucketed by the fusion planner up to
``HOROVOD_FUSION_THRESHOLD`` (or the threshold the autotuner explores,
``autotune.py``, which scores each window), one flat buffer and one collective per
bucket (``_fused_allreduce``); Adasum, and any other ``Compressor``,
reduce tensor by tensor, so each tensor gets its own Adasum coefficients
or its own compression (a per-tensor quantizer's scale, say).
``groups`` / ``num_groups`` make each group one grouped allreduce, the
planner bypassed, as in JAX.

With ``process_set``, the gradients reduce over the set's ranks, and a
rank outside the set steps on its own gradients (the JAX package's
non-member passthrough).  ``reduce_axes=("dp", "sp")`` (``:354``)
reduces each gradient by ``_reduce_multi_axis_leaf``'s rule
(``:122-157``): summed over the process set spanning ``reduce_axes``
less the axes its parameter is sharded over (``parallel.mark_sharded``:
expert weights over ``"ep"`` are summed over ``"dp"`` alone, since each
``"ep"`` member holds other experts), and under Average divided by the
product of the sizes of all of ``reduce_axes``, the global token mean
when the batch is split over every listed axis.  Parameters with
different reduce sets never share a fusion bucket; those sharded over
none of the axes reduce as before, Average over the set spanning them.
``reduce_axes`` takes Average and Sum.  The optimizer supports ``op``
(Average, Sum, Adasum), ``compression`` and
``gradient_predivide_factor`` (``:320-330``, Average only: prescale
1/f, postscale f).  ``named_parameters`` is accepted and
ignored, as in JAX.  ``zero_grad``, ``param_groups`` and ``state`` pass
through to the wrapped optimizer.  ``state_dict`` is the wrapped
optimizer's, with the local-aggregation accumulators (``hvd_acc``, None
before the first pass) and the passes of the open cycle
(``hvd_passes``) beside it, so ``load_state_dict`` resumes a cycle
mid-flight, as JAX's optax state carries its counter.

Also here: ``PartialDistributedOptimizer`` (``:496``), which keeps the
gradients ``local_filter`` picks local; ``adasum_delta_step`` (``:549``),
Adasum on the wrapped optimizer's parameter deltas; and the gradient-tape
functions ``local_value_and_grad`` (``:532``), ``value_and_grad`` and
``grad`` (``:618-644``).  ``distributed_gradient_transformation`` is
optax's form of the optimizer and has no torch counterpart.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree

from . import core as _core
from . import ops as _ops
from .compression import Compression
from .ops import ReduceOp
from .ops.adasum import adasum_allreduce
from .ops.fusion import plan_fusion
from .process_sets import ProcessSet, global_process_set

# compress(concat(ts)) == concat(compress(t) for t in ts) holds for these
# casts only, so only they may compress a fusion bucket once.
_ELEMENTWISE = (Compression.none, Compression.fp16, Compression.bf16)


def _allreduce_list(grads: Sequence[torch.Tensor], op: ReduceOp,
                    compression, prescale: float, postscale: float,
                    process_set: ProcessSet,
                    groups: Optional[List[List[int]]] = None
                    ) -> List[torch.Tensor]:
    """Reduce a list of gradients by the JAX package's ``_allreduce_tree``
    rules: each of ``groups`` as one grouped allreduce; else Average and
    Sum under an elementwise compressor through the fusion planner, one
    ``_fused_allreduce`` per bucket; else tensor by tensor."""
    kw = dict(op=op, compression=compression, prescale_factor=prescale,
              postscale_factor=postscale, process_set=process_set)
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    if groups is None and (op not in (ReduceOp.AVERAGE, ReduceOp.SUM)
                           or compression not in _ELEMENTWISE):
        groups = [list(range(len(grads)))]
    if groups is not None:
        for g in groups:
            for i, r in zip(g, _ops.grouped_allreduce(
                    [grads[i] for i in g], **kw)):
                out[i] = r
        return out
    st = _core._require_init()
    pm = st.param_manager
    threshold = pm.fusion_threshold_bytes if pm is not None else \
        st.config.fusion_threshold_bytes
    entries = [(str(i), str(g.dtype), g.numel() * g.element_size(),
                int(op), 0) for i, g in enumerate(grads)]
    t0 = time.perf_counter()
    for bucket in plan_fusion(entries, threshold):
        for i, r in zip(bucket, _ops._fused_allreduce(
                [grads[i] for i in bucket], **kw)):
            out[i] = r
    if pm is not None and pm.enabled and not pm.converged and \
            len(grads) > 1:
        # Autotune scores this window (JAX's optimizer.py:286-289): the
        # reductions are asynchronous on a card, so wait for them where
        # JAX blocks on its arrays.
        if grads[0].is_cuda:
            torch.cuda.synchronize(grads[0].device)
        pm.record_sample(sum(e[2] for e in entries),
                         time.perf_counter() - t0)
    return out


def _reduce_axes_set(reduce_axes, op, compression, groups,
                     process_set) -> ProcessSet:
    """The process set ``reduce_axes`` names, with the JAX package's
    refusals (``optimizer.py:390-401``, ``:172-192``)."""
    from .parallel import axes_process_set
    if process_set is not global_process_set:
        raise ValueError("reduce_axes and process_set are mutually "
                         "exclusive (subset semantics live on the 1-D "
                         "framework axis)")
    if compression is not Compression.none or groups:
        raise ValueError("compression/groups are not supported with "
                         "reduce_axes")
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(f"reduce_axes supports Sum/Average gradients, "
                         f"got {op!r}")
    return axes_process_set(reduce_axes)


def _param_names(params: Sequence[torch.nn.Parameter], named_parameters
                 ) -> List[str]:
    """Each parameter's name from ``named_parameters``, else its index in
    the optimizer's parameter order, as a string."""
    if named_parameters is None:
        return [str(i) for i in range(len(params))]
    names = {id(p): n for n, p in named_parameters}
    try:
        return [names[id(p)] for p in params]
    except KeyError:
        raise ValueError("named_parameters must name every parameter of "
                         "the wrapped optimizer") from None


def _optimizer_params(optimizer: torch.optim.Optimizer
                      ) -> List[torch.nn.Parameter]:
    return [p for g in optimizer.param_groups for p in g["params"]]


class DistributedOptimizer:
    """Wrap ``optimizer`` with Horovod's gradient reduction
    (``hvd.DistributedOptimizer``)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 gradient_predivide_factor: float = 1.0,
                 num_groups: int = 0, groups=None,
                 process_set: ProcessSet = global_process_set,
                 reduce_axes: Optional[Sequence[str]] = None):
        del named_parameters  # API parity: parameter order is the contract
        op = ReduceOp(op)
        if op not in (ReduceOp.AVERAGE, ReduceOp.SUM, ReduceOp.ADASUM):
            raise ValueError(f"gradients reduce with Average, Sum or "
                             f"Adasum, got {op!r}")
        if reduce_axes is not None:
            process_set = _reduce_axes_set(reduce_axes, op, compression,
                                           groups or num_groups,
                                           process_set)
        if gradient_predivide_factor != 1.0:
            if op != ReduceOp.AVERAGE:
                raise ValueError("gradient_predivide_factor supported only "
                                 "with op=Average (torch/optimizer.py:64)")
            self._prescale = 1.0 / gradient_predivide_factor
            self._postscale = gradient_predivide_factor
        else:
            self._prescale = self._postscale = 1.0
        self.optimizer = optimizer
        self.op = op
        self.compression = compression
        self.process_set = process_set
        self.backward_passes_per_step = max(1, int(backward_passes_per_step))
        self._params = _optimizer_params(optimizer)
        if num_groups and groups is None:
            groups = num_groups
        self._groups = self._index_groups(groups)
        self._acc: Optional[List[torch.Tensor]] = None
        self._passes = 0
        self._axis_sets = None if reduce_axes is None else \
            _axis_sets(self._params, tuple(reduce_axes))

    def _index_groups(self, groups) -> Optional[List[List[int]]]:
        if not groups:
            return None
        n = len(self._params)
        if isinstance(groups, int):
            return [g.tolist() for g in np.array_split(np.arange(n), groups)
                    if len(g)]
        where = {id(p): i for i, p in enumerate(self._params)}
        out = []
        for g in groups:
            try:
                out.append([where[id(p)] for p in g])
            except KeyError:
                raise ValueError("groups must list parameters of the "
                                 "wrapped optimizer") from None
        return out

    # -- the wrapped optimizer ---------------------------------------------

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        """The wrapped optimizer's ``state_dict`` with ``hvd_acc`` and
        ``hvd_passes`` beside it.  Like torch's, it holds references to
        the live tensors: copy it to keep it."""
        return dict(self.optimizer.state_dict(), hvd_acc=self._acc,
                    hvd_passes=self._passes)

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        """Restore what :meth:`state_dict` gave, the aggregation cycle
        included (a dict without the ``hvd_`` keys starts a fresh
        cycle)."""
        inner = {k: v for k, v in state_dict.items()
                 if k not in ("hvd_acc", "hvd_passes")}
        self.optimizer.load_state_dict(inner)
        acc = state_dict.get("hvd_acc")
        if acc is None:
            self._acc = None
        else:
            if len(acc) != len(self._params):
                raise ValueError(f"hvd_acc holds {len(acc)} tensors for "
                                 f"{len(self._params)} parameters")
            self._acc = [torch.zeros_like(p, dtype=torch.float32).copy_(a)
                         for p, a in zip(self._params, acc)]
        self._passes = int(state_dict.get("hvd_passes", 0))

    # -- the step ----------------------------------------------------------

    @torch.no_grad()
    def step(self, closure=None):
        """Accumulate this pass's gradients; on the aggregation boundary
        reduce them and run the wrapped optimizer's step (returning its
        result), else return None having changed no parameter."""
        if self._acc is None:
            self._acc = [torch.zeros_like(p, dtype=torch.float32)
                         for p in self._params]
        live = [(a, p.grad) for p, a in zip(self._params, self._acc)
                if p.grad is not None]
        if live:  # one multi-tensor launch, not one per parameter
            torch._foreach_add_([a for a, _ in live], [g for _, g in live])
        self._passes += 1
        if self._passes < self.backward_passes_per_step:
            return None
        n = self.backward_passes_per_step
        scaled = torch._foreach_div(self._acc, float(n)) if n > 1 \
            else list(self._acc)
        reduced = self._allreduce(scaled)
        for p, g in zip(self._params, reduced):
            p.grad = g.to(p.dtype)
        torch._foreach_zero_(self._acc)
        self._passes = 0
        if closure is not None:
            with torch.enable_grad():
                return self.optimizer.step(closure)
        return self.optimizer.step()

    def _allreduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self._axis_sets is None:
            return _allreduce_list(grads, self.op, self.compression,
                                   self._prescale, self._postscale,
                                   self.process_set, self._groups)
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        n_all, sets = self._axis_sets
        for ps, idx in sets:
            sub = [grads[i] for i in idx]
            if ps is self.process_set:
                red = _allreduce_list(sub, self.op, self.compression,
                                      self._prescale, self._postscale, ps)
            else:
                # A sharded parameter: the sum over its reduce set, then
                # the divisor of every reduce axis (JAX's order).
                red = _allreduce_list(sub, ReduceOp.SUM, self.compression,
                                      self._prescale, 1.0, ps) \
                    if ps is not None else [g * self._prescale for g in sub]
                if self.op == ReduceOp.AVERAGE:
                    red = [g / n_all for g in red]
                red = [g * self._postscale for g in red]
            for i, g in zip(idx, red):
                out[i] = g
        return out


def _axis_sets(params, reduce_axes):
    """``(product of the reduce axes' sizes, [(process set, parameter
    indices)])``: parameters grouped by their reduce set, ``reduce_axes``
    less the axes each is sharded over, in order of first appearance;
    the set is None where nothing is left.  Every rank registers the
    same sets in the same order (collective on first use)."""
    from .parallel import axes_process_set, axis, sharded_axes
    n_all = int(np.prod([axis(a).size for a in reduce_axes]))
    groups = {}
    for i, p in enumerate(params):
        axes = tuple(a for a in reduce_axes if a not in sharded_axes(p))
        groups.setdefault(axes, []).append(i)
    return n_all, [(axes_process_set(axes) if axes else None, idx)
                   for axes, idx in groups.items()]


class PartialDistributedOptimizer(DistributedOptimizer):
    """``DistributedOptimizer`` that leaves some gradients local
    (``hvd.PartialDistributedOptimizer``): ``local_filter(name, param)``
    returning True keeps that parameter's gradient un-reduced (a
    per-rank embedding or adapter, say); the others reduce tensor by
    tensor.  ``name`` comes from ``named_parameters``, else it is the
    parameter's index in the optimizer's order, as a string.  No local
    accumulation, as in JAX."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 local_filter: Callable[[str, torch.Tensor], bool],
                 named_parameters=None, compression=Compression.none,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 process_set: ProcessSet = global_process_set):
        super().__init__(optimizer, compression=compression, op=op,
                         process_set=process_set)
        names = _param_names(self._params, named_parameters)
        self._local = [bool(local_filter(n, p))
                       for n, p in zip(names, self._params)]
        self._synced = [i for i, loc in enumerate(self._local) if not loc]

    def _allreduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        # A local gradient is copied: ``step`` zeroes the accumulators
        # ``grads`` after the wrapped step.
        out = [g.clone() if loc else g for g, loc in zip(grads, self._local)]
        for i, r in zip(self._synced, _ops.grouped_allreduce(
                [grads[i] for i in self._synced], op=self.op,
                compression=self.compression,
                process_set=self.process_set)):
            out[i] = r
        return out


@torch.no_grad()
def adasum_delta_step(optimizer: torch.optim.Optimizer,
                      named_parameters=None,
                      process_set: ProcessSet = global_process_set,
                      per_layer_stacked: Optional[Callable[[str], bool]]
                      = None) -> None:
    """Adasum on post-optimizer deltas (the reference's
    ``_DistributedAdasumOptimizer``, ``torch/optimizer.py:345``): run
    ``optimizer.step()`` on this rank's local gradients (each
    parameter's ``grad``), Adasum-reduce each parameter's delta over the
    set, and set each parameter to its old value plus the reduced delta.

    ``per_layer_stacked(name) -> True`` marks a stacked [L, ...]
    per-layer parameter: its delta gets one coefficient pair per slice
    of dim 0.  ``name`` is as in :class:`PartialDistributedOptimizer`.

    The optimizer's state moved on local gradients, so every floating
    tensor of ``optimizer.state`` is then averaged over the set, as JAX
    averages the new optax state.  Each ``step`` entry is left as it is:
    it is torch's step count (optax's int32 ``count``, which JAX's
    floating filter skips), equal on every rank, and a CPU tensor that
    NCCL cannot reduce.

    ``p_old + (p_new - p_old)`` is ``p_new`` exactly only where the two
    lie within a factor of 2 of each other (Sterbenz), so in a set of
    one the parameters equal a plain step within rounding, not bit for
    bit."""
    params = _optimizer_params(optimizer)
    names = _param_names(params, named_parameters)
    before = [p.detach().clone() for p in params]
    optimizer.step()
    m = _ops.members_of(process_set)
    wire = _ops._wire_ps(process_set)
    for name, p, old in zip(names, params, before):
        stacked = per_layer_stacked is not None and per_layer_stacked(name)
        delta = p - old
        # One engine dispatch per delta, as allreduce(op=Adasum) is one.
        p.copy_(old + _ops._engine().run(
            "allreduce", lambda: adasum_allreduce(delta, m,
                                                  per_slice_axis0=stacked),
            [delta], op_id=int(ReduceOp.ADASUM), **wire))
    state = [(st, k, v) for st in optimizer.state.values()
             for k, v in st.items()
             if k != "step" and torch.is_tensor(v) and v.is_floating_point()]
    averaged = _ops.grouped_allreduce([v for _, _, v in state],
                                      op=ReduceOp.AVERAGE,
                                      process_set=process_set)
    for (st, k, _), v in zip(state, averaged):
        st[k] = v


def local_value_and_grad(fun: Callable, argnums=0, has_aux: bool = False):
    """``jax.value_and_grad`` with this rank's own gradients
    (``hvd.local_value_and_grad``): returns ``wrapped(*args)`` giving
    ``(value, grads)`` (``((value, aux), grads)`` with ``has_aux``),
    ``grads`` shaped like ``args[argnums]`` (a tuple for several
    argnums), a tensor or a tree of dicts, lists and tuples of tensors.

    Every torch gradient is already local, so this differentiates and
    reduces nothing.  It takes ``torch.autograd.grad`` over detached
    copies of the inputs, as ``torch.func.grad_and_value`` would:
    torch.func's transforms refuse saved-tensor hooks, which
    ``torch.utils.checkpoint`` (a model's ``remat``) installs.  Unused
    inputs get zero gradients."""
    single = isinstance(argnums, int)
    nums = (argnums,) if single else tuple(argnums)

    def wrapped(*args, **kwargs):
        args = list(args)
        trees = []
        for i in nums:
            leaves, spec = _pytree.tree_flatten(args[i])
            leaves = [t.detach().requires_grad_() for t in leaves]
            trees.append((leaves, spec))
            args[i] = _pytree.tree_unflatten(leaves, spec)
        with torch.enable_grad():
            out = fun(*args, **kwargs)
        value = out[0] if has_aux else out
        flat = torch.autograd.grad(
            value, [t for leaves, _ in trees for t in leaves],
            allow_unused=True, materialize_grads=True)
        grads, start = [], 0
        for leaves, spec in trees:
            grads.append(_pytree.tree_unflatten(
                list(flat[start:start + len(leaves)]), spec))
            start += len(leaves)
        value = value.detach()
        out = (value, out[1]) if has_aux else value
        return out, (grads[0] if single else tuple(grads))

    return wrapped


def value_and_grad(fun: Callable, op: ReduceOp = ReduceOp.AVERAGE,
                   compression=Compression.none,
                   process_set: ProcessSet = global_process_set,
                   argnums=0, has_aux: bool = False):
    """:func:`local_value_and_grad` whose gradients are reduced over the
    set (``hvd.value_and_grad``, the ``DistributedGradientTape``
    analog), by ``_allreduce_tree``'s rules (module docstring)."""
    vg = local_value_and_grad(fun, argnums=argnums, has_aux=has_aux)

    def wrapped(*args, **kwargs):
        value, grads = vg(*args, **kwargs)
        leaves, spec = _pytree.tree_flatten(grads)
        reduced = _allreduce_list(leaves, ReduceOp(op), compression, 1.0,
                                  1.0, process_set)
        return value, _pytree.tree_unflatten(reduced, spec)

    return wrapped


def grad(fun: Callable, op: ReduceOp = ReduceOp.AVERAGE,
         compression=Compression.none,
         process_set: ProcessSet = global_process_set, argnums=0,
         has_aux: bool = False):
    """``jax.grad`` with reduced local gradients (``hvd.grad``; see
    :func:`value_and_grad`); with ``has_aux``, ``(grads, aux)``."""
    vg = value_and_grad(fun, op=op, compression=compression,
                        process_set=process_set, argnums=argnums,
                        has_aux=has_aux)

    def wrapped(*args, **kwargs):
        value, grads = vg(*args, **kwargs)
        return (grads, value[1]) if has_aux else grads

    return wrapped
