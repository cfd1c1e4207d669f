"""``DistributedOptimizer``: averaged gradients, local accumulation.

Port of ``horovod_tpu/optimizer.py:345-493`` around a ``torch.optim``
optimizer.  The semantics are the JAX package's, not Horovod-torch's
per-parameter hooks:

* ``step()`` adds each parameter's ``grad`` (this pass's gradient; call
  ``zero_grad()`` before each backward) to its own f32 accumulator;
* on every ``backward_passes_per_step``-th call it divides the sums by
  that count, reduces them over the world — bucketed by the fusion
  planner up to ``HOROVOD_FUSION_THRESHOLD``, one flat buffer and one
  collective per bucket (``_fused_allreduce``, as ``_allreduce_tree``
  does for a multi-process world, ``:231-290``) — writes the result into
  each ``grad``, and calls the wrapped optimizer's ``step()``;
* between those calls neither the parameters nor the wrapped
  optimizer's state change (``:480-489``).

With ``process_set``, the gradients reduce over the set's ranks, and a
rank outside the set steps on its own gradients (the JAX package's
non-member passthrough).  It supports ``op`` (Average / Sum),
``compression``,
``gradient_predivide_factor`` (``:320-330``: prescale 1/f, postscale f)
and ``groups`` / ``num_groups`` (each group one grouped allreduce, the
planner bypassed, as in JAX).  ``named_parameters`` is accepted and
ignored, as in JAX.  ``zero_grad``, ``param_groups``, ``state`` and
``state_dict`` pass through to the wrapped optimizer.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import core as _core
from . import ops as _ops
from .compression import Compression
from .ops import ReduceOp
from .ops.fusion import plan_fusion
from .process_sets import ProcessSet, global_process_set


class DistributedOptimizer:
    """Wrap ``optimizer`` with Horovod's gradient reduction
    (``hvd.DistributedOptimizer``)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 gradient_predivide_factor: float = 1.0,
                 num_groups: int = 0, groups=None,
                 process_set: ProcessSet = global_process_set):
        del named_parameters  # API parity: parameter order is the contract
        op = ReduceOp(op)
        if op == ReduceOp.ADASUM:
            raise NotImplementedError(
                "Adasum is not ported yet (ROADMAP A5)")
        if op not in (ReduceOp.AVERAGE, ReduceOp.SUM):
            raise ValueError(f"gradients reduce with Average or Sum, got "
                             f"{op!r}")
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
        self._params: List[torch.nn.Parameter] = [
            p for g in optimizer.param_groups for p in g["params"]]
        if num_groups and groups is None:
            groups = num_groups
        self._groups = self._index_groups(groups)
        self._acc: Optional[List[torch.Tensor]] = None
        self._passes = 0

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

    def state_dict(self):
        return self.optimizer.state_dict()

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
        kw = dict(op=self.op, compression=self.compression,
                  prescale_factor=self._prescale,
                  postscale_factor=self._postscale,
                  process_set=self.process_set)
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        if self._groups is not None:
            for g in self._groups:
                for i, r in zip(g, _ops.grouped_allreduce(
                        [grads[i] for i in g], **kw)):
                    out[i] = r
            return out
        threshold = _core._require_init().config.fusion_threshold_bytes
        entries = [(str(i), str(g.dtype), g.numel() * g.element_size(),
                    int(self.op), 0) for i, g in enumerate(grads)]
        for bucket in plan_fusion(entries, threshold):
            for i, r in zip(bucket, _ops._fused_allreduce(
                    [grads[i] for i in bucket], **kw)):
                out[i] = r
        return out
