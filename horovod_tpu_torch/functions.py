"""Broadcast helpers for start-up and restore.

Port of ``broadcast_variables`` / ``broadcast_parameters``
(``horovod_tpu/functions.py:27-42``) and ``broadcast_optimizer_state``
(``:45``): rank ``root_rank``'s values reach every rank, so all ranks
start from the same weights and optimizer state.  They act in place on
what torch holds (a module's parameters and buffers, a ``state_dict`` or
any mapping or list of tensors, a ``torch.optim`` optimizer's state),
which is the reference's ``torch/functions.py`` contract; each returns
its argument.  The object and allgather helpers are not ported yet
(ROADMAP A2).
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch
from torch import nn

from . import core as _core
from . import ops as _ops
from .process_sets import ProcessSet, global_process_set


def _tensors(params) -> Iterable[torch.Tensor]:
    if isinstance(params, nn.Module):
        yield from params.parameters()
        yield from params.buffers()
    elif isinstance(params, torch.Tensor):
        yield params
    elif isinstance(params, Mapping):
        for v in params.values():
            yield from _tensors(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            # named_parameters() gives (name, tensor) pairs.
            if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str):
                v = v[1]
            yield from _tensors(v)
    else:
        raise TypeError(f"cannot broadcast a {type(params).__name__}")


@torch.no_grad()
def broadcast_variables(params, root_rank: int = 0,
                        process_set: ProcessSet = global_process_set):
    """Overwrite every tensor of ``params`` with ``root_rank``'s, in
    place, in the order the container yields them (the same on every
    rank); returns ``params``."""
    for t in _tensors(params):
        t.copy_(_ops.broadcast(t, root_rank=root_rank,
                               process_set=process_set))
    return params


# Horovod torch spelling.
broadcast_parameters = broadcast_variables


@torch.no_grad()
def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              process_set: ProcessSet = global_process_set):
    """Broadcast a ``torch.optim`` optimizer's per-parameter state
    (tensors in place; numbers such as a step count through a float64
    tensor) and the numeric options of its parameter groups (``lr``,
    ``betas``, ...) from ``root_rank``.  Every rank must hold the same
    state layout, e.g. all fresh or all restored from one checkpoint.
    A mapping of tensors (a ``state_dict``) is broadcast like
    :func:`broadcast_variables`."""
    inner = getattr(optimizer, "optimizer", optimizer)
    if not isinstance(inner, torch.optim.Optimizer):
        return broadcast_variables(optimizer, root_rank, process_set)

    def bcast_number(x):
        t = torch.tensor(float(x), dtype=torch.float64,
                         device=_core.device())
        out = float(_ops.broadcast(t, root_rank, process_set=process_set))
        return type(x)(out)

    for group in inner.param_groups:
        for key, val in sorted(group.items()):
            if key == "params" or isinstance(val, bool):
                continue
            if isinstance(val, (int, float)):
                group[key] = bcast_number(val)
            elif isinstance(val, tuple) and all(
                    isinstance(x, (int, float)) for x in val):
                group[key] = tuple(bcast_number(x) for x in val)
        for p in group["params"]:
            state = inner.state.get(p, {})
            for key in sorted(state):
                val = state[key]
                if isinstance(val, torch.Tensor):
                    # A step count may sit on the host (torch.optim's
                    # default): it crosses the wire on the rank's device.
                    val.copy_(_ops.broadcast(val.to(_core.device()),
                                             root_rank,
                                             process_set=process_set))
                elif isinstance(val, (int, float)) and \
                        not isinstance(val, bool):
                    state[key] = bcast_number(val)
    return optimizer
