"""Broadcast helpers for start-up and restore, and the object helpers.

Port of ``broadcast_variables`` / ``broadcast_parameters``
(``horovod_tpu/functions.py:27-42``) and ``broadcast_optimizer_state``
(``:45``): rank ``root_rank``'s values reach every rank, so all ranks
start from the same weights and optimizer state.  They act in place on
what torch holds (a module's parameters and buffers, a ``state_dict`` or
any mapping or list of tensors, a ``torch.optim`` optimizer's state),
which is the reference's ``torch/functions.py`` contract; each returns
its argument.

``broadcast_object`` (``:73``), ``broadcast_object_fn`` (``:100``) and
``allgather_object`` (``:110``) pickle an object to a uint8 tensor on
the rank's device (NCCL takes no CPU tensor), exchange its size, then
its bytes.  Every member goes over the wire, a world of one too.  Only
unpickle what ranks of the same job sent: unpickling runs code.
"""

from __future__ import annotations

import pickle
from typing import Any, Iterable, Mapping, Optional

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


def _to_bytes(obj: Any) -> torch.Tensor:
    data = bytearray(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
    return torch.frombuffer(data, dtype=torch.uint8).to(_core.device())


def _from_bytes(t: torch.Tensor) -> Any:
    return pickle.loads(t.cpu().numpy().tobytes())


def broadcast_object(obj: Any = None, root_rank: int = 0,
                     name: Optional[str] = None,
                     process_set: ProcessSet = global_process_set) -> Any:
    """The root's ``obj`` on every member of the set (``root_rank`` is
    the root's rank within it); a rank outside the set gets its own
    ``obj`` back.  The byte count goes to every rank of the world, so
    that a rank outside the set negotiates the payload's broadcast with
    its shape."""
    m = _ops.members_of(process_set)
    if not 0 <= root_rank < m.size:
        raise ValueError(f"root_rank {root_rank} outside the set of "
                         f"{m.size} ranks")
    dev = _core.device()
    root = m.set_rank == root_rank
    payload = _to_bytes(obj) if root else None
    size = torch.tensor([payload.numel() if root else 0], dtype=torch.int64,
                        device=dev)
    size = _ops.broadcast(size, m.ranks[root_rank])
    if not m.included:
        _ops.broadcast(_ops._meta((int(size),), torch.uint8), root_rank,
                       name=name, process_set=process_set)
        return obj
    buf = payload if root else torch.empty(int(size), dtype=torch.uint8,
                                           device=dev)
    return _from_bytes(_ops.broadcast(buf, root_rank, name=name,
                                      process_set=process_set))


def broadcast_object_fn(root_rank: int = 0, name: Optional[str] = None,
                        process_set: ProcessSet = global_process_set):
    """A function that broadcasts an object from ``root_rank``."""
    def fn(obj=None):
        return broadcast_object(obj, root_rank=root_rank, name=name,
                                process_set=process_set)
    return fn


def allgather_object(obj: Any, name: Optional[str] = None,
                     process_set: ProcessSet = global_process_set) -> list:
    """Every member's ``obj``, in rank order; a rank outside the set
    gets ``[obj]``, as the JAX package gives it."""
    res = _ops._gather(_to_bytes(obj), process_set, name=name)
    if res is None:
        return [obj]
    out, rows = res
    return [_from_bytes(b) for b in _ops._blocks(out, rows)]
