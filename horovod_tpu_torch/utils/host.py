"""Host copies of trees of tensors (a ``state_dict``, an optimizer's
state): the elastic commit (``elastic/state.py``) and the checkpoints
(``checkpoint.py``) take them."""

from __future__ import annotations

import copy

import torch


def host_copy(t: torch.Tensor, prev=None) -> torch.Tensor:
    """``t`` on the host, in ``prev`` when it fits (a pinned buffer of an
    earlier copy), else in a new buffer, pinned when ``t`` is on a card.
    A CUDA copy is asynchronous: call :func:`settle` before reading it."""
    t = t.detach()
    if isinstance(prev, torch.Tensor) and prev.shape == t.shape and \
            prev.dtype == t.dtype and prev.device.type == "cpu":
        return prev.copy_(t, non_blocking=t.is_cuda)
    if t.is_cuda:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)
    return t.clone()


def host_tree(obj, prev=None):
    """A host copy of a tree of dicts, lists and tuples of tensors and
    plain values, reusing ``prev``'s buffers (see :func:`host_copy`)."""
    if isinstance(obj, torch.Tensor):
        return host_copy(obj, prev)
    if isinstance(obj, dict):
        prev = prev if isinstance(prev, dict) else {}
        return {k: host_tree(v, prev.get(k)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        prev = prev if isinstance(prev, (list, tuple)) and \
            len(prev) == len(obj) else [None] * len(obj)
        return type(obj)(host_tree(v, p) for v, p in zip(obj, prev))
    return copy.deepcopy(obj)


def clone_tree(obj):
    """A fresh copy of a host tree: ``load_state_dict`` may keep a tensor
    it is given (a CPU optimizer's state, a step count), and the copy
    must not change under the training that follows."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: clone_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(clone_tree(v) for v in obj)
    return copy.deepcopy(obj)


def settle() -> None:
    """Wait for the asynchronous device-to-host copies."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
