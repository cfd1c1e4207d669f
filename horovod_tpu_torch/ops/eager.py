"""Handles of the async collectives.

Port of ``HandleManager`` (``horovod_tpu/ops/eager.py:50-80``, the
reference's ``torch/handle_manager.h:48``): an int handle maps to an
op's outputs.  The op has run when its ``*_async`` form returns; on a
card its kernels may still be queued, so the handle also holds an event
recorded on the current stream after them, which ``poll`` queries and
``wait`` waits on.  (The JAX package's negotiated ``EagerEngine`` is not
ported: ROADMAP A2.)
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import torch


def _tensors(result) -> Iterator[torch.Tensor]:
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, (list, tuple)):
        for r in result:
            yield from _tensors(r)


class HandleManager:
    """int handle → (outputs, event or None)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._results: Dict[int, Tuple[Any, Optional[torch.cuda.Event]]] = {}

    def allocate(self, result) -> int:
        event = None
        if any(t.is_cuda for t in _tensors(result)):
            event = torch.cuda.Event()
            event.record()
        with self._lock:
            h = self._next
            self._next += 1
            self._results[h] = (result, event)
            return h

    def _entry(self, handle: int, pop: bool):
        with self._lock:
            if handle not in self._results:
                raise ValueError(
                    f"unknown or already-synchronized handle {handle}")
            return (self._results.pop if pop else self._results.get)(handle)

    def poll(self, handle: int) -> bool:
        """True when the outputs are ready (``hvd.poll``)."""
        _, event = self._entry(handle, pop=False)
        return event is None or event.query()

    def wait(self, handle: int):
        """Wait for the outputs and return them (``hvd.synchronize``)."""
        result, event = self._entry(handle, pop=True)
        if event is not None:
            event.synchronize()
        return result
