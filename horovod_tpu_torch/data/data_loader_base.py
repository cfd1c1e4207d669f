"""Data loader base classes + sharded/prefetching loaders.

Port of ``horovod_tpu/data/data_loader_base.py``: the classes and their
iteration are the JAX package's; ``device_prefetch`` (``:94``) becomes a
copy of the next batch's tensors to the rank's device
(``.to(device, non_blocking=True)`` from pinned host memory), issued
while the current batch is in use, one batch ahead.

Reference: horovod/data/data_loader_base.py:20 (BaseDataLoader), :48
(AsyncDataLoaderMixin: a prefetch thread pushing batches into a bounded
queue so the accelerator never waits on host input).  ``ShardedDataLoader``
adds rank-sharded iteration and the device prefetch of the next batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Optional

import torch


class BaseDataLoader:
    """Iteration interface (data_loader_base.py:20)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def _iterate(self) -> Iterator[Any]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Any]:
        return self._iterate()


class AsyncDataLoaderMixin:
    """Prefetch thread + bounded queue (data_loader_base.py:48).

    Mix in before a BaseDataLoader subclass::

        class MyAsyncLoader(AsyncDataLoaderMixin, MyLoader): ...

    ``async_loader_queue_size=0`` disables prefetch (synchronous passthrough).
    """

    def __init__(self, *args, async_loader_queue_size: int = 2, **kwargs):
        self.async_loader_queue_size = async_loader_queue_size
        super().__init__(*args, **kwargs)

    def __iter__(self) -> Iterator[Any]:
        if self.async_loader_queue_size <= 0:
            return super().__iter__()
        q: "queue.Queue" = queue.Queue(maxsize=self.async_loader_queue_size)
        sentinel = object()
        err: list = []

        def producer():
            try:
                for item in super(AsyncDataLoaderMixin, self)._iterate():
                    q.put(item)
            except BaseException as e:  # surface on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True,
                             name="hvd-data-prefetch")
        t.start()

        def consume():
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item

        return consume()


class ShardedDataLoader(BaseDataLoader):
    """Rank-sharded loader: each rank sees every ``size``-th batch starting
    at its rank (the DistributedSampler contract), with optional device
    prefetch of the next batch (double buffering) to ``device`` (default:
    the rank's device, ``core.device()``)."""

    def __init__(self, batches: Iterable[Any], rank: int = 0, size: int = 1,
                 device_prefetch: bool = False, device=None):
        self._batches = list(batches)
        self.rank = rank
        self.size = max(size, 1)
        self.device_prefetch = device_prefetch
        self.device = device

    def __len__(self) -> int:
        n = len(self._batches)
        return (n - self.rank + self.size - 1) // self.size

    def _iterate(self):
        shard = self._batches[self.rank::self.size]
        if not self.device_prefetch:
            yield from shard
            return
        device = self.device
        if device is None:
            from .. import core as _core
            device = _core.device()
        device = torch.device(device)
        prev = None
        for item in shard:
            nxt = _tree_to(item, device)
            if prev is not None:
                yield prev
            prev = nxt
        if prev is not None:
            yield prev


def _tree_to(item, device: "torch.device"):
    """``item``'s tensors on ``device``, copied asynchronously from pinned
    host memory when the target is a card (the stream orders the copy
    before any use of the tensor)."""
    if isinstance(item, torch.Tensor):
        if device.type == "cuda" and item.device.type == "cpu":
            src = item if item.is_pinned() else item.pin_memory()
            return src.to(device, non_blocking=True)
        return item.to(device)
    if isinstance(item, dict):
        return {k: _tree_to(v, device) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_tree_to(v, device) for v in item)
    return item


class AsyncDataLoader(AsyncDataLoaderMixin, ShardedDataLoader):
    """Convenience: sharded + background prefetch."""
