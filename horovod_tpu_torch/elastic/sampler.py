"""Elastic data sampler: mid-epoch-correct resume across world reshapes.

Copy of ``horovod_tpu/elastic/sampler.py`` (``ElasticSampler`` :20),
its indices identical to the JAX package's; the live world is the
port's ``core``.  ``TorchState`` commits it as a stateful object
(``state_dict`` / ``load_state_dict``).

Reference: horovod/torch/elastic/sampler.py:24 ElasticSampler — shards a
deterministic epoch permutation across ranks and records how many samples
the WORLD has processed (``processed_num``, identical on every rank); on
reset (world size change) the remaining slice of the permutation is
re-sharded over the new world, so an elastic restart continues the epoch
instead of replaying it.  ``state_dict``/``load_state_dict`` ride
state commits, and rank-0 sync is safe because the state is rank-agnostic.
"""

from __future__ import annotations

import math
import random
from typing import Iterator, List, Optional


class ElasticSampler:
    """Index sampler over a sized dataset (sampler.py:24).

    Usage::

        sampler = hvd.elastic.ElasticSampler(len(dataset))
        state = hvd.elastic.TorchState(model, optimizer, sampler=sampler)

        for batch_idx in range(len(sampler) // batch_size):
            idxs = sampler.get_indices(batch_idx, batch_size)
            ...train on dataset[idxs]...
            sampler.record_batch(batch_idx, batch_size)
            state.commit()
        sampler.set_epoch(epoch + 1)   # AFTER the epoch (clears progress)
    """

    def __init__(self, dataset_or_size, shuffle: bool = True, seed: int = 0):
        self.dataset_size = (dataset_or_size if isinstance(dataset_or_size,
                                                           int)
                             else len(dataset_or_size))
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_num = 0
        self.rank = 0
        self.num_replicas = 1
        self.remaining_indices: List[int] = []
        self.num_samples = 0
        self.total_size = 0
        self.reset()

    def _world(self) -> tuple:
        from .. import core as _core
        if _core.is_initialized():
            return _core.rank(), _core.size()
        return self.rank, self.num_replicas

    def reset(self, rank: Optional[int] = None,
              size: Optional[int] = None) -> None:
        """Drop the first ``processed_num`` entries of the epoch permutation
        and re-shard the rest over the current world (sampler.py reset).
        ``rank``/``size`` override the live world for testing."""
        cur_rank, cur_size = self._world()
        self.rank = cur_rank if rank is None else rank
        self.num_replicas = max(cur_size if size is None else size, 1)
        all_indices = list(range(self.dataset_size))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(all_indices)
        self.remaining_indices = all_indices[self.processed_num:]
        self.num_samples = int(
            math.ceil(len(self.remaining_indices) / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas
        # This rank's shard, padded to equal length across ranks
        # (sampler.py __iter__ evenly-divisible padding).
        padded = self.remaining_indices + \
            self.remaining_indices[:self.total_size
                                   - len(self.remaining_indices)]
        self.indices = padded[self.rank:self.total_size:self.num_replicas]

    def set_epoch(self, epoch: int) -> None:
        """Start a new epoch permutation; call at the END of an epoch so a
        partially completed epoch keeps its progress (sampler.py
        set_epoch)."""
        self.epoch = epoch
        self.processed_num = 0
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        """The world processed one more batch of ``batch_size`` per rank
        (sampler.py record_batch)."""
        self.processed_num += batch_size * self.num_replicas

    def get_indices(self, batch_idx: int, batch_size: int) -> List[int]:
        return self.indices[batch_idx * batch_size:
                            (batch_idx + 1) * batch_size]

    # -- state handoff (SamplerStateHandler, torch/elastic/state.py) --------

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "processed_num": self.processed_num}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self.processed_num = state["processed_num"]
        self.reset()

    # -- iteration -----------------------------------------------------------

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices)

    def __len__(self) -> int:
        return self.num_samples
