"""Rank bookkeeping: who this process is in the job.

Port of ``horovod_tpu/topology.py``.  Rank, size, local and cross come
from the launcher's environment (``_from_launcher_env``, the reference's
``runner/gloo_run.py:66-78`` contract), else the job is one process.
One process drives one card, so a slot is a rank: ``num_slots`` equals
``size`` (the JAX package's slot level, one process over many chips,
has no counterpart here).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from . import config as _config


@dataclasses.dataclass
class Topology:
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int

    @property
    def num_slots(self) -> int:
        return self.size

    @property
    def local_slots(self) -> int:
        """Cards this process drives: one."""
        return 1

    @property
    def is_homogeneous(self) -> bool:
        """Equal slots on every process (the JAX package counts slots per
        process, ``topology.py:60-67``): every process drives one card,
        so always true."""
        return True


def _from_launcher_env() -> Optional[Topology]:
    """Topology from launcher-injected env, or None outside a launcher."""
    rank = os.environ.get(_config.HOROVOD_RANK)
    size = os.environ.get(_config.HOROVOD_SIZE)
    if rank is None or size is None:
        return None
    rank, size = int(rank), int(size)
    return Topology(
        rank=rank, size=size,
        local_rank=int(os.environ.get(_config.HOROVOD_LOCAL_RANK, 0)),
        local_size=int(os.environ.get(_config.HOROVOD_LOCAL_SIZE, 1)),
        cross_rank=int(os.environ.get(_config.HOROVOD_CROSS_RANK, rank)),
        cross_size=int(os.environ.get(_config.HOROVOD_CROSS_SIZE, size)),
    )


def detect() -> Topology:
    """The launcher's topology, else a single process."""
    topo = _from_launcher_env()
    if topo is not None:
        return topo
    return Topology(rank=0, size=1, local_rank=0, local_size=1,
                    cross_rank=0, cross_size=1)
