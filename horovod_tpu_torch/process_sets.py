"""Process sets: collectives over a subset of the ranks.

Port of ``horovod_tpu/process_sets.py``: ``ProcessSet`` (``:29``),
``ProcessSetTable`` (``:108``) and the module API (``:176-224``).  Where
the JAX package burns a set's members into each traced program, the port
gives each registered strict subset its own ``torch.distributed`` group
(``dist.new_group``), which the collectives of ``ops`` run over; a set
that covers the world runs over the world's group.

``dist.new_group`` is collective over the whole world, so registration
is too: every rank registers the same sets in the same order, members
and non-members alike, through ``add_process_set``,
``partition_process_sets`` or ``init(process_sets=...)``.  Horovod's
``add_process_set`` has the same contract (``operations.cc:1262``).  A
collective given a strict subset that no registration created raises
``ValueError``: creating its group at first use would deadlock, since
the ranks outside the set never call the op.  (The JAX package accepts
an unregistered set, as its programs need no group.)
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

from . import core as _core


class ProcessSet:
    """A set of global ranks (``horovod/common/process_sets.py:18`` in the
    reference); ``ranks=None`` is the global set.  ``process_set_id`` is
    assigned at registration (0 is the global set)."""

    process_set_id: Optional[int]

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.process_set_id = None
        self.ranks: Optional[List[int]] = (
            sorted(set(int(r) for r in ranks)) if ranks is not None else None)

    def size(self) -> Optional[int]:
        """Number of ranks in the set (None before init for the global
        set)."""
        if self.ranks is not None:
            return len(self.ranks)
        if _core.is_initialized():
            return _core.num_slots()
        return None

    def rank(self) -> Optional[int]:
        """This process's rank within the set, or None if excluded (or
        before init)."""
        if not _core.is_initialized():
            return None
        my = _core.rank()
        if self.ranks is None:
            return my
        if my in self.ranks:
            return self.ranks.index(my)
        return None

    def included(self) -> bool:
        return self.rank() is not None

    def _resolved_ranks(self) -> List[int]:
        if self.ranks is None:
            return list(range(_core.num_slots()))
        return self.ranks

    def members(self) -> Optional[tuple]:
        """The member ranks, or None when the set covers the world."""
        resolved = self._resolved_ranks()
        if len(resolved) == _core.num_slots():
            return None
        return tuple(resolved)

    def __repr__(self):
        return (f"ProcessSet(id={self.process_set_id}, "
                f"ranks={self.ranks if self.ranks is not None else 'global'})")


class ProcessSetTable:
    """id → ProcessSet registry, with each strict subset's group.

    Ids are dense and never reused until shutdown; registering a set
    with the ranks of one already registered returns that registration
    (``operations.cc:1262``)."""

    def __init__(self, num_slots: int):
        self._lock = threading.Lock()
        self._next_id = 1
        self.num_slots = num_slots
        self.table: Dict[int, ProcessSet] = {}
        # id → the set's group; None for a set that covers the world.
        self._groups: Dict[int, Optional[dist.ProcessGroup]] = {}
        # local_size → this rank's (node, cross) Members of the
        # two-level allreduce, and every group made for them.
        self._hier: Dict[int, tuple] = {}
        self._hier_groups: List[dist.ProcessGroup] = []
        g = ProcessSet()
        g.process_set_id = 0
        self.table[0] = g
        self._groups[0] = None

    def register(self, ps: ProcessSet) -> ProcessSet:
        """Register ``ps`` (collective: see the module docstring)."""
        with self._lock:
            if ps.process_set_id is not None:
                return ps
            ranks = ps.ranks
            if ranks is not None:
                if not ranks:
                    raise ValueError(
                        "process set must contain at least one rank")
                if ranks[-1] >= self.num_slots or ranks[0] < 0:
                    raise ValueError(
                        f"process set ranks {ranks} out of range for "
                        f"{self.num_slots} slots")
                for existing in self.table.values():
                    if existing.ranks == ranks:
                        ps.process_set_id = existing.process_set_id
                        return existing
            ps.process_set_id = self._next_id
            self._next_id += 1
            self.table[ps.process_set_id] = ps
            covers_world = ranks is None or len(ranks) == self.num_slots
            self._groups[ps.process_set_id] = (
                None if covers_world else dist.new_group(ranks))
            return ps

    def remove(self, ps: ProcessSet) -> None:
        """Deregister ``ps`` and destroy its group."""
        with self._lock:
            if ps.process_set_id == 0:
                raise ValueError(
                    "cannot remove the global process set (process_set.h)")
            self.table.pop(ps.process_set_id, None)
            _destroy(self._groups.pop(ps.process_set_id, None))
            ps.process_set_id = None

    def get(self, process_set_id: int) -> ProcessSet:
        try:
            return self.table[process_set_id]
        except KeyError:
            raise ValueError(f"unknown process set id {process_set_id}")

    def find(self, ranks: Sequence[int]) -> Optional[ProcessSet]:
        """The registered set with these member ranks, or None."""
        ranks = sorted(int(r) for r in ranks)
        with self._lock:
            for existing in self.table.values():
                if existing._resolved_ranks() == ranks:
                    return existing
        return None

    def hierarchy(self, local_size: int, rank: int):
        """This rank's node and cross groups for ``local_size`` ranks per
        node, as ``ops.Members``: made at first use, collectively (every
        rank calls ``dist.new_group`` for every group, in one order)."""
        from .ops.collective_ops import Members
        with self._lock:
            if local_size not in self._hier:
                n = self.num_slots
                nodes = [list(range(k * local_size, (k + 1) * local_size))
                         for k in range(n // local_size)]
                crosses = [list(range(j, n, local_size))
                           for j in range(local_size)]
                mine = []
                for groups in (nodes, crosses):
                    made = [dist.new_group(g) for g in groups]
                    self._hier_groups.extend(made)
                    i = next(i for i, g in enumerate(groups) if rank in g)
                    mine.append(Members(made[i], tuple(groups[i]),
                                        groups[i].index(rank)))
                self._hier[local_size] = tuple(mine)
            return self._hier[local_size]

    def resolve(self, ps: Optional[ProcessSet]
                ) -> Tuple[Optional[dist.ProcessGroup], List[int]]:
        """The group a collective over ``ps`` runs on (None: the world)
        and the set's member ranks."""
        world = list(range(self.num_slots))
        if ps is None or ps.ranks is None or ps.ranks == world:
            return None, world
        with self._lock:
            for pid, existing in self.table.items():
                if existing.ranks == ps.ranks:
                    return self._groups[pid], ps.ranks
        raise ValueError(
            f"{ps!r} is not registered: register it on every rank with "
            f"hvd.add_process_set({ps.ranks}) (or init(process_sets=...)) "
            f"before a collective uses it")

    def destroy(self) -> None:
        """Destroy every subset's group and forget every set but the
        global one (``shutdown``)."""
        with self._lock:
            for pid in list(self.table):
                if pid:
                    self.table.pop(pid).process_set_id = None
                    _destroy(self._groups.pop(pid))
            for group in self._hier_groups:
                _destroy(group)
            self._hier.clear()
            self._hier_groups.clear()


def _destroy(group: Optional[dist.ProcessGroup]) -> None:
    # None is the world's group; a non-member's handle of a subset is
    # GroupMember.NON_GROUP_MEMBER, which is no group of its own.
    if group is not None and group != dist.GroupMember.NON_GROUP_MEMBER:
        dist.destroy_process_group(group)


# Module-level API mirroring horovod/common/process_sets.py.
global_process_set = ProcessSet()
global_process_set.process_set_id = 0


def _table() -> ProcessSetTable:
    return _core._require_init().process_set_table


def add_process_set(process_set) -> ProcessSet:
    """Register a process set after init (a ``ProcessSet`` or a rank
    list); every rank calls it, in the same order."""
    if not isinstance(process_set, ProcessSet):
        process_set = ProcessSet(process_set)
    return _table().register(process_set)


def remove_process_set(process_set: ProcessSet) -> bool:
    """Deregister a set and destroy its group; False for the global set."""
    try:
        _table().remove(process_set)
        return True
    except (ValueError, KeyError):
        return False


def process_set_included(process_set_id: int = 0) -> bool:
    return _table().get(process_set_id).included()


def get_process_set_ids() -> List[int]:
    return sorted(_table().table.keys())


def partition_process_sets(num_groups: int) -> List[ProcessSet]:
    """Register ``num_groups`` disjoint sets of contiguous ranks covering
    the world; a remainder is spread one rank at a time over the leading
    sets.  A single set covers the world."""
    n = _core.num_slots()
    if num_groups < 1 or num_groups > n:
        raise ValueError(
            f"cannot partition {n} slots into {num_groups} groups")
    base, extra = divmod(n, num_groups)
    sets, start = [], 0
    for g in range(num_groups):
        width = base + (1 if g < extra else 0)
        sets.append(add_process_set(list(range(start, start + width))))
        start += width
    return sets
