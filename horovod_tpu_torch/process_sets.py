"""Process sets: so far only the global set.

Port of ``ProcessSet`` and ``global_process_set`` from
``horovod_tpu/process_sets.py``.  Every collective of the port runs over
the whole world; a set of fewer ranks (registration, subset collectives,
set-relative roots) is ROADMAP A1's remaining work, and passing one
raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class ProcessSet:
    """A set of ranks (``horovod/common/process_sets.py:18`` in the
    reference); ``ranks=None`` is the global set."""

    process_set_id: Optional[int]

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.process_set_id = None
        self.ranks: Optional[List[int]] = (
            sorted(set(int(r) for r in ranks)) if ranks is not None else None)

    def __repr__(self):
        return (f"ProcessSet(id={self.process_set_id}, "
                f"ranks={self.ranks if self.ranks is not None else 'global'})")


global_process_set = ProcessSet()
global_process_set.process_set_id = 0


def require_global(process_set: Optional[ProcessSet]) -> None:
    """Raise unless ``process_set`` is the global set (or None)."""
    if process_set is None or process_set is global_process_set \
            or process_set.ranks is None:
        return
    raise NotImplementedError(
        f"{process_set!r}: collectives over a subset of ranks are not "
        f"ported yet (ROADMAP A1, process-set subsets); pass the global "
        f"process set")
