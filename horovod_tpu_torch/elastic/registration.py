"""Worker exit bookkeeping.

Copy of ``horovod_tpu/elastic/registration.py`` (framework-free; the
port keeps its own copy).


Reference: horovod/runner/elastic/registration.py:28 WorkerStateRegistry —
gathers per-worker success/failure records and triggers the driver's
``resume()`` once the world needs reshaping.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    def __init__(self, driver, host_manager, reset_limit: Optional[int] = None,
                 verbose: bool = False):
        self._driver = driver
        self._host_manager = host_manager
        self._lock = threading.Lock()
        self._states: Dict[Tuple[str, int], str] = {}
        self._reset_count = 0
        self._reset_limit = reset_limit
        self._barrier_size = 0

    @property
    def reset_count(self) -> int:
        return self._reset_count

    def reset(self, size: int) -> None:
        with self._lock:
            self._states = {}
            self._barrier_size = size

    def record_ready(self, host: str, slot: int, version: int = -1) -> None:
        self._record(host, slot, READY, version)

    def record_success(self, host: str, slot: int,
                       version: int = -1) -> None:
        self._record(host, slot, SUCCESS, version)

    def record_failure(self, host: str, slot: int,
                       version: int = -1) -> None:
        """Failure blacklists the host (driver.py:304 resume trigger).

        ``version`` is the world generation the worker was launched into;
        failures from a world that has already been reshaped past do not
        trigger another resume (all slots of a dead host coalesce into one
        reset, like the reference's per-reconfiguration counting).

        Reshape casualties are NOT blacklisted: on this runtime a world
        transition tears down the process group under live
        collectives, so workers of the outgoing world routinely die
        nonzero (shutdown-barrier aborts) through no fault of their host.
        A worker whose spawn world is already superseded, or that dies
        while a resume is pending/in flight, is such a casualty —
        blacklisting it (permanently, without --blacklist-cooldown-range)
        left single-host worlds unable to respawn after their own
        scale-up."""
        casualty = (0 <= version < self._driver.world_version) or \
            self._driver.resume_in_flight
        if not casualty:
            self._host_manager.blacklist.blacklist(host)
        self._record(host, slot, FAILURE, version)

    def _record(self, host: str, slot: int, state: str,
                version: int) -> None:
        with self._lock:
            self._states[(host, slot)] = state
        if state == FAILURE:
            if version >= 0 and version < self._driver.world_version:
                return  # stale world: already reshaped past this failure
            self._maybe_resume()

    def _maybe_resume(self) -> None:
        # request_resume coalesces concurrent requests (e.g. every slot of a
        # dead host failing at once) into ONE reshape; the reset limit counts
        # reshapes, matching the reference's world-reconfiguration semantics.
        scheduled = self._driver.request_resume()
        if not scheduled:
            return
        with self._lock:
            self._reset_count += 1
            over = self._reset_limit is not None and \
                self._reset_count > self._reset_limit
        if over:
            self._driver.stop(
                error_message=(
                    f"Reset limit of {self._reset_limit} reached "
                    f"(reference: --reset-limit semantics)"))

    def last_rank_states(self) -> Dict[Tuple[str, int], str]:
        with self._lock:
            return dict(self._states)
