"""Host discovery + blacklist for elastic training.

Copy of ``horovod_tpu/elastic/discovery.py`` (framework-free; the port
keeps its own copy).


Reference: horovod/runner/elastic/discovery.py:33 (HostDiscoveryScript:
runs the user's ``--host-discovery-script`` which prints "hostname:slots"
lines), :146 (HostManager: tracks current hosts, diffs updates, blacklists
failed hosts with an exponential cooldown range — blacklist cooldown from
``--blacklist-cooldown-range``).
"""

from __future__ import annotations

import random
import subprocess
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..utils.logging import get_logger
from ..runner import hosts as _hosts


class HostDiscovery:
    """Interface (discovery.py HostDiscovery)."""

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Runs the user script; output lines "hostname:slots" or bare hostname
    (discovery.py:33 HostDiscoveryScript)."""

    def __init__(self, discovery_script: str, slots: Optional[int] = None):
        self.script = discovery_script
        self.default_slots = slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = subprocess.check_output(self.script, shell=True,
                                      timeout=60).decode()
        result: Dict[str, int] = {}
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                host, slots = line.rsplit(":", 1)
                result[host.strip()] = int(slots)
            else:
                result[line] = self.default_slots or 1
        return result


class FixedHostDiscovery(HostDiscovery):
    def __init__(self, hosts: Dict[str, int]):
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


class Blacklist:
    """Failed-host blacklist with exponential cooldown
    (discovery.py CooldownBlacklist: base cooldown grows per repeat failure,
    bounded by the cooldown range)."""

    def __init__(self, cooldown_range: Optional[Tuple[float, float]] = None):
        self._cooldown_range = cooldown_range
        self._failures: Dict[str, int] = {}
        self._until: Dict[str, float] = {}
        self._since: Dict[str, float] = {}
        self._lock = threading.Lock()

    def blacklist(self, host: str) -> None:
        with self._lock:
            count = self._failures.get(host, 0) + 1
            self._failures[host] = count
            self._since[host] = time.time()
            if self._cooldown_range is None:
                self._until[host] = float("inf")
                return
            lo, hi = self._cooldown_range
            delay = min(hi, lo * (2 ** (count - 1)))
            delay *= 1.0 + 0.25 * random.random()  # jitter like the reference
            self._until[host] = time.time() + min(delay, hi)

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            until = self._until.get(host)
            if until is None:
                return False
            if time.time() >= until:
                del self._until[host]
                return False
            return True

    def blacklisted_since(self, host: str) -> float:
        with self._lock:
            return self._since.get(host, 0.0)

    def forgive(self, host: str) -> None:
        """Lift the entry (failure count is kept: a re-blacklist cools
        down longer)."""
        with self._lock:
            self._until.pop(host, None)

    def count(self, host: str) -> int:
        return self._failures.get(host, 0)


class HostManager:
    """Tracks the current host set, computes diffs against discovery output
    (discovery.py:146 HostManager)."""

    def __init__(self, discovery: HostDiscovery,
                 cooldown_range: Optional[Tuple[float, float]] = None):
        self.discovery = discovery
        self.blacklist = Blacklist(cooldown_range)
        self.current_hosts: Dict[str, int] = {}
        # Minimum slots the job needs (set by the ElasticDriver): the
        # blacklist-starvation escape keys off this, not off zero hosts.
        self.min_required = 1
        self._readmit_warned: Dict[str, float] = {}
        self._lock = threading.Lock()

    def update_available_hosts(self) -> int:
        """Refresh from discovery; returns change code: 0 = no change or
        pure scale-up, 1 = hosts removed (requires sync).  Mirrors the
        reference's HostUpdateResult semantics."""
        found_all = self.discovery.find_available_hosts_and_slots()
        found = {h: s for h, s in found_all.items()
                 if not self.blacklist.is_blacklisted(h)}
        if sum(found.values()) < self.min_required and \
                any(h not in found for h in found_all):
            # Pool starvation: the blacklist has pushed discoverable
            # capacity below what the job NEEDS (min_np).  A permanent
            # blacklist (no --blacklist-cooldown-range) would guarantee
            # job death — e.g. a reshape's shutdown-barrier abort killing
            # all of localhost's workers at once, or one genuine crash in
            # a pool with exactly min_np hosts.  Readmit least-recently-
            # blacklisted hosts until capacity suffices; --reset-limit
            # still bounds genuine crash loops.
            for h in sorted((h for h in found_all if h not in found),
                            key=self.blacklist.blacklisted_since):
                # Rate-limit per host: while capacity stays short this
                # branch re-fires every discovery poll, and a warning per
                # DISCOVER_INTERVAL_S is log spam, not signal.
                now = time.monotonic()
                if now - self._readmit_warned.get(h, -1e9) > 60.0:
                    self._readmit_warned[h] = now
                    get_logger().warning(
                        "discoverable capacity below minimum with hosts "
                        "blacklisted; readmitting %r (pool-starvation "
                        "escape, overrides a permanent blacklist — see "
                        "docs/knobs.md; --reset-limit still bounds crash "
                        "loops)", h)
                self.blacklist.forgive(h)
                found[h] = found_all[h]
                if sum(found.values()) >= self.min_required:
                    break
        with self._lock:
            prev = self.current_hosts
            removed = [h for h in prev if h not in found]
            added = [h for h in found if h not in prev]
            changed = [h for h in found
                       if h in prev and prev[h] != found[h]]
            self.current_hosts = found
        if removed or changed:
            return 1
        if added:
            return 2  # additive
        return 0

    def host_assignments(self, np_: int) -> List[_hosts.SlotInfo]:
        with self._lock:
            host_list = [_hosts.HostInfo(h, s)
                         for h, s in self.current_hosts.items()]
        return _hosts.get_host_assignments(host_list, np_, np_)

    @property
    def available_slots(self) -> int:
        with self._lock:
            return sum(self.current_hosts.values())
