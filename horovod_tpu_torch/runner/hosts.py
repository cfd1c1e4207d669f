"""Host spec parsing + rank assignment.

Copy of ``horovod_tpu/runner/hosts.py`` (framework-free; the port keeps
its own copy because it imports nothing of the JAX package).


Reference: horovod/runner/common/util/hosts.py:22 (parse_hosts: "h1:4,h2:4"),
:34 (parse_host_files), :100 (get_host_assignments: round-robin rank →
(host, slot) with local/cross rank computation).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(host_string: str) -> "HostInfo":
        if ":" in host_string:
            name, slots = host_string.rsplit(":", 1)
            return HostInfo(name.strip(), int(slots))
        return HostInfo(host_string.strip(), 1)


@dataclasses.dataclass
class SlotInfo:
    """One rank's placement (runner/common/util/hosts.py SlotInfo)."""
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "SlotInfo":
        return SlotInfo(**d)

    def env(self) -> Dict[str, str]:
        """The per-worker HOROVOD_* identity env for this slot — the ONE
        place that owns the slot-to-env contract (used by the launcher's
        per-slot spawn and by the jsrun shim; gloo_run.py:66-78)."""
        from .. import config as _config
        return {
            _config.HOROVOD_RANK: str(self.rank),
            _config.HOROVOD_SIZE: str(self.size),
            _config.HOROVOD_LOCAL_RANK: str(self.local_rank),
            _config.HOROVOD_LOCAL_SIZE: str(self.local_size),
            _config.HOROVOD_CROSS_RANK: str(self.cross_rank),
            _config.HOROVOD_CROSS_SIZE: str(self.cross_size),
            _config.HOROVOD_HOSTNAME: self.hostname,
        }


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """"host1:2,host2:4" → [HostInfo] (hosts.py:22)."""
    return [HostInfo.from_string(h)
            for h in hosts_string.split(",") if h.strip()]


def parse_host_files(filename: str) -> List[HostInfo]:
    """Hostfile with "hostname slots=N" lines (hosts.py:34)."""
    hosts = []
    with open(filename) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            name = parts[0]
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p.split("=", 1)[1])
            hosts.append(HostInfo(name, slots))
    return hosts


def get_host_assignments(hosts: List[HostInfo], min_np: int,
                         max_np: Optional[int] = None) -> List[SlotInfo]:
    """Assign ranks to host slots, computing local/cross ranks
    (hosts.py:100).  Rank order: fill each host's slots in host order, like
    the reference (rank = host-major), so local ranks are contiguous."""
    if max_np is None:
        max_np = min_np
    # Merge duplicate hostnames additively ("h1:2,h1:2" ≡ "h1:4"), keeping
    # first-seen order — otherwise local/cross rank bookkeeping would emit
    # duplicate (host, local_rank) pairs.
    merged: Dict[str, HostInfo] = {}
    for h in hosts:
        if h.hostname in merged:
            merged[h.hostname] = HostInfo(
                h.hostname, merged[h.hostname].slots + h.slots)
        else:
            merged[h.hostname] = HostInfo(h.hostname, h.slots)
    hosts = list(merged.values())
    total = sum(h.slots for h in hosts)
    if total < min_np:
        raise ValueError(
            f"Requested {min_np} processes but only {total} slots available "
            f"on {[h.hostname for h in hosts]}")
    np_ = min(total, max_np)
    assignments: List[SlotInfo] = []
    rank = 0
    local_sizes: Dict[str, int] = {}
    cross_ranks: Dict[str, int] = {}
    for host_idx, h in enumerate(hosts):
        if rank >= np_:
            break
        use = min(h.slots, np_ - rank)
        cross_ranks[h.hostname] = len(cross_ranks)
        local_sizes[h.hostname] = use
        for local in range(use):
            assignments.append(SlotInfo(
                hostname=h.hostname, rank=rank, local_rank=local,
                cross_rank=cross_ranks[h.hostname],
                size=np_, local_size=use, cross_size=0))
            rank += 1
    n_hosts = len(cross_ranks)
    for a in assignments:
        a.cross_size = n_hosts
    return assignments
