"""NIC probing and cross-host interface intersection.

Copy of ``horovod_tpu/runner/nic_probe.py`` (framework-free).  Reference:
horovod/runner/driver/driver_service.py:122-194: the launcher starts a
transient probe on every remote host (ssh), learns each host's network
interfaces, and finds the launcher address every host can reach, so the
rendezvous and store traffic uses an interface the whole job shares.

One round trip, nothing lingers: the launcher passes its full candidate
address list to the probe; the probe tries each candidate against the
live rendezvous KV port (the reachability test is the registration
path) and PUTs one report ``{interfaces, reachable, addr}`` through
whichever candidate worked, then exits.  The launcher intersects the
interface names and picks the first candidate present in every host's
reachable set.

Module CLI (what the launcher ssh-launches on each remote host)::

    python -m horovod_tpu_torch.runner.nic_probe \
        --candidates 10.0.0.5:41231,192.168.1.5:41231 --host h1
"""

from __future__ import annotations

import json
import socket
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PROBE_SCOPE = "nicprobe"


def local_interfaces(include_loopback: bool = False) -> Dict[str, List[str]]:
    """iface -> IPv4 addresses on this host (the task-service NIC report).
    Uses psutil when present; degrades to a hostname-resolution singleton
    otherwise (psutil ships in this image but is an optional extra)."""
    try:
        import psutil
    except ImportError:
        try:
            return {"default": [socket.gethostbyname(socket.gethostname())]}
        except OSError:
            return {}
    out: Dict[str, List[str]] = {}
    for name, addrs in psutil.net_if_addrs().items():
        v4 = [a.address for a in addrs if a.family == socket.AF_INET]
        if not v4:
            continue
        if not include_loopback and all(a.startswith("127.") for a in v4):
            continue
        out[name] = v4
    return out


def addr_for_interfaces(nics: Sequence[str]) -> Optional[str]:
    """First local IPv4 address on the named interfaces
    (--network-interface handling, the reference's explicit-NIC path)."""
    ifaces = local_interfaces(include_loopback=True)
    for nic in nics:
        for a in ifaces.get(nic, []):
            return a
    return None


def _source_addr_toward(addr: str, port: int) -> Optional[str]:
    """The local address the route toward ``addr`` uses (UDP-connect +
    getsockname — avoids gethostbyname's 127.0.1.1 trap on stock
    Debian/Ubuntu /etc/hosts entries)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((addr, port))
            return s.getsockname()[0]
    except OSError:
        return None


def _try_put(addr: str, port: int, path: str, body: bytes,
             timeout: float = 3.0) -> bool:
    import http.client
    try:
        conn = http.client.HTTPConnection(addr, port, timeout=timeout)
        try:
            conn.request("PUT", path, body=body)
            return conn.getresponse().status < 400
        finally:
            conn.close()
    except OSError:
        return False


def probe_and_report(host: str, candidates: Sequence[Tuple[str, int]],
                     interfaces: Optional[Dict[str, List[str]]] = None
                     ) -> bool:
    """Probe-side body: test every candidate launcher address against the
    live KV port (the reachability test doubles as the transport), then
    publish one report through any candidate that worked.  Returns whether
    a report was delivered."""
    reachable = [a for a, p in candidates
                 if _try_put(a, p, f"/{PROBE_SCOPE}/ping/{host}", b"1")]
    report = {
        "interfaces": interfaces if interfaces is not None
        else local_interfaces(),
        "reachable": reachable,
        "addr": (_source_addr_toward(*candidates[0])
                 if candidates else None),
    }
    body = json.dumps(report).encode()
    for a, p in candidates:
        if a in reachable and _try_put(a, p,
                                       f"/{PROBE_SCOPE}/report/{host}",
                                       body):
            return True
    return False


def discover_common_address(kv_server, remote_hosts: Sequence[str],
                            spawn_probe: Callable[[str], None],
                            candidate_addrs: Sequence[str],
                            candidate_port: int,
                            timeout: float = 30.0):
    """Launcher-side flow (driver_service.py:218 get_common_interfaces):
    launch a probe per remote host, wait for their reports, intersect
    interface names (including the launcher's own), and pick the first
    candidate address every host reported reachable.

    Returns (common_interface_names, routable_addr_or_None).  Probes exit
    on their own after reporting — nothing to retire."""
    import threading
    import time
    del candidate_port  # candidates are probed by the remote side
    for h in remote_hosts:
        threading.Thread(target=spawn_probe, args=(h,), daemon=True,
                         name=f"hvd-nicprobe-{h}").start()
    reports: Dict[str, dict] = {}
    deadline = time.time() + timeout
    while len(reports) < len(remote_hosts) and time.time() < deadline:
        for h in remote_hosts:
            if h in reports:
                continue
            raw = kv_server.get(PROBE_SCOPE, f"report/{h}")
            if raw:
                reports[h] = json.loads(raw)
        time.sleep(0.2)
    missing = [h for h in remote_hosts if h not in reports]
    if missing:
        raise TimeoutError(
            f"NIC probes never reported from {missing} (ssh reachability / "
            f"no candidate launcher address dialable from there?)")
    common = set(local_interfaces().keys())
    for rep in reports.values():
        common &= set(rep.get("interfaces", {}).keys())
    routable = None
    for a in candidate_addrs:
        if all(a in rep.get("reachable", ()) for rep in reports.values()):
            routable = a
            break
    return sorted(common), routable


def main(argv=None):  # CLI: the ssh-launched remote probe
    import argparse
    import sys
    p = argparse.ArgumentParser()
    p.add_argument("--candidates", required=True,
                   help="comma-separated launcher addr:port candidates")
    p.add_argument("--host", required=True, help="this host's name")
    args = p.parse_args(argv)
    candidates = []
    for c in args.candidates.split(","):
        addr, _, port = c.rpartition(":")
        candidates.append((addr, int(port)))
    ok = probe_and_report(args.host, candidates)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
