"""LSF allocation discovery and jsrun availability.

Copy of ``horovod_tpu/runner/lsf.py`` (framework-free).  Reference:
horovod/runner/util/lsf.py:35 (LSFUtils: detects LSF via LSB_JOBID,
resolves the allocation's compute hosts and per-host slot counts) and
horovod/runner/js_run.py:28 (is_jsrun_installed).  The hosts come from
LSF's own portable environment, ``LSB_DJOB_HOSTFILE`` (one line per
granted slot) with ``LSB_MCPU_HOSTS`` ("host1 n1 host2 n2 ...") as the
fallback, which every LSF deployment sets.  A granted slot hosts one
worker process, which drives one card.
"""

from __future__ import annotations

import os
import shutil
from typing import List

from . import hosts as _hosts


def using_lsf() -> bool:
    """True when this process runs inside an LSF job (util/lsf.py:35)."""
    return "LSB_JOBID" in os.environ


def is_jsrun_installed() -> bool:
    """True if the jsrun launcher is on PATH (js_run.py:28)."""
    return shutil.which("jsrun") is not None


def lsf_hosts() -> List[_hosts.HostInfo]:
    """The allocation's hosts with slot counts, first-seen order preserved
    (rank 0 lands on the first granted host, matching jsrun's ERF order).

    Raises ``RuntimeError`` outside an allocation or when neither LSF
    host variable is present."""
    if not using_lsf():
        raise RuntimeError("not inside an LSF allocation (LSB_JOBID unset)")
    counts: dict = {}
    hostfile = os.environ.get("LSB_DJOB_HOSTFILE")
    if hostfile and os.path.exists(hostfile):
        with open(hostfile) as f:
            for line in f:
                h = line.strip()
                if h:
                    counts[h] = counts.get(h, 0) + 1
    else:
        toks = os.environ.get("LSB_MCPU_HOSTS", "").split()
        for h, n in zip(toks[::2], toks[1::2]):
            counts[h] = counts.get(h, 0) + int(n)
    if not counts:
        raise RuntimeError(
            "LSF allocation exposes no hosts (neither LSB_DJOB_HOSTFILE "
            "nor LSB_MCPU_HOSTS is usable)")
    # Summit-style deployments list the BATCH node (where the job script —
    # i.e. this launcher — runs) first with one slot, ahead of the compute
    # nodes; the reference's CSM query returns compute nodes only.  Drop a
    # leading 1-slot entry matching this host when other hosts exist, so a
    # rank is never pinned to the batch node.  Opt out with
    # HVD_TPU_LSF_INCLUDE_LAUNCH_HOST=1 (clusters whose first host is a
    # real compute host with one granted slot).
    items = list(counts.items())
    if (len(items) > 1 and items[0][1] == 1
            and os.environ.get("HVD_TPU_LSF_INCLUDE_LAUNCH_HOST") != "1"):
        import socket
        first = items[0][0]
        me = socket.gethostname()
        if first == me or first == me.split(".")[0] or \
                first.split(".")[0] == me.split(".")[0]:
            items = items[1:]
    return [_hosts.HostInfo(h, n) for h, n in items]
