"""NCCL's own record of a rank's exchange: the transport of each channel
and the algorithm and protocol it picked for each collective.

``begin`` points NCCL's INFO log (subsystems ``INIT``, ``P2P`` and
``TUNING``) at a file in a new temporary directory; it has to run before
the process's first communicator.  ``end`` reads the file back as one
line for standard error and removes the directory.  A rank that made no
communicator leaves no file, and its line says so.  NCCL logs its choice
of algorithm and protocol on each communicator's rank 0 alone; the
other ranks of a communicator make the same choice.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from collections import Counter
from typing import Dict, Optional

SETTINGS = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,P2P,TUNING"}
FILE = "nccl.log"

# NCCL's numbering where a version logs numbers, not names.
ALGOS = ("TREE", "RING", "COLLNET_DIRECT", "COLLNET_CHAIN", "NVLS",
         "NVLS_TREE", "PAT")
PROTOS = ("LL", "LL128", "SIMPLE")

_VERSION = re.compile(r"NCCL version (\S+)")
_CHANNEL = re.compile(r"Channel \d+/\d+ : .*? via (\S+)")
_CHOICE = re.compile(
    r"(\w+): (\d+) Bytes -> Algo (\w+) proto (\w+)")


def begin() -> str:
    """Set NCCL's log up in this process; returns its directory."""
    d = tempfile.mkdtemp(prefix="hvdbench-nccl-")
    os.environ.update(SETTINGS, NCCL_DEBUG_FILE=os.path.join(d, FILE))
    return d


def _name(value: str, names) -> str:
    return names[int(value)] if value.isdigit() and int(value) < len(names) \
        else value


def summarize(text: Optional[str]) -> str:
    """One line: NCCL's version, the channels' transports and, for each
    collective, algorithm and protocol, its calls and bytes."""
    if not text:
        return "no NCCL communicator"
    version = _VERSION.search(text)
    transports = Counter(_CHANNEL.findall(text))
    calls: Counter = Counter()
    nbytes: Dict[tuple, int] = Counter()
    for func, size, algo, proto in _CHOICE.findall(text):
        key = (func, _name(algo, ALGOS), _name(proto, PROTOS))
        calls[key] += 1
        nbytes[key] += int(size)
    parts = [f"NCCL {version.group(1) if version else '(version not logged)'}"]
    parts.append("transports " + (", ".join(
        f"{t} x{n}" for t, n in sorted(transports.items()))
        if transports else "not logged"))
    parts.append("collectives " + (", ".join(
        f"{f} {a}/{p} x{calls[(f, a, p)]} ({nbytes[(f, a, p)] / 1e9:.3f} GB)"
        for f, a, p in sorted(calls)) if calls
        else "not logged here (NCCL logs them on a communicator's rank 0)"))
    return "; ".join(parts)


def end(d: str) -> str:
    """The summary of the log in ``d``; ``d`` is removed."""
    try:
        with open(os.path.join(d, FILE), errors="replace") as f:
            text = f.read()
    except OSError:
        text = None
    shutil.rmtree(d, ignore_errors=True)
    return summarize(text)
