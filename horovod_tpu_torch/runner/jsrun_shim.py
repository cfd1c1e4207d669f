"""Per-task shim for jsrun launches: JSM rank -> rendezvous slot env.

Copy of ``horovod_tpu/runner/jsrun_shim.py`` (framework-free).  jsrun
starts every task with the same command line, so the launcher wraps the
user command in this shim: it reads the task's global rank from the
JSM/PMIx environment (JSM_NAMESPACE_RANK, falling back to
OMPI_COMM_WORLD_RANK / PMIX_RANK), fetches its SlotInfo record from the
launcher's rendezvous KV (``RendezvousServer.init`` publishes
``rank/{n}``), exports the standard worker env, and execs the user
command.  Reference analog: horovod/runner/js_run.py:34, where the
workers learn their rank from the MPI runtime instead.

Usage (constructed by launch.py's jsrun branch):
    jsrun --erf_input <rankfile> python -m horovod_tpu_torch.runner.jsrun_shim \
        <command> [args...]
"""

from __future__ import annotations

import json
import os
import sys
import time

from .. import config as _config
from .hosts import SlotInfo
from .http_server import KVStoreClient

_RANK_VARS = ("JSM_NAMESPACE_RANK", "OMPI_COMM_WORLD_RANK", "PMIX_RANK")
_SIZE_VARS = ("JSM_NAMESPACE_SIZE", "OMPI_COMM_WORLD_SIZE")


def _jsm_rank() -> int:
    for var in _RANK_VARS:
        v = os.environ.get(var)
        if v is not None:
            return int(v)
    raise SystemExit(
        "jsrun_shim: no task rank in the environment (expected one of "
        f"{', '.join(_RANK_VARS)}); was this process started by jsrun?")


def _jsm_size():
    for var in _SIZE_VARS:
        v = os.environ.get(var)
        if v is not None:
            return int(v)
    return None


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit("jsrun_shim: no command to exec")
    rank = _jsm_rank()
    addr = os.environ[_config.HOROVOD_RENDEZVOUS_ADDR]
    port = int(os.environ[_config.HOROVOD_RENDEZVOUS_PORT])
    client = KVStoreClient(addr, port)
    deadline = time.time() + float(os.environ.get(
        "HVD_TPU_JSRUN_SHIM_TIMEOUT_S", "60"))
    while True:
        raw = client.get("rendezvous", f"rank/{rank}",
                         wait=min(5.0, max(0.1, deadline - time.time())))
        if raw is not None:
            break
        if time.time() >= deadline:
            raise SystemExit(
                f"jsrun_shim: rendezvous at {addr}:{port} never published "
                f"a slot record for rank {rank}")
    slot = SlotInfo.from_dict(json.loads(raw))
    jsm_size = _jsm_size()
    if jsm_size is not None and jsm_size != slot.size:
        # --binding-args started a different task count than the launcher
        # assigned slots for; a size mismatch would hang the collectives
        # at init, so fail fast and name the cause.
        raise SystemExit(
            f"jsrun_shim: jsrun started {jsm_size} tasks but the launcher "
            f"assigned {slot.size} slots — check --binding-args against "
            f"-np/the allocation")
    os.environ.update(slot.env())
    out_dir = os.environ.get("HVD_TPU_OUTPUT_DIR")
    if out_dir:
        # --output-filename's per-rank directory contract (launch.py
        # run_slot): rank.N/stdout|stderr, same shape as the ssh path.
        d = os.path.join(out_dir, f"rank.{slot.rank}")
        os.makedirs(d, exist_ok=True)
        for name, fd in (("stdout", 1), ("stderr", 2)):
            f = open(os.path.join(d, name), "w")
            os.dup2(f.fileno(), fd)
    os.execvp(argv[0], argv)


if __name__ == "__main__":
    main()
