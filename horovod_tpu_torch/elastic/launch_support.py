"""Worker process launch for elastic runs (gloo_run.py:370 elastic variant).

Copy of ``horovod_tpu/elastic/launch_support.py`` (framework-free; the
port keeps its own copy).  ``HVD_TPU_COORDINATOR`` names the world
store that rank 0 serves for the generation (``coordinator_port_for``).

Each worker process gets HOROVOD_ELASTIC=1 plus the rendezvous address; its
rank/size env reflects the slot at spawn time, but on re-rendezvous the
worker refreshes them from the KV store (elastic/__init__.py
_refresh_world_from_rendezvous) because ranks can change across resets.
HVD_TPU_WORLD_VERSION pins the world generation the worker was spawned
into, so post-reset refreshes can reject stale slot records.
"""

from __future__ import annotations

import os
import threading
from typing import Callable

from .. import config as _config
from ..runner import hosts as _hosts
from ..runner import safe_shell_exec
from ..runner.launch import env_from_args, _is_local, _ssh_command


def _coord_base() -> int:
    return int(os.environ.get("HVD_TPU_COORD_PORT", 29400))


def _coord_port(world_version: int) -> int:
    from . import coordinator_port_for
    return coordinator_port_for(_coord_base(), world_version)


def slot_env(slot: _hosts.SlotInfo, world_version: int, addr: str,
             port: int, driver, coord_base: int = None) -> dict:
    """The elastic worker protocol env for one slot incarnation — the ONE
    place the field set lives."""
    from . import coordinator_port_for
    coord_base = coord_base if coord_base is not None else _coord_base()
    return {
        _config.HOROVOD_RANK: str(slot.rank),
        _config.HOROVOD_SIZE: str(slot.size),
        _config.HOROVOD_LOCAL_RANK: str(slot.local_rank),
        _config.HOROVOD_LOCAL_SIZE: str(slot.local_size),
        _config.HOROVOD_CROSS_RANK: str(slot.cross_rank),
        _config.HOROVOD_CROSS_SIZE: str(slot.cross_size),
        _config.HOROVOD_HOSTNAME: slot.hostname,
        _config.HOROVOD_RENDEZVOUS_ADDR: addr,
        _config.HOROVOD_RENDEZVOUS_PORT: str(port),
        "HOROVOD_ELASTIC": "1",
        "HVD_TPU_WORLD_VERSION": str(world_version),
        # Negotiation generation of the spawned world (matches the
        # survivors' post-refresh value — see elastic._reset).
        "HVD_TPU_NEGOTIATION_GEN": f"{world_version}.0",
        # Spawn-time discovery sequence: the notification manager
        # baselines here so pre-spawn updates are not replayed and
        # post-spawn ones are never missed.
        "HVD_TPU_DISCOVERY_SEQ": str(getattr(driver, "_update_seq", 0)),
        # Per-incarnation store port (elastic/__init__.py
        # coordinator_port_for): every world reshape gets a FRESH
        # TCPStore, so no rank reads an old generation's records.
        "HVD_TPU_COORD_BASE": str(coord_base),
        "HVD_TPU_COORDINATOR":
            f"{addr}:{coordinator_port_for(coord_base, world_version)}",
    }


def make_elastic_worker_fn(args, addr: str, port: int, driver) -> Callable:
    base_env = dict(os.environ)
    base_env.update(env_from_args(args))

    def worker_fn(slot: _hosts.SlotInfo, terminate_event: threading.Event,
                  world_version: int):
        env = dict(base_env)
        env.update(slot_env(slot, world_version, addr, port, driver))
        prefix = f"[{slot.rank}]<stdout>:"
        cmd = args.command if _is_local(slot.hostname) else \
            _ssh_command(slot, args.command, env, args)
        return safe_shell_exec.execute(
            cmd, env=env, prefix=prefix,
            prefix_timestamp=getattr(args, "prefix_output_with_timestamp",
                                     False),
            events=[terminate_event])

    return worker_fn
