"""The knobs the port's training path reads, from the environment.

Port of the part of ``horovod_tpu/config.py`` that the data-parallel
path and the eager engine read (``:99-150``): the fusion threshold
(``HOROVOD_FUSION_THRESHOLD``, 128 MiB by default, as in the reference's
``operations.cc:519``), the name of the world's mesh axis
(``HVD_TPU_MESH_AXIS``, ``"hvd"``), the log level, the response cache's capacity,
the timeline, the stall inspector, the negotiation timeout
(``HOROVOD_GLOO_TIMEOUT_SECONDS``), and the names of the rank, size and
rendezvous variables a launcher (``horovodrun``) exports.  The knob names
and defaults are the reference's, so job scripts keep working.  The
hierarchical switches are not read: the public ``allreduce`` stays flat,
as in the JAX package, and the two-level form is the explicit
``hvd.hierarchical_allreduce``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"
HOROVOD_CACHE_CAPACITY = "HOROVOD_CACHE_CAPACITY"
HOROVOD_TIMELINE = "HOROVOD_TIMELINE"
HOROVOD_TIMELINE_MARK_CYCLES = "HOROVOD_TIMELINE_MARK_CYCLES"
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_STALL_CHECK_TIME_SECONDS = "HOROVOD_STALL_CHECK_TIME_SECONDS"
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS = "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"
HOROVOD_GLOO_TIMEOUT_SECONDS = "HOROVOD_GLOO_TIMEOUT_SECONDS"
# Rendezvous / rank env injected by the launcher (runner/gloo_run.py:66-78,
# common/gloo/gloo_context.h:28-42 in the reference).
HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_SIZE = "HOROVOD_SIZE"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_CROSS_RANK = "HOROVOD_CROSS_RANK"
HOROVOD_CROSS_SIZE = "HOROVOD_CROSS_SIZE"
HOROVOD_RENDEZVOUS_ADDR = "HOROVOD_GLOO_RENDEZVOUS_ADDR"
HOROVOD_RENDEZVOUS_PORT = "HOROVOD_GLOO_RENDEZVOUS_PORT"
# host:port of the process-group store; defaults to the rendezvous
# address at port + 1 (the JAX package's coordinator rule, core.py:103).
HVD_TPU_COORDINATOR = "HVD_TPU_COORDINATOR"
# The name of the world's one mesh axis (``core.mesh_axis()``).
HVD_TPU_MESH_AXIS = "HVD_TPU_MESH_AXIS"

DEFAULT_FUSION_THRESHOLD = 128 * 1024 * 1024


def env_bool(name: str, default: bool = False) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def env_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return int(val)
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return float(val)
    except ValueError:
        return default


@dataclasses.dataclass
class Config:
    """The runtime knobs, resolved once at ``init()``."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD
    log_level: str = "warning"
    cache_capacity: int = 1024
    timeline_path: Optional[str] = None
    timeline_mark_cycles: bool = False
    stall_check_enabled: bool = True
    stall_warning_time_seconds: float = 60.0
    stall_shutdown_time_seconds: float = 0.0
    # How long negotiation and join wait for the other ranks.
    gloo_timeout_seconds: float = 300.0
    mesh_axis: str = "hvd"

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            fusion_threshold_bytes=env_int(HOROVOD_FUSION_THRESHOLD,
                                           DEFAULT_FUSION_THRESHOLD),
            log_level=os.environ.get(HOROVOD_LOG_LEVEL, "warning"),
            cache_capacity=env_int(HOROVOD_CACHE_CAPACITY, 1024),
            timeline_path=os.environ.get(HOROVOD_TIMELINE),
            timeline_mark_cycles=env_bool(HOROVOD_TIMELINE_MARK_CYCLES),
            stall_check_enabled=not env_bool(HOROVOD_STALL_CHECK_DISABLE),
            stall_warning_time_seconds=env_float(
                HOROVOD_STALL_CHECK_TIME_SECONDS, 60.0),
            stall_shutdown_time_seconds=env_float(
                HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, 0.0),
            gloo_timeout_seconds=env_float(HOROVOD_GLOO_TIMEOUT_SECONDS,
                                           300.0),
            mesh_axis=os.environ.get(HVD_TPU_MESH_AXIS, "hvd"),
        )
