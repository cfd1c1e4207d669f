"""The knobs the port's training path reads, from the environment.

Port of the part of ``horovod_tpu/config.py`` that the data-parallel
path reads: the fusion threshold (``HOROVOD_FUSION_THRESHOLD``, 128 MiB
by default, as in the reference's ``operations.cc:519``), the log level,
and the names of the rank, size and rendezvous variables a launcher
(``horovodrun``) exports.  The knob names are the reference's, so job
scripts keep working.
"""

from __future__ import annotations

import dataclasses
import os

HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"
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

DEFAULT_FUSION_THRESHOLD = 128 * 1024 * 1024


def env_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return int(val)
    except ValueError:
        return default


@dataclasses.dataclass
class Config:
    """The runtime knobs, resolved once at ``init()``."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD
    log_level: str = "warning"

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            fusion_threshold_bytes=env_int(HOROVOD_FUSION_THRESHOLD,
                                           DEFAULT_FUSION_THRESHOLD),
            log_level=os.environ.get(HOROVOD_LOG_LEVEL, "warning"),
        )
