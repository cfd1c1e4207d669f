"""Rank-tagged logging (reference: common/logging.h:16,56 LOG(level, rank)
macros with HOROVOD_LOG_LEVEL / HOROVOD_LOG_HIDE_TIME env control).

Copied from ``horovod_tpu/utils/logging.py``; the two env names and the
boolean parse it read from ``horovod_tpu/config.py`` are inlined, so the
port never imports the JAX package."""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}

HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"
HOROVOD_LOG_HIDE_TIME = "HOROVOD_LOG_HIDE_TIME"

_logger = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        _logger = logging.getLogger("horovod_tpu_torch")
        level = os.environ.get(HOROVOD_LOG_LEVEL, "warning").lower()
        _logger.setLevel(_LEVELS.get(level, logging.WARNING))
        if not _logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            hide_ts = os.environ.get(HOROVOD_LOG_HIDE_TIME, "").strip() \
                .lower() in ("1", "true", "yes", "on")
            fmt = "[%(name)s] %(message)s" if hide_ts else \
                "%(asctime)s [%(name)s] %(message)s"
            handler.setFormatter(logging.Formatter(fmt))
            _logger.addHandler(handler)
        _logger.propagate = False
    return _logger
