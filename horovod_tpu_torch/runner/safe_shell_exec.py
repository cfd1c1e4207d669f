"""Subprocess execution with process-group cleanup and output forwarding.

Copy of ``horovod_tpu/runner/safe_shell_exec.py`` (framework-free; the
port keeps its own copy).


Reference: horovod/runner/common/util/safe_shell_exec.py — fork/exec with a
process group so the whole worker tree dies together, stdout/err forwarding
threads with per-rank prefixes, and event-triggered termination.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

GRACEFUL_TERMINATION_TIME_S = 5


def _forward_stream(stream, out, prefix: str, prefix_timestamp: bool):
    """Line-forward a worker stream with "[rank]<tag>" prefixes
    (gloo_run.py:116-201 output forwarding)."""
    for raw in iter(stream.readline, b""):
        line = raw.decode(errors="replace")
        if prefix:
            ts = time.strftime("%Y-%m-%d %H:%M:%S: ") if prefix_timestamp \
                else ""
            line = f"{prefix}{ts}{line}"
        out.write(line)
        out.flush()
    stream.close()


def execute(command, env: Optional[Dict[str, str]] = None,
            stdout=None, stderr=None, prefix: str = "",
            prefix_timestamp: bool = False,
            events: Optional[List[threading.Event]] = None) -> int:
    """Run command in its own process group; on event or interrupt, terminate
    the whole group (safe_shell_exec.py semantics)."""
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr
    proc = subprocess.Popen(
        command, env=env, shell=isinstance(command, str),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        preexec_fn=os.setsid)

    threads = [
        threading.Thread(target=_forward_stream,
                         args=(proc.stdout, stdout, prefix, prefix_timestamp),
                         daemon=True),
        threading.Thread(target=_forward_stream,
                         args=(proc.stderr, stderr, prefix, prefix_timestamp),
                         daemon=True),
    ]
    for t in threads:
        t.start()

    stop_watcher = threading.Event()

    def watch_events():
        while not stop_watcher.is_set():
            if events and any(e.is_set() for e in events):
                terminate(proc)
                return
            time.sleep(0.1)

    watcher = None
    if events:
        watcher = threading.Thread(target=watch_events, daemon=True)
        watcher.start()

    try:
        ret = proc.wait()
    except KeyboardInterrupt:
        terminate(proc)
        ret = proc.wait()
    finally:
        stop_watcher.set()
    for t in threads:
        t.join(timeout=1)
    if watcher:
        watcher.join(timeout=1)
    return ret


def terminate(proc: subprocess.Popen) -> None:
    """SIGTERM the process group, escalate to SIGKILL after the grace
    period."""
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        return
    deadline = time.time() + GRACEFUL_TERMINATION_TIME_S
    while time.time() < deadline:
        if proc.poll() is not None:
            return
        time.sleep(0.1)
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
