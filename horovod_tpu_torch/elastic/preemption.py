"""Preemption / maintenance-event handling: advance notice of a host's
loss turned into a graceful drain.

Copied from ``horovod_tpu/elastic/preemption.py`` (framework-free; the
port keeps its own copy).  The sentinel polls the cloud metadata
server's maintenance-event endpoint (GCP's by default, any URL through
``HVD_TPU_MAINTENANCE_URL``) and fires the ``preempt.poll`` fault point.

Reference: horovod/runner/elastic/discovery.py:146 HostManager learns about
failed hosts AFTER they die (worker exit / discovery script).  On cloud
VMs (GCP's TPU and GPU VMs) the platform announces maintenance and
preemption IN ADVANCE through the per-VM metadata server
(``instance/maintenance-event`` returns NONE until an event is
scheduled).  Handling the notice turns a crash recovery
(progress since the last commit lost) into a graceful drain: the condemned
host's workers commit at the next step, the world reshapes without them,
zero steps lost.

Split (mirrors the reference's worker-service/driver split):

* :class:`PreemptionSentinel` runs on each worker host — only the VM
  itself can reach its own metadata endpoint — polling the maintenance
  URL and publishing/clearing a ``{host}`` marker in the rendezvous KV
  scope ``preempt``.  Started by ``WorkerNotificationManager.init`` in
  elastic runs; URL overridable via ``HVD_TPU_MAINTENANCE_URL`` (tests
  point it at a mock server).
* :class:`PreemptionAwareDiscovery` wraps the driver's HostDiscovery and
  filters marked hosts out of the discovered set, so the ElasticDriver
  sees the host "removed" while it is still alive.  The driver gives
  workers on preempt-marked hosts a drain window (decommission semantics,
  driver.py ``_terminate_workers_on_lost_hosts``) instead of the
  immediate terminate a dead host gets.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Callable, Dict, Optional, Set

from ..utils import get_logger
from .discovery import HostDiscovery

#: GCP metadata server; returns "NONE" or an event such as
#: "TERMINATE_ON_HOST_MAINTENANCE".  VM preemption surfaces here and
#: via the ACPI shutdown signal; the metadata poll is the advance notice.
DEFAULT_METADATA_URL = ("http://metadata.google.internal/computeMetadata/"
                        "v1/instance/maintenance-event")

PREEMPT_SCOPE = "preempt"

#: How often an already-published marker is re-PUT (insurance against a KV
#: restart dropping it); between refreshes an active event costs no writes.
MARKER_REFRESH_S = 60.0


class PreemptionSentinel:
    """Worker-host daemon publishing this host's maintenance notice into
    the rendezvous KV (and clearing it if the event is cancelled)."""

    def __init__(self, client, hostname: Optional[str] = None,
                 url: Optional[str] = None,
                 poll_interval_s: Optional[float] = None):
        self.client = client
        # The marker must match the DRIVER's notion of this host (the
        # discovery script's names, stamped into HOROVOD_HOSTNAME by the
        # launcher) — gethostname() alone can differ (IP vs alias) and a
        # mismatched marker would silently disable the drain.
        self.host = hostname or os.environ.get("HOROVOD_HOSTNAME",
                                               socket.gethostname())
        self.url = url or os.environ.get("HVD_TPU_MAINTENANCE_URL",
                                         DEFAULT_METADATA_URL)
        self.poll_interval_s = poll_interval_s if poll_interval_s is not None \
            else float(os.environ.get("HVD_TPU_MAINTENANCE_POLL_S", "5"))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._marked = False
        self._marker_refresh_at = 0.0
        self._startup_reconciled = False
        from ..faultline import runtime as _flrt
        _flrt.maybe_install_from_env()

    def _poll_once(self) -> Optional[str]:
        """Current maintenance event, or None when the endpoint is
        unreachable (non-GCP hosts: treated as no notice)."""
        import urllib.request
        req = urllib.request.Request(
            self.url, headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(req, timeout=2) as resp:
                return resp.read().decode("utf-8", "replace").strip()
        except Exception as e:
            get_logger().debug("maintenance-event poll failed: %s", e)
            return None

    def step(self) -> None:
        """One poll + marker reconciliation (exposed for tests)."""
        event = self._poll_once()
        from ..faultline import runtime as _flrt
        plan = _flrt.PLAN
        if plan is not None:
            # ``preempt.poll`` injection point (marker publication): a
            # kill-rank fault makes this poll behave exactly as if the
            # metadata server announced maintenance — the marker goes out
            # through the real publish/refresh/clear state machine, so a
            # chaos run proves the whole notice→drain→clear→scale-up
            # loop, not a shortcut around it.  ONLY for plans that
            # exercise this point, an unreachable endpoint reads as
            # "NONE" (the hermetic chaos world has no metadata server;
            # without this substitution the cancelled event could never
            # clear its marker) — a plan poking other layers must not
            # convert a real metadata outage into a marker clear.
            fired = plan.fire("preempt.poll", self.host)
            if any(f.kind == "kill-rank" for f in fired):
                event = "FAULTLINE_PREEMPT"
            elif event is None and plan.targets_point("preempt.poll"):
                event = "NONE"
        if event and event != "NONE":
            if not self._marked:
                get_logger().warning(
                    "TPU maintenance notice on %s: %s — requesting "
                    "graceful drain", self.host, event)
            # Publish once, then only refresh occasionally (covers a KV
            # restart losing the marker): a re-PUT every poll for the
            # whole maintenance window is steady needless control-plane
            # write load.
            now = time.monotonic()
            if self._marked and now < self._marker_refresh_at:
                return
            try:
                self.client.put(PREEMPT_SCOPE, self.host, event.encode())
                self._marked = True
                self._marker_refresh_at = now + MARKER_REFRESH_S
            except Exception as e:
                # Retry next poll.  A failed INITIAL publish leaves _marked
                # False naturally; a failed REFRESH must NOT reset _marked —
                # the marker is still stored, and forgetting it would gate
                # off the clear branch and strand the marker (permanent
                # host exclusion) if the event later cancels.
                self._marker_refresh_at = now
                get_logger().warning("could not publish preemption "
                                     "marker: %s", e)
        elif event == "NONE" and (self._marked or
                                  not self._startup_reconciled):
            # Cancelled event — or a STALE marker left by a previous
            # incarnation of this host (its sentinel died with the drained
            # workers; only a live sentinel can clear the marker, so every
            # sentinel reconciles once at startup or the host could never
            # rejoin the pool).  The reconcile counts only when the delete
            # SUCCEEDS — a transient KV error here must retry next poll,
            # not silently leave the host excluded forever.
            try:
                self.client.delete(PREEMPT_SCOPE, self.host)
                if self._marked:
                    get_logger().info("maintenance notice on %s cleared",
                                      self.host)
                self._marked = False
                self._startup_reconciled = True
            except Exception as e:
                # Transient KV error: retry next poll.  Logged (never
                # silently dropped — hvdlint HVD009's swallowed-fault
                # antipattern): a string of these means the host stays
                # excluded, which an operator must be able to see.
                get_logger().debug(
                    "preemption marker clear failed on %s (retry next "
                    "poll): %s", self.host, e)
        elif event is not None:
            self._startup_reconciled = True

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-preempt-sentinel")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.step()
            self._stop.wait(self.poll_interval_s)

    def stop(self) -> None:
        self._stop.set()


class PreemptionAwareDiscovery(HostDiscovery):
    """Filters preempt-marked hosts out of the wrapped discovery's result
    so the ElasticDriver reshapes away from them before they die."""

    def __init__(self, inner: HostDiscovery,
                 marked_hosts_fn: Callable[[], Set[str]]):
        self.inner = inner
        self._marked_fn = marked_hosts_fn

    def marked_hosts(self) -> Set[str]:
        try:
            return set(self._marked_fn())
        except Exception as e:
            get_logger().debug("preemption marker read failed: %s", e)
            return set()

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        found = self.inner.find_available_hosts_and_slots()
        marked = self.marked_hosts()
        dropped = sorted(h for h in found if h in marked)
        if dropped:
            get_logger().info(
                "excluding preempt-marked host(s) %s from the "
                "discoverable world (graceful drain)", dropped)
        return {h: s for h, s in found.items() if h not in marked}
