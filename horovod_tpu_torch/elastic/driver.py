"""Elastic driver: discovery loop, slot assignment, worker lifecycle.

Copy of ``horovod_tpu/elastic/driver.py`` (framework-free; the port keeps
its own copy).  The discovery is wrapped in ``PreemptionAwareDiscovery``
(``elastic/preemption.py``): a preempt-marked host leaves the world
while it is still alive, and its workers get a drain window.

Reference: horovod/runner/elastic/driver.py:69 ElasticDriver — background
discovery thread (1 s period) runs the user script; on host changes it
notifies workers; ``start()`` waits for min slots, assigns ranks
*preserving existing slots* (driver.py:240-272), spawns a worker per new
slot; worker exits are recorded by WorkerStateRegistry which triggers
``resume()`` (host blacklist + rank reassignment + respawn).  The reset
limit counts world reshapes, not individual worker exits, so one multi-slot
host failure is one reset.

TPU build notification channel: instead of per-worker socket RPC services
(elastic/worker.py:46), the driver publishes a monotonically increasing
``discovery/update`` sequence (+ the host set) in the rendezvous KV store;
each worker polls it from a daemon thread (WorkerNotificationManager in
__init__.py) and surfaces HostsUpdatedInterrupt at the next
``state.commit()`` — same contract, one fewer service.  World records carry
a ``version``; workers re-rendezvousing after a reset wait for a version
newer than the world they left (elastic/__init__.py
_refresh_world_from_rendezvous), which closes the stale-record race.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.logging import get_logger
from ..runner import hosts as _hosts
from ..runner import safe_shell_exec
from ..runner.http_server import RendezvousServer
from .. import config as _config
from .discovery import HostDiscovery, HostDiscoveryScript, HostManager
from .registration import WorkerStateRegistry

DISCOVER_INTERVAL_S = 1.0
# How long a scaled-out worker gets to exit on its own before SIGTERM.
DECOMMISSION_GRACE_S = float(os.environ.get(
    "HVD_TPU_DECOMMISSION_GRACE_S", "30"))


class Worker:
    def __init__(self, host: str, slot: int, version: int = 0):
        self.host = host
        self.slot = slot
        self.version = version  # refreshed on every world reactivation
        self.thread: Optional[threading.Thread] = None
        self.terminate_event = threading.Event()
        # Set (under the driver lock) when a launch-scoped worker body
        # confirmed no newer world adopted it and is about to return —
        # adoption must replace, not keep, a retired record.
        self.retired = False
        # Graceful decommission (scale-down): the slot fell out of the new
        # world, so the exit is not a failure and must not blacklist the
        # (still healthy) host.
        self.decommissioned = False
        self.decommission_timer: Optional[threading.Timer] = None


class ElasticDriver:
    """driver.py:69 ElasticDriver analog."""

    def __init__(self, rendezvous: RendezvousServer,
                 discovery: HostDiscovery,
                 min_np: int, max_np: Optional[int] = None,
                 reset_limit: Optional[int] = None,
                 cooldown_range: Optional[Tuple[float, float]] = None,
                 timeout: float = 600.0,
                 verbose: bool = False):
        self.rendezvous = rendezvous
        # Preemption awareness: host sentinels publish maintenance
        # notices into the rendezvous KV scope "preempt"; wrapping the
        # discovery filters those hosts out of the discoverable world so
        # the reshape happens BEFORE the host dies, and
        # _terminate_workers_on_lost_hosts drains their workers instead
        # of terminating them.
        from .preemption import PREEMPT_SCOPE, PreemptionAwareDiscovery

        def _marked_hosts():
            return set(rendezvous.scan_scope(PREEMPT_SCOPE).keys())

        self._preempt_marked = _marked_hosts
        discovery = PreemptionAwareDiscovery(discovery, _marked_hosts)
        self.host_manager = HostManager(discovery, cooldown_range)
        self.host_manager.min_required = min_np  # starvation-escape floor
        self.min_np = min_np
        self.max_np = max_np or min_np
        self.timeout = timeout
        self.registry = WorkerStateRegistry(self, self.host_manager,
                                            reset_limit=reset_limit)
        self._workers: Dict[Tuple[str, int], Worker] = {}
        self._assignments: List[_hosts.SlotInfo] = []
        self._world_version = 0
        self._update_seq = 0  # discovery-update sequence, own counter
        self._shutdown = threading.Event()
        self._error_message: Optional[str] = None
        self._resumes_inflight = 0
        self._resume_pending = False
        self._resume_rerun = False
        self._lock = threading.RLock()
        self._worker_cmd_fn: Optional[Callable] = None
        self._discovery_thread = threading.Thread(
            target=self._discover_loop, daemon=True, name="hvd-elastic-disc")

    # -- lifecycle -----------------------------------------------------------

    def start(self, create_worker_fn: Callable) -> None:
        """Wait for min slots and launch the initial world (driver.py:102).
        World size is min(max_np, available slots)."""
        self._worker_cmd_fn = create_worker_fn
        self.wait_for_available_slots(self.min_np)
        self._activate_world()
        self._discovery_thread.start()

    def wait_for_available_slots(self, min_np: int) -> None:
        deadline = time.time() + self.timeout
        while not self._shutdown.is_set():
            self.host_manager.update_available_hosts()
            if self.host_manager.available_slots >= min_np:
                return
            if time.time() > deadline:
                raise RuntimeError(
                    f"Timed out waiting for {min_np} slots "
                    f"(--start-timeout / HOROVOD_ELASTIC_TIMEOUT); "
                    f"currently available: "
                    f"{self.host_manager.available_slots}")
            time.sleep(DISCOVER_INTERVAL_S)

    def stop(self, error_message: Optional[str] = None) -> None:
        self._error_message = error_message
        self._shutdown.set()
        with self._lock:
            for w in self._workers.values():
                w.terminate_event.set()
        # Deterministic discovery-loop teardown: the loop re-checks
        # _shutdown within one DISCOVER_INTERVAL_S; join it so stop()
        # leaves no poller behind (daemon stays the backstop for a wedged
        # discovery script).  _resume calls stop() from its own thread,
        # never from the discovery thread itself, but guard anyway.
        t = self._discovery_thread
        if t.is_alive() and t is not threading.current_thread():
            t.join(timeout=DISCOVER_INTERVAL_S + 5)

    def join(self) -> None:
        """Wait until the job settles: no live workers and no resume pending
        or in flight (or the driver was stopped).  Worker threads register
        failures *before* deregistering themselves (registration ordering in
        _launch_worker), so there is no idle gap where a pending resume is
        invisible."""
        while not self._shutdown.is_set():
            with self._lock:
                idle = (not self._workers and self._resumes_inflight == 0
                        and not self._resume_pending)
            if idle:
                return
            time.sleep(0.05)

    @property
    def error_message(self) -> Optional[str]:
        return self._error_message

    @property
    def world_version(self) -> int:
        return self._world_version

    @property
    def resume_in_flight(self) -> bool:
        """True while a world reshape is pending or being applied (used by
        the registry to classify worker deaths as reshape casualties)."""
        with self._lock:
            return self._resume_pending or self._resumes_inflight > 0

    def retire_if_settled(self, hostname: str, local_rank: int,
                          world_version: int, terminate_event=None):
        """Launch-scoped worker bodies (the Spark task-pool protocol runs
        ONE launch per world) call this before returning after a clean
        launch.  ATOMICALLY with the adoption decision (_activate_world
        runs under the same lock): if a newer world has adopted this
        (host, local_rank), returns ``(False, new_slot, new_version)`` —
        the caller must serve the new world; otherwise marks the worker
        record retired (adoption will replace it, never keep it) and
        returns ``(True, None, version)`` — safe to exit.  Without this
        handshake a thread checking the version lock-free could decide to
        exit just as adoption kept its still-alive record, leaving the
        slot silently unserved.

        ``terminate_event`` identifies the CALLER's worker record (each
        record owns a unique event): a thread whose record was already
        replaced — or marked for termination — must settle, not serve,
        or it would double-launch a slot its replacement already owns."""
        with self._lock:
            w = self._workers.get((hostname, local_rank))
            mine_record = w is not None and (
                terminate_event is None or
                w.terminate_event is terminate_event)
            if self._world_version != world_version and mine_record and \
                    not w.terminate_event.is_set():
                mine = [s for s in self._assignments
                        if (s.hostname, s.local_rank) ==
                        (hostname, local_rank)]
                if mine:
                    return False, mine[0], self._world_version
            if mine_record:
                w.retired = True
            return True, None, self._world_version

    def current_assignments(self) -> List[_hosts.SlotInfo]:
        with self._lock:
            return list(self._assignments)

    # -- discovery loop ------------------------------------------------------

    def _discover_loop(self):
        while not self._shutdown.is_set():
            try:
                res = self.host_manager.update_available_hosts()
            except Exception as e:  # discovery script hiccup: keep going
                get_logger().warning("discovery failed: %s", e)
                res = 0
            if res == 1:
                # Hosts removed: terminate their workers and reshape the
                # world so survivors re-rendezvous into fresh records.
                self._notify_workers_host_changes(res)
                self._terminate_workers_on_lost_hosts()
                self.request_resume(additive=False, count_reset=True)
            elif res == 2:
                if self.host_manager.available_slots > \
                        len(self._assignments) and \
                        len(self._assignments) < self.max_np:
                    # Pure scale-up: workers will interrupt & re-rendezvous
                    # at next commit; prepare the new world eagerly.
                    self._notify_workers_host_changes(res)
                    self.request_resume(additive=True, count_reset=False)
                # else: an additive discovery result the driver will NOT
                # act on — e.g. a blacklisted host re-appearing after its
                # cooldown while the world is already at capacity.  Do NOT
                # notify: the interrupt would send every worker into a
                # re-rendezvous for a world version that is never coming
                # (this exact wedge deadlocked the crash-recovery e2e
                # whenever the blacklist cooldown re-added the host).
            self._shutdown.wait(DISCOVER_INTERVAL_S)

    def _terminate_workers_on_lost_hosts(self):
        marked = self._preempt_marked()
        with self._lock:
            current = set(self.host_manager.current_hosts.keys())
            for (host, slot), w in self._workers.items():
                if host not in current:
                    if host in marked:
                        # Preempt-marked host: still alive, dying soon.
                        # Its worker gets a drain window: the discovery
                        # notification (published just before this call)
                        # raises HostsUpdatedInterrupt at its next
                        # commit, so state lands before the reshape;
                        # terminate is the grace period's fallback.
                        # decommissioned keeps the exit from counting as
                        # a failure (the marker keeps the host out).
                        if not w.decommissioned:
                            w.decommissioned = True
                            w.decommission_timer = threading.Timer(
                                DECOMMISSION_GRACE_S, w.terminate_event.set)
                            w.decommission_timer.start()
                    else:
                        w.terminate_event.set()

    def _notify_workers_host_changes(self, update_res: int):
        """KV-store sequence bump — worker poll threads pick it up
        (WorkerNotificationClient analog, driver.py:210-238)."""
        with self._lock:
            self._update_seq += 1
            seq = self._update_seq
        self.rendezvous.put(
            "discovery", "update",
            json.dumps({"version": seq,
                        "res": update_res,
                        "hosts": self.host_manager.current_hosts}).encode())

    # -- world (re)activation ------------------------------------------------

    def _activate_world(self):
        """Compute assignments preserving existing slots (driver.py:240-272)
        and publish them; spawn workers for slots that lack one."""
        with self._lock:
            np_ = min(self.max_np, self.host_manager.available_slots)
            new_assignments = self._assign_preserving(np_)
            self._assignments = new_assignments
            self._world_version += 1
            self.registry.reset(len(new_assignments))
            for slot in new_assignments:
                payload = json.dumps(
                    {**slot.to_dict(), "version": self._world_version})
                self.rendezvous.put(
                    "rendezvous", f"slot/{slot.hostname}/{slot.local_rank}",
                    payload.encode())
                self.rendezvous.put("rendezvous", f"rank/{slot.rank}",
                                    payload.encode())
            self.rendezvous.put("rendezvous", "size",
                                str(len(new_assignments)).encode())
            self.rendezvous.put(
                "rendezvous", "world",
                json.dumps({"version": self._world_version,
                            "size": len(new_assignments)}).encode())
            new_keys = {(s.hostname, s.local_rank)
                        for s in new_assignments}
            for key, w in list(self._workers.items()):
                if key not in new_keys and not w.decommissioned:
                    # Slot-granular scale-DOWN: the host survived but lost
                    # slots (e.g. localhost:3 -> localhost:2).  The worker
                    # is NOT killed here: an abrupt death would fail the
                    # survivors' collectives.  Instead it discovers during re-rendezvous that no
                    # slot record carries the new world version and exits
                    # 0 on its own (elastic/__init__.py
                    # _refresh_world_from_rendezvous); SIGTERM is only the
                    # grace-period fallback.  No failure record, no
                    # blacklist (elastic_common.py:305 shrink semantics).
                    w.decommissioned = True
                    w.decommission_timer = threading.Timer(
                        DECOMMISSION_GRACE_S, w.terminate_event.set)
                    w.decommission_timer.start()
            for slot in new_assignments:
                key = (slot.hostname, slot.local_rank)
                w = self._workers.get(key)
                if w is not None and (
                        w.retired or
                        w.thread is None or not w.thread.is_alive() or
                        (w.decommissioned and w.terminate_event.is_set())):
                    # A worker whose thread already finished cannot serve
                    # the new world — launch-scoped worker bodies (the
                    # Spark task-pool protocol runs ONE launch per world)
                    # return when their launch completes, so adopting the
                    # record would leave the slot silently unserved.  Same
                    # for a decommissioned worker past the point of no
                    # return.  Replace with a fresh launch; the old
                    # thread's deregister pops only its own registration,
                    # so the overwrite is safe.
                    w = None
                if w is not None:
                    # Surviving worker adopted into the new world: clear
                    # any in-flight decommission (a shrink-then-grow flap
                    # must not SIGTERM a now-valid worker) and make later
                    # failures fresh events, not stale ones.
                    if w.decommission_timer is not None:
                        w.decommission_timer.cancel()
                        w.decommission_timer = None
                    w.decommissioned = False
                    w.version = self._world_version
                else:
                    self._launch_worker(slot)

    def _assign_preserving(self, np_: int) -> List[_hosts.SlotInfo]:
        """Rank assignment preferring hosts that already run workers so
        surviving processes keep their (host, local_rank) slot
        (driver.py:240-272)."""
        hosts_now = self.host_manager.current_hosts
        existing_hosts = [h for h, _ in self._workers.keys()]
        ordered = sorted(
            hosts_now.keys(),
            key=lambda h: (0 if h in existing_hosts else 1, h))
        host_list = [_hosts.HostInfo(h, hosts_now[h]) for h in ordered]
        return _hosts.get_host_assignments(host_list, min(
            np_, sum(hosts_now.values())))

    def _launch_worker(self, slot: _hosts.SlotInfo):
        worker = Worker(slot.hostname, slot.local_rank, self._world_version)
        self._workers[(slot.hostname, slot.local_rank)] = worker
        spawn_version = self._world_version

        def run():
            ret = self._worker_cmd_fn(slot, worker.terminate_event,
                                      spawn_version)
            key = (slot.hostname, slot.local_rank)

            def deregister():
                with self._lock:
                    # Pop only OUR registration: the slot may have been
                    # re-launched (scale down then up) while this thread
                    # was still reaping the old process.
                    if self._workers.get(key) is worker:
                        self._workers.pop(key, None)

            if self._shutdown.is_set() or worker.decommissioned:
                # Shutdown or graceful scale-down: the nonzero exit of a
                # terminated process is not a training failure.
                deregister()
                return
            # Record BEFORE deregistering so join() never sees an idle gap
            # between worker exit and the resume request.
            if ret == 0:
                self.registry.record_success(slot.hostname, slot.local_rank,
                                             worker.version)
            else:
                self.registry.record_failure(slot.hostname, slot.local_rank,
                                             worker.version)
            deregister()

        worker.thread = threading.Thread(target=run, daemon=True,
                                         name=f"hvd-worker-{slot.rank}")
        worker.thread.start()

    # -- resume --------------------------------------------------------------

    def request_resume(self, additive: bool = False,
                       count_reset: bool = True) -> bool:
        """Schedule one world reshape; concurrent requests coalesce.
        Returns True when a new resume was scheduled (used by the registry
        to count resets per reshape, not per failed worker).

        A request that lands while a resume is already running is NOT
        dropped: it marks the running resume for a re-run.  Every
        notification promises the workers a world-version bump (their
        refresh blocks on one); silently absorbing a second host change
        into an in-flight reshape left them waiting for a version that
        never came (two discovery updates 12 s apart under load wedged the
        scale-down e2e this way)."""
        if self._shutdown.is_set():
            return False
        with self._lock:
            if self._resume_pending:
                self._resume_rerun = True
                return False
            self._resume_pending = True
            self._resumes_inflight += 1
        threading.Thread(target=self._resume, args=(additive,), daemon=True,
                         name="hvd-elastic-resume").start()
        return True

    def _resume(self, additive: bool) -> None:
        """Reshape the world after failure or scale-up (driver.py:304);
        loops while coalesced requests arrived mid-reshape."""
        closed_out = False
        try:
            while True:
                try:
                    self.wait_for_available_slots(self.min_np)
                except RuntimeError as e:
                    self.stop(error_message=str(e))
                    return
                if self._shutdown.is_set():
                    return
                self._activate_world()
                with self._lock:
                    if not self._resume_rerun:
                        # Close out ATOMICALLY with the rerun check: a
                        # request landing after this lock release sees
                        # pending=False and schedules its own resume.
                        # (Clearing rerun in a separate finally dropped a
                        # request that coalesced between the check and
                        # the finally — the silent-swallow this loop
                        # exists to prevent.)
                        self._resume_pending = False
                        self._resumes_inflight -= 1
                        closed_out = True
                        return
                    self._resume_rerun = False
        finally:
            if not closed_out:
                # stop/shutdown/exception paths: the job is ending (or the
                # driver stopped); dropping a pending rerun is correct.
                with self._lock:
                    self._resume_pending = False
                    self._resume_rerun = False
                    self._resumes_inflight -= 1

    # Back-compat spelling used in docs/tests.
    def resume(self, additive: bool = False) -> None:
        self.request_resume(additive=additive)


def _routable_self_addr() -> str:
    """Address remote workers can dial back to (driver_service.py NIC
    probing, simplified: hostname lookup with loopback fallback)."""
    try:
        addr = socket.gethostbyname(socket.gethostname())
        return addr
    except OSError:
        return "127.0.0.1"


def launch_elastic(args) -> int:
    """CLI entry for elastic runs (launch.py:689 _run_elastic analog)."""
    if not args.host_discovery_script:
        print("horovodrun: elastic mode requires --host-discovery-script",
              file=sys.stderr)
        return 2
    min_np = args.min_np or args.np or 1
    max_np = args.max_np or min_np
    discovery = HostDiscoveryScript(args.host_discovery_script,
                                    slots=args.slots)
    rendezvous = RendezvousServer(verbose=args.verbose)
    port = rendezvous.start()
    addr = _routable_self_addr()

    # Per-job coordinator base port when the whole (initial) world is
    # local: avoids collisions with orphaned workers of previous jobs
    # (launch.pick_coordinator_base_port; rank 0 = first local slot).
    # Costs one extra discovery-script invocation at startup — accepted:
    # the script must already be cheap enough for the periodic loop.
    try:
        from ..runner.launch import pick_coordinator_base_port, _is_local
        initial_hosts = discovery.find_available_hosts_and_slots()
        pick_coordinator_base_port(
            bool(initial_hosts) and
            all(_is_local(h) for h in initial_hosts))
    except Exception as e:
        get_logger().debug("coordinator port pick skipped: %s", e)

    from .launch_support import make_elastic_worker_fn
    driver = ElasticDriver(
        rendezvous, discovery, min_np, max_np,
        reset_limit=args.reset_limit,
        cooldown_range=tuple(args.blacklist_cooldown_range)
        if args.blacklist_cooldown_range else None,
        timeout=args.start_timeout or 600)
    worker_fn = make_elastic_worker_fn(args, addr, port, driver)
    try:
        driver.start(worker_fn)
        driver.join()
        if driver.error_message:
            print(f"horovodrun: {driver.error_message}", file=sys.stderr)
            return 1
        states = driver.registry.last_rank_states()
        failed = [k for k, v in states.items() if v == "FAILURE"]
        return 1 if failed else 0
    finally:
        # The port's addition: a caller that launches in process keeps
        # no discovery thread or KV server behind.
        driver.stop(error_message=driver.error_message)
        rendezvous.stop()
