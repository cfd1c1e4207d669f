"""Elastic training on Spark: ``horovod_tpu_torch.spark.run_elastic``.

Copy of ``horovod_tpu/spark/elastic.py`` (framework-free).  Reference:
horovod/spark/runner.py:312 ``run_elastic``.

Spark tasks are resource containers, not ranks.  Each task runs a small
task-pool loop (:func:`task_pool_loop`) that registers itself, with
heartbeats, in the launcher's KV store and serves launch commands; the
port's ``ElasticDriver`` (``elastic/driver.py``) treats the registered
tasks as the discoverable world (:class:`SparkTaskPoolDiscovery` reads
the same registry) and launches each assigned slot as a subprocess
inside the owning task, so a worker's ``os._exit`` kills the
incarnation, not the task, which reports the failure and stays
available for the reshaped world.

The function ships through the KV store, cloudpickled (closures by
value); no shared filesystem is assumed.  Worker results land in the KV
keyed (world_version, rank); the caller gets the final world's results
ordered by rank.  Everything Spark-specific is ``_spark_task_pool``; the
task protocol is plain Python, so the elastic behaviour is testable
without pyspark (``_task_pool_factory``).
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .. import config as _config
from ..elastic.discovery import HostDiscovery
from ..elastic.driver import ElasticDriver
from ..elastic import coordinator_port_for
from ..runner import hosts as _hosts
from ..runner.http_server import KVStoreClient, RendezvousServer
from ..utils import get_logger

_SCOPE_TASKS = "se_tasks"      # task/{id} -> {host, ts}
_SCOPE_CTL = "se_ctl"          # shutdown marker
_SCOPE_FN = "se_fn"            # blob -> cloudpickled (fn, args, kwargs)
_SCOPE_LAUNCH = "se_launch"    # cmd/{task}/{seq} -> {env}
_SCOPE_DONE = "se_done"        # done/{task}/{seq} -> {code}
_SCOPE_RESULTS = "se_results"  # {world_version}/{rank} -> pickle(result)

_HEARTBEAT_S = 2.0
_ALIVE_WINDOW_S = 10.0
# How long the caller waits after driver.join() for the final world's
# result records to land (see run_elastic's ResultsRecorder note).
_RESULT_WAIT_S = 30.0

_BOOTSTRAP = r"""
import os, pickle, sys, urllib.request
base = "http://%s:%s" % (os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"],
                         os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"])
blob = urllib.request.urlopen(base + "/se_fn/blob", timeout=60).read()
fn, a, kw = pickle.loads(blob)
value = fn(*a, **(kw or {}))
# Report under the FINAL world seen by this incarnation: a survivor's
# rank/world changes across in-place resets (hvd.elastic refreshes env).
ver = os.environ.get("HVD_TPU_WORLD_VERSION", "0")
rank = os.environ.get("HOROVOD_RANK", "0")
req = urllib.request.Request("%s/se_results/%s/%s" % (base, ver, rank),
                             data=pickle.dumps(value), method="PUT")
urllib.request.urlopen(req, timeout=60).read()
"""


class SparkTaskPoolDiscovery(HostDiscovery):
    """Discovers hosts from the live task registry (the analog of
    SparkDriverHostDiscovery over SparkDriverService registrations,
    horovod/runner/elastic/discovery.py + spark/driver/host_discovery.py).
    A task is alive while its heartbeat is fresher than the window; an
    executor loss silently removes its tasks, shrinking the host's slot
    count, which the ElasticDriver's discovery loop turns into a reshape."""

    def __init__(self, kv_get_scope: Callable[[], Dict[str, bytes]],
                 alive_window_s: float = _ALIVE_WINDOW_S):
        self._scan = kv_get_scope
        self._window = alive_window_s

    def alive_tasks(self) -> Dict[int, str]:
        """task_id -> hostname for fresh heartbeats."""
        now = time.time()
        out = {}
        for key, raw in self._scan().items():
            if not key.startswith("task/"):
                continue
            rec = json.loads(raw)
            if now - rec["ts"] <= self._window:
                out[int(key[len("task/"):])] = rec["host"]
        return out

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        slots: Dict[str, int] = {}
        for _tid, host in self.alive_tasks().items():
            slots[host] = slots.get(host, 0) + 1
        return slots

    def task_for_slot(self, hostname: str, local_rank: int) -> Optional[int]:
        """The local_rank-th (by task id) alive task on ``hostname``."""
        ids = sorted(t for t, h in self.alive_tasks().items()
                     if h == hostname)
        return ids[local_rank] if local_rank < len(ids) else None


def task_pool_loop(addr: str, port: int, task_index: int,
                   hostname: Optional[str] = None,
                   python: Optional[List[str]] = None) -> None:
    """Runs inside one Spark task (or a test thread): heartbeat + serve
    launch commands as subprocesses until the driver signals shutdown."""
    client = KVStoreClient(addr, port)
    host = hostname or socket.gethostname()
    stop = threading.Event()

    def heartbeat():
        while not stop.is_set():
            try:
                client.put(_SCOPE_TASKS, f"task/{task_index}",
                           json.dumps({"host": host,
                                       "ts": time.time()}).encode())
            except Exception as e:
                # A missed heartbeat is recoverable (the driver allows
                # gaps) but never silent (HVD009): a run of them is this
                # task being evicted for a transport problem.
                get_logger().debug(
                    "task %d heartbeat put failed: %s", task_index, e)
            stop.wait(_HEARTBEAT_S)

    hb = threading.Thread(target=heartbeat, daemon=True,
                          name=f"se-heartbeat-{task_index}")
    hb.start()
    seq = 0

    def reconcile(seq: int) -> int:
        """A Spark-rescheduled incarnation restarts at seq=0 while the
        driver's counter kept going (completed launches' cmd records are
        deleted on consumption) — without this it would long-poll a seq
        that will never be written again.  The driver publishes
        ``next/{task}`` AFTER each cmd put, so: read next first, then scan
        for pending cmds.  A pending cmd >= seq is served; otherwise, if
        next says the counter is ahead AND no cmd for the gap survives
        (i.e. those launches were consumed), jump the counter forward."""
        try:
            nxt_raw = client.get(_SCOPE_LAUNCH, f"next/{task_index}")
            pending = sorted(
                int(k.rsplit("/", 1)[1])
                for k in client.scan(_SCOPE_LAUNCH)
                if k.startswith(f"cmd/{task_index}/"))
        except Exception:
            return seq
        ahead = [s for s in pending if s >= seq]
        if ahead:
            return ahead[0]
        if nxt_raw is not None:
            nxt = int(nxt_raw)
            if nxt > seq:
                return nxt
        return seq

    # After the first served cmd, seq provably tracks the driver's counter
    # (the loop increments it after every done), so steady-state reconcile
    # is a no-op; back off exponentially rather than scanning the scope on
    # every 1 s poll timeout — the rendezvous server's long-poll design
    # exists precisely to avoid that per-second load at scale.
    backoff, next_reconcile = 1.0, 0.0
    try:
        while True:
            if client.get(_SCOPE_CTL, "shutdown") is not None:
                return
            raw = client.get(_SCOPE_LAUNCH, f"cmd/{task_index}/{seq}",
                             wait=1.0)
            if raw is None:
                now = time.monotonic()
                if now >= next_reconcile:
                    new_seq = reconcile(seq)
                    backoff = 1.0 if new_seq != seq else min(backoff * 2,
                                                             30.0)
                    seq = new_seq
                    next_reconcile = now + backoff
                continue
            backoff, next_reconcile = 1.0, 0.0
            cmd = json.loads(raw)
            env = dict(os.environ)
            env.update(cmd["env"])
            proc = subprocess.Popen(
                (python or [sys.executable]) + ["-c", _BOOTSTRAP],
                env=env)
            while True:
                try:
                    code = proc.wait(timeout=0.5)
                    break
                except subprocess.TimeoutExpired:
                    if client.get(_SCOPE_CTL, "shutdown") is not None:
                        proc.kill()
                        proc.wait()
                        return
                    if client.get(_SCOPE_LAUNCH,
                                  f"abort/{task_index}/{seq}") is not None:
                        proc.terminate()
                        try:
                            code = proc.wait(timeout=5)
                        except subprocess.TimeoutExpired:
                            proc.kill()
                            code = proc.wait()
                        break
            client.put(_SCOPE_DONE, f"done/{task_index}/{seq}",
                       json.dumps({"code": code}).encode())
            if client.get(_SCOPE_LAUNCH, f"cmd/{task_index}/{seq}") is None:
                # The driver abandoned this launch (its abort wait timed
                # out and cleanup deleted cmd before our done landed):
                # nobody will ever consume the marker — drop it so aborts
                # can't leak KV keys for the run's lifetime.
                try:
                    client.delete(_SCOPE_DONE, f"done/{task_index}/{seq}")
                except Exception as e:
                    get_logger().debug(
                        "orphaned done-marker delete failed: %s", e)
            seq += 1
    finally:
        stop.set()
        hb.join(timeout=2 * _HEARTBEAT_S)


def _settle(driver: ElasticDriver, client: KVStoreClient,
            slot: _hosts.SlotInfo, world_version: int,
            terminate_event: threading.Event):
    """After a clean launch for ``world_version``: ``(True, None, v)`` when
    the slot's thread may exit, else ``(False, new_slot, v)``, the newer
    world ``v`` it must serve with a fresh launch.

    ``driver.retire_if_settled`` decides atomically with the driver's
    adoption (same lock): either the thread serves the newer world, or
    its record is marked retired so a reshape racing the exit replaces it
    with a fresh launch instead of keeping an exiting thread.  An
    incarnation may have adopted the newer world itself (at its init
    barrier or in an elastic reset) and served it to the end: the
    bootstrap publishes the result before the process exits, so before
    the done marker, and a fresh launch would be a second rank with this
    slot, alone in a world whose peers have finished.  Such a slot is
    settled for that world through the same handshake, which returns a
    world newer still if one adopted the record meanwhile."""
    while True:
        settled, new_slot, cur = driver.retire_if_settled(
            slot.hostname, slot.local_rank, world_version,
            terminate_event=terminate_event)
        if settled or client.get(_SCOPE_RESULTS,
                                 f"{cur}/{new_slot.rank}") is None:
            return settled, new_slot, cur
        slot, world_version = new_slot, cur


def _spark_task_pool(num_tasks: int, addr: str, port: int):
    """Launch ``num_tasks`` Spark tasks each running task_pool_loop; returns
    a join() callable.  Plain (non-barrier) scheduling: elastic semantics
    explicitly tolerate a partially-scheduled pool — whatever registers
    becomes the discoverable world (spark/runner.py:312 behavior)."""
    import pyspark
    sc = pyspark.SparkContext._active_spark_context
    if sc is None:
        raise RuntimeError("no active SparkContext; create a SparkSession "
                           "before run_elastic")

    def task_fn(it):
        for i in it:
            task_pool_loop(addr, port, i)
            yield i

    holder = {}

    def job():
        try:
            sc.parallelize(range(num_tasks), num_tasks) \
                .mapPartitions(task_fn).collect()
        except Exception as e:  # surfaced after driver.join
            holder["error"] = e

    th = threading.Thread(target=job, daemon=True, name="se-spark-job")
    th.start()

    def join(timeout=60.0):
        th.join(timeout)
        if "error" in holder:
            raise holder["error"]

    return join


def run_elastic(fn: Callable,
                args: tuple = (),
                kwargs: Optional[dict] = None,
                num_proc: Optional[int] = None,
                min_num_proc: Optional[int] = None,
                max_num_proc: Optional[int] = None,
                start_timeout: Optional[float] = None,
                elastic_timeout: Optional[float] = None,
                reset_limit: Optional[int] = None,
                cooldown_range: Optional[tuple] = (5.0, 60.0),
                env: Optional[Dict[str, str]] = None,
                verbose: int = 1,
                _task_pool_factory: Optional[Callable] = None) -> List[Any]:
    """Run ``fn`` elastically over Spark tasks; returns the FINAL world's
    per-rank results ordered by rank (horovod/spark/runner.py:312).

    ``fn`` should wrap its training loop in ``hvd.elastic.run`` to survive
    reshapes.  ``cooldown_range`` bounds the failed-host blacklist
    cooldown (reference --blacklist-cooldown-range); unlike the ssh
    launcher it DEFAULTS ON here, because Spark re-registers tasks from
    the same executor hosts — a permanent blacklist would starve the
    reshape whenever the pool has few hosts.  Pass ``None`` for the
    reference's permanent-blacklist behavior.
    ``_task_pool_factory(num_tasks, addr, port) -> join_fn`` is injectable
    for tests (threads instead of Spark tasks)."""
    import cloudpickle

    kwargs = kwargs or {}
    start_timeout = start_timeout or float(
        os.environ.get("HOROVOD_SPARK_START_TIMEOUT", "600"))
    elastic_timeout = elastic_timeout or float(
        os.environ.get("HOROVOD_ELASTIC_TIMEOUT", "600"))
    if num_proc is None:
        if _task_pool_factory is None:
            import pyspark
            sc = pyspark.SparkContext._active_spark_context
            if sc is None:
                raise RuntimeError("no active SparkContext")
            num_proc = sc.defaultParallelism
        else:
            raise ValueError("num_proc is required with a custom task pool")
    min_np = min_num_proc or num_proc
    max_np = max_num_proc or num_proc

    rendezvous = RendezvousServer()
    port = rendezvous.start()
    addr = "127.0.0.1" if _task_pool_factory else \
        socket.gethostbyname(socket.gethostname())
    client = KVStoreClient(addr, port)
    client.put(_SCOPE_FN, "blob",
               cloudpickle.dumps((fn, args, kwargs)))

    def scan_tasks():
        return client.scan(_SCOPE_TASKS)

    discovery = SparkTaskPoolDiscovery(scan_tasks)
    driver = ElasticDriver(rendezvous, discovery, min_np, max_np,
                           reset_limit=reset_limit,
                           cooldown_range=cooldown_range,
                           timeout=elastic_timeout)
    pool_join = (_task_pool_factory or _spark_task_pool)(
        max_np, addr, port)

    launch_seq: Dict[int, int] = {}     # task_id -> next launch seq
    seq_lock = threading.Lock()
    task_locks: Dict[int, threading.Lock] = {}  # per-task launch ordering
    extra_env = dict(env or {})
    gc_state = {"version": -1}

    def _gc_stale_results(world_version: int) -> None:
        """Results of superseded worlds are never read (only the FINAL
        world's are returned); drop them on each reshape so a long
        elastic run doesn't grow the launcher's KV store without bound."""
        with seq_lock:
            if world_version <= gc_state["version"]:
                return
            gc_state["version"] = world_version
        try:
            for k in client.scan(_SCOPE_RESULTS):
                if int(k.split("/")[0]) < world_version:
                    client.delete(_SCOPE_RESULTS, k)
        except Exception as e:
            get_logger().debug(
                "stale-results GC failed (retried next reshape): %s", e)

    def worker_fn(slot: _hosts.SlotInfo, terminate_event: threading.Event,
                  world_version: int) -> int:
        # Never raise: the ElasticDriver's worker thread has no except
        # path, and an escaped KV transport error would leave the Worker
        # registered forever — driver.join() would hang instead of the
        # failure being recorded and reshaped around.
        try:
            while True:
                code = _worker_fn_inner(slot, terminate_event,
                                        world_version)
                if code != 0 or terminate_event.is_set():
                    return code
                # The launch completed cleanly, but this Worker thread may
                # have been ADOPTED into a newer world meanwhile (the
                # driver keeps live workers across reshapes).  Launches
                # are WORLD-scoped in the task-pool protocol — serve the
                # current world with a fresh launch when this slot is
                # still assigned (see _settle).
                settled, new_slot, cur = _settle(
                    driver, client, slot, world_version, terminate_event)
                if settled:
                    return 0
                slot, world_version = new_slot, cur
        except Exception:
            get_logger().warning(
                "spark elastic: worker slot %s:%d failed in the launch "
                "protocol", slot.hostname, slot.local_rank, exc_info=True)
            return 1

    def _worker_fn_inner(slot, terminate_event, world_version) -> int:
        from ..elastic.launch_support import slot_env
        _gc_stale_results(world_version)
        task_id = discovery.task_for_slot(slot.hostname, slot.local_rank)
        if task_id is None:
            return 1  # task vanished between discovery and launch
        wenv = {
            **slot_env(slot, world_version, addr, port, driver,
                       coord_base=port + 1),
            **extra_env,
        }
        with seq_lock:
            tlock = task_locks.setdefault(task_id, threading.Lock())
        seq = None
        try:
            # Alloc + both puts under a PER-TASK lock: cmd must precede
            # next and next must be monotonic *per task* (a rescheduled
            # incarnation's reconcile() reads next first, then scans
            # pending cmds — seeing next==seq+1 with no cmd/{seq} pending
            # proves launch seq was already consumed and skipping it is
            # safe).  Cross-task launches stay parallel; a hung KV request
            # stalls only this task's launch, not the whole reshape.  The
            # puts sit inside the try so a put failure after cmd landed
            # still reaches the finally's cleanup — otherwise the task
            # loop would serve a launch no worker thread tracks.
            with tlock:
                with seq_lock:
                    seq = launch_seq.get(task_id, 0)
                    launch_seq[task_id] = seq + 1
                client.put(_SCOPE_LAUNCH, f"cmd/{task_id}/{seq}",
                           json.dumps({"env": wenv}).encode())
                client.put(_SCOPE_LAUNCH, f"next/{task_id}",
                           str(seq + 1).encode())
            while True:
                raw = client.get(_SCOPE_DONE, f"done/{task_id}/{seq}",
                                 wait=1.0)
                if raw is not None:
                    return int(json.loads(raw)["code"])
                if terminate_event.is_set():
                    client.put(_SCOPE_LAUNCH, f"abort/{task_id}/{seq}",
                               b"1")
                    raw = client.get(_SCOPE_DONE, f"done/{task_id}/{seq}",
                                     wait=10.0)
                    return int(json.loads(raw)["code"]) if raw else 143
                if discovery.task_for_slot(slot.hostname,
                                           slot.local_rank) != task_id:
                    get_logger().warning(
                        "spark elastic: task %d (slot %s:%d) lost mid-run",
                        task_id, slot.hostname, slot.local_rank)
                    return 1
        finally:
            # Consume the records: a Spark-rescheduled incarnation of this
            # task must not replay completed/aborted launches (its
            # reconcile() skips forward using the next/{task} pointer once
            # the cmd is gone — see task_pool_loop).  done/ is consumed
            # too so a long-elastic run's KV store stays bounded; a done
            # marker that lands AFTER this cleanup (slow-dying abortee) is
            # dropped by the task loop's own cmd-gone check.
            if seq is not None:
                for scope, k in ((_SCOPE_LAUNCH, f"cmd/{task_id}/{seq}"),
                                 (_SCOPE_LAUNCH, f"abort/{task_id}/{seq}"),
                                 (_SCOPE_DONE, f"done/{task_id}/{seq}")):
                    try:
                        client.delete(scope, k)
                    except Exception as e:
                        get_logger().debug(
                            "launch-marker cleanup delete failed: %s", e)

    t0 = time.time()
    while not discovery.find_available_hosts_and_slots():
        if time.time() - t0 > start_timeout:
            rendezvous.stop()
            raise TimeoutError(
                f"no Spark task registered within {start_timeout}s "
                "(HOROVOD_SPARK_START_TIMEOUT); check cluster resources")
        time.sleep(0.2)

    try:
        driver.start(worker_fn)
        driver.join()
        if driver.error_message:
            raise RuntimeError(driver.error_message)
        final = driver.world_version
        expected = {s.rank for s in driver.current_assignments()}
        # ResultsRecorder semantics (runner/elastic/driver.py:113
        # get_results): conclude only after every final-world rank's
        # result is RECORDED, not merely after every worker exited.  A
        # rejoined incarnation's result PUT travels a different socket
        # than its done marker, so under host load the publication can
        # trail the driver's finished-check by a scheduling quantum —
        # poll briefly instead of failing on the first scan (the r4
        # in-suite flake).  The wait is bounded: a rank that truly never
        # published (crashed mid-PUT) still surfaces the forensic error.
        deadline = time.monotonic() + _RESULT_WAIT_S
        while True:
            raw_results = client.scan(_SCOPE_RESULTS)
            results = {int(k.split("/")[1]): pickle.loads(v)
                       for k, v in raw_results.items()
                       if k.startswith(f"{final}/")}
            missing = sorted(expected - set(results))
            if not missing:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"spark elastic finished but ranks {missing} reported "
                    f"no result for final world {final} within "
                    f"{_RESULT_WAIT_S:.0f}s "
                    f"(result keys present: {sorted(raw_results)})")
            time.sleep(0.1)
        return [results[r] for r in sorted(expected)]
    finally:
        client.put(_SCOPE_CTL, "shutdown", b"1")
        try:
            pool_join()
        except Exception:
            get_logger().warning("spark elastic task pool join failed",
                                 exc_info=True)
        driver.stop()
        rendezvous.stop()
