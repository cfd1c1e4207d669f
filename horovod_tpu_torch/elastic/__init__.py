"""Elastic training: fault tolerance and autoscaling.

Port of ``horovod_tpu/elastic/__init__.py``: ``run`` (``:519``) with its
retry and escalation bounds, ``_reset`` (``:442``),
``_refresh_world_from_rendezvous`` (``:184``),
``_await_world_at_init_barrier`` (``:297``), ``coordinator_port_for``
(``:399``), ``WorkerNotificationManager`` (``:48``) and ``_mark_elastic``
(``:423``, into the port's timeline).  The state objects are in
``state.py`` (``TorchState``), the sampler in ``sampler.py``, the driver
side (``ElasticDriver``, discovery, registration, worker launch) in
``driver.py``, ``discovery.py``, ``registration.py`` and
``launch_support.py``, copies of the JAX package's.

A reset is ``core.shutdown()``, the new slot environment, then
``core.init()`` on the generation's store port: every generation
``w.c`` (world version ``w``, in-place reset ``c``) serves a fresh
``TCPStore`` at ``coordinator_port_for(base, w, c)``, so no rank reads a
record of an older generation, and a late rank of the old generation
finds nothing listening there.  JAX's ``jax.distributed`` and
``clear_backends`` steps have no counterpart.  Process sets are
registered again by the user's reset callbacks, as in JAX.

A dead peer must not hang the survivors:

* a gloo collective with a dead peer raises at once ("Connection closed
  by peer"), and the eager engine raises ``HorovodInternalError``;
* the world's store dies with rank 0, so a rank waiting on it raises;
* rank 0 waiting in negotiation for a dead peer's request: the
  negotiator's waits watch the rendezvous world version
  (:class:`WorldWatch`), which the driver bumps within a second of the
  death, and raise ``HorovodInternalError`` once a wait has outlasted one
  poll in a world that has moved on;
* a collective whose live peers left it for a reset (a gloo ring that
  waits on a neighbour which has already raised): the neighbour's
  ``shutdown`` frees its old group, which closes its connections, and
  the waiting rank raises.  ``core`` imports ``torch.distributed.nn``
  before any group exists: that module binds the live world group into
  its functions' default arguments at import, which would keep the group
  alive for the life of the process.  The process group's timeout,
  :data:`COLLECTIVE_TIMEOUT_S` (30 s) in an elastic world, bounds the
  wait all the same;
* an NCCL collective with a dead peer hangs on the card: a watcher
  (:class:`_WedgeWatch`) exits the process when the world has moved on
  and this rank has not left its world within
  :data:`WEDGE_EXIT_S` (15 s).  The driver respawns it and it
  resumes from its spill, which is JAX's own design for survivors.

``HVD_TPU_ELASTIC_EVENT_LOG`` (a path) appends one JSON line per
collective failure caught by ``run`` and per wedge exit, with the wall
clock, so a drive can time how long each survivor took to leave.
"""

from __future__ import annotations

import errno
import functools
import json
import os
import socket
import threading
import time
from typing import List, Optional

from ..exceptions import (HorovodInternalError, HostsUpdatedInterrupt,
                          RendezvousUnreachableError)
from ..utils.logging import get_logger
from .. import config as _config
from .state import State, ObjectState, TorchState  # noqa: F401
from .sampler import ElasticSampler  # noqa: F401
from .driver import ElasticDriver  # noqa: F401
from .discovery import (  # noqa: F401
    HostDiscovery, HostDiscoveryScript, FixedHostDiscovery, HostManager)

# The process group's timeout in an elastic world: how long a collective
# waits for a peer that left it for a reset before it raises.
COLLECTIVE_TIMEOUT_S = 30.0
# How long an NCCL rank stays in its world after the world moved on
# before _WedgeWatch exits it.
WEDGE_EXIT_S = 15.0


def _elastic() -> bool:
    return os.environ.get("HOROVOD_ELASTIC") == "1"


def log_event(event: str, **fields) -> None:
    """One JSON line to ``HVD_TPU_ELASTIC_EVENT_LOG``, if set: the event,
    the wall clock, this rank and its world version, and ``fields``."""
    path = os.environ.get("HVD_TPU_ELASTIC_EVENT_LOG")
    if not path:
        return
    rec = dict(event=event, wall=time.time(),
               rank=int(os.environ.get(_config.HOROVOD_RANK, "0")),
               world_version=int(os.environ.get("HVD_TPU_WORLD_VERSION",
                                                "0") or 0), **fields)
    try:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass


def read_events(path: str) -> List[dict]:
    """The records :func:`log_event` appended to ``path``."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class WorkerNotificationManager:
    """Worker-side host-update listener.

    Reference: horovod/runner/elastic/worker.py:46 WorkerNotificationService
    (socket RPC per worker).  Here: a daemon thread polls the rendezvous KV
    key ``discovery/update``; on version bump every registered State gets
    ``on_hosts_updated`` so its next ``commit()`` raises
    HostsUpdatedInterrupt.  It also starts this host's preemption
    sentinel (``elastic/preemption.py``)."""

    def __init__(self):
        self._listeners: List[State] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._seen_version = 0
        self._lock = threading.Lock()
        self._sentinel = None

    def init(self):
        if self._thread is not None:
            return
        addr = os.environ.get(_config.HOROVOD_RENDEZVOUS_ADDR)
        port = os.environ.get(_config.HOROVOD_RENDEZVOUS_PORT)
        if not addr or not port or not _elastic():
            return  # not an elastic run: no-op manager
        from ..runner.http_server import KVStoreClient
        client = KVStoreClient(addr, int(port))
        # Baseline the discovery sequence: updates that predate this worker
        # are already reflected in the world it was spawned into — replaying
        # them would raise a spurious HostsUpdatedInterrupt and strand the
        # worker waiting for a world version that never comes.  The driver
        # stamps the spawn-time sequence into the env
        # (HVD_TPU_DISCOVERY_SEQ), closing the spawn→init race; the KV read
        # is the fallback for workers launched by other paths.
        spawn_seq = os.environ.get("HVD_TPU_DISCOVERY_SEQ")
        if spawn_seq is not None:
            self._seen_version = int(spawn_seq)
        else:
            for attempt in range(3):
                try:
                    raw = client.get("discovery", "update")
                    if raw:
                        self._seen_version = json.loads(raw).get("version", 0)
                    break
                except Exception as e:
                    get_logger().warning(
                        "discovery baseline read failed (attempt %d): %s",
                        attempt + 1, e)
                    time.sleep(0.2)

        def poll():
            while not self._stop.is_set():
                try:
                    raw = client.get("discovery", "update")
                    if raw:
                        rec = json.loads(raw)
                        if rec["version"] > self._seen_version:
                            self._seen_version = rec["version"]
                            with self._lock:
                                for st in self._listeners:
                                    st.on_hosts_updated(rec.get("hosts"),
                                                        rec.get("res", 1))
                except Exception as e:
                    get_logger().debug("notification poll failed: %s", e)
                self._stop.wait(1.0)

        self._thread = threading.Thread(target=poll, daemon=True,
                                        name="hvd-worker-notify")
        self._thread.start()
        # Preemption sentinel: polls this host's maintenance-event
        # endpoint and publishes the drain marker the driver's
        # PreemptionAwareDiscovery consumes (one 2 s-timeout HTTP poll
        # every 5 s).  Unlike the JAX package, the poll is opt-in: it
        # starts when HVD_TPU_MAINTENANCE_URL names the endpoint or
        # HVD_TPU_PREEMPTION_SENTINEL=1 asks for GCP's metadata server, so
        # a worker never reaches for a metadata host that was not named.
        # HVD_TPU_PREEMPTION_SENTINEL=0 disables it either way.
        flag = os.environ.get("HVD_TPU_PREEMPTION_SENTINEL")
        if flag == "1" or (flag != "0"
                           and os.environ.get("HVD_TPU_MAINTENANCE_URL")):
            from .preemption import PreemptionSentinel
            self._sentinel = PreemptionSentinel(client)
            self._sentinel.start()

    def register_listener(self, state: State):
        with self._lock:
            if state._host_messages is None:
                state._host_messages = []
            self._listeners.append(state)

    def remove_listener(self, state: State):
        with self._lock:
            if state in self._listeners:
                self._listeners.remove(state)


notification_manager = WorkerNotificationManager()


class _RendezvousLiveness:
    """Latches sustained transport-dead signals from the launcher's KV
    store and raises ``RendezvousUnreachableError`` after
    ``HVD_TPU_RENDEZVOUS_DEAD_S`` (default 30 s) without one successful
    request.  Dead signals are refused/reset connections, connect/read
    timeouts, and host/network-unreachable errnos.  HTTP-status
    ``OSError``s raised by the client for >=400 responses do NOT: the
    server answered, so it is alive.  Polling loops call ``ok()`` after
    any successful request and ``note(e)`` in their retry handler."""

    _DEAD_ERRNOS = {errno.EHOSTUNREACH, errno.ENETUNREACH,
                    errno.ECONNABORTED}

    def __init__(self, addr, port):
        self.addr, self.port = addr, port
        self.window = float(
            os.environ.get("HVD_TPU_RENDEZVOUS_DEAD_S", "30"))
        self._since = None

    def ok(self) -> None:
        self._since = None

    def note(self, e: BaseException) -> bool:
        """Record an error; True if it was a transport-dead signal.
        Raises RendezvousUnreachableError once signals have been sustained
        for the window."""
        dead = isinstance(e, (ConnectionRefusedError, ConnectionResetError,
                              BrokenPipeError, TimeoutError)) or \
            (isinstance(e, OSError) and e.errno in self._DEAD_ERRNOS)
        if not dead:
            return False
        now = time.monotonic()  # fatal verdict: immune to clock steps
        self._since = self._since or now
        if now - self._since > self.window:
            raise RendezvousUnreachableError(
                f"rendezvous {self.addr}:{self.port} unreachable for "
                f"{self.window:.0f}s — launcher presumed dead") from e
        return True


def _rendezvous_client():
    addr = os.environ.get(_config.HOROVOD_RENDEZVOUS_ADDR)
    port = os.environ.get(_config.HOROVOD_RENDEZVOUS_PORT)
    if not addr or not port:
        return None
    from ..runner.http_server import KVStoreClient
    return KVStoreClient(addr, int(port))


class WorldWatch:
    """Whether the driver has published a world newer than this rank's
    (``HVD_TPU_WORLD_VERSION``): the sign that a peer died or the world
    was reshaped.  ``moved()`` reads the rendezvous at most once per
    ``period`` seconds and never raises (an unreachable rendezvous reads
    as "not moved")."""

    def __init__(self, period: float = 1.0):
        self.version = int(os.environ.get("HVD_TPU_WORLD_VERSION", "0")
                           or 0)
        self.period = period
        self._client = _rendezvous_client()
        self._last = 0.0
        self._moved = False
        self._lock = threading.Lock()

    def moved(self) -> bool:
        if self._moved or self._client is None:
            return self._moved
        # The period is claimed under the lock, the GET runs outside it
        # (a slow rendezvous must not stall every thread that asks), and
        # the verdict is set under it again.
        with self._lock:
            now = time.monotonic()
            if now - self._last < self.period:
                return self._moved
            self._last = now
        try:
            raw = self._client.get("rendezvous", "world")
            world = json.loads(raw) if raw else {}
            moved = int(world.get("version", 0)) > self.version
        except Exception as e:
            get_logger().debug("world watch read failed: %s", e)
            return self._moved
        if moved:
            with self._lock:
                self._moved = True
        return self._moved

    def check(self) -> Optional[str]:
        """The negotiator's liveness hook: a reason to give up, or None."""
        if self.moved():
            return (f"the elastic world moved past version {self.version} "
                    f"(a peer died or the world was reshaped)")
        return None


class _WedgeWatch:
    """Exit the process when the world has moved on and this rank has not
    left its own world (``core`` generation unchanged) within
    ``WEDGE_EXIT_S`` seconds: an NCCL collective with a dead peer hangs
    on the card and no host-side check can reach it.  Started by
    ``core.init`` in an elastic NCCL world of more than one rank."""

    def __init__(self, core_generation):
        self._gen = core_generation
        self._start_gen = core_generation()
        self._watch = WorldWatch()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-elastic-wedge")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        moved_at = None
        while not self._stop.wait(1.0):
            if self._gen() != self._start_gen:
                return
            if moved_at is None:
                if self._watch.moved():
                    moved_at = time.monotonic()
                continue
            waited = time.monotonic() - moved_at
            if waited >= WEDGE_EXIT_S:
                get_logger().warning(
                    "elastic: the world moved past version %d %.1f s ago "
                    "and this rank is still in it (a collective with a "
                    "dead peer); exiting so the driver respawns it from "
                    "its spill", self._watch.version, waited)
                log_event("wedge_exit", waited_s=waited)
                os._exit(1)


def _refresh_world_from_rendezvous(allow_same_world: bool = False) -> str:
    """After a reset, fetch this worker's new slot record keyed by
    (hostname, local_rank) from the rendezvous KV store and refresh the
    HOROVOD_* env (the gloo elastic re-rendezvous pattern,
    runner/http/http_server.py elastic handler).  Returns "refreshed"
    when a NEW world's slot was adopted, "same_world" on the
    allow_same_world fallback below.

    Version gate: the KV store still holds the previous world's records
    while the driver reshapes; we wait for a world version strictly newer
    than the one we left (HVD_TPU_WORLD_VERSION) and a slot record stamped
    with that version.

    ``allow_same_world``: the retry loop escalates repeated in-place reset
    failures to a world refresh on the ASSUMPTION the world changed under
    us — but when it did not (transient churn: a peer wedged in a timing-
    out collective), waiting for a strictly newer version deadlocks until
    the elastic timeout while live peers train on.  With this flag, if no
    newer world appears within a bounded window and the CURRENT world
    still lists this worker's slot, return "same_world" so the caller
    falls back to an in-place (generation-bump) reset instead."""
    addr = os.environ.get(_config.HOROVOD_RENDEZVOUS_ADDR)
    port = os.environ.get(_config.HOROVOD_RENDEZVOUS_PORT)
    if not addr or not port:
        return "refreshed"
    from ..runner.http_server import KVStoreClient
    client = KVStoreClient(addr, int(port))
    hostname = os.environ.get(_config.HOROVOD_HOSTNAME, socket.gethostname())
    local_rank = os.environ.get(_config.HOROVOD_LOCAL_RANK, "0")
    last_version = int(os.environ.get("HVD_TPU_WORLD_VERSION", "0"))
    deadline = time.time() + float(
        os.environ.get(_config.HOROVOD_ELASTIC_TIMEOUT, "600"))
    same_world_after = time.time() + float(
        os.environ.get("HVD_TPU_SAME_WORLD_FALLBACK_S", "20"))
    scaled_out_since = None
    liveness = _RendezvousLiveness(addr, port)
    while time.time() < deadline:
        try:
            world_raw = client.get("rendezvous", "world")
            liveness.ok()
            world = json.loads(world_raw) if world_raw else {"version": 0}
            if allow_same_world and time.time() > same_world_after and \
                    world.get("version", 0) == last_version:
                raw = client.get("rendezvous",
                                 f"slot/{hostname}/{local_rank}")
                rec = json.loads(raw) if raw else {}
                if rec.get("version", -1) == last_version:
                    get_logger().info(
                        "elastic: world unchanged (v%d) and slot still "
                        "valid — falling back to in-place reset",
                        last_version)
                    return "same_world"
            if world.get("version", 0) > last_version:
                raw = client.get("rendezvous",
                                 f"slot/{hostname}/{local_rank}")
                rec = json.loads(raw) if raw else {}
                if rec.get("version", 0) != world["version"]:
                    # A new world exists and this (host, local_rank) has no
                    # slot in it: we were scaled out.  Exit GRACEFULLY —
                    # the driver records a decommission, not a failure.
                    # Short grace window in case the driver is
                    # mid-publication of yet another world.
                    if scaled_out_since is None:
                        scaled_out_since = time.time()
                    elif time.time() - scaled_out_since > 5.0:
                        get_logger().info(
                            "elastic: no slot for (%s, %s) in world v%s — "
                            "scaled out, exiting", hostname, local_rank,
                            world["version"])
                        raise SystemExit(0)
                else:
                    os.environ[_config.HOROVOD_RANK] = str(rec["rank"])
                    os.environ[_config.HOROVOD_SIZE] = str(rec["size"])
                    os.environ[_config.HOROVOD_LOCAL_RANK] = \
                        str(rec["local_rank"])
                    os.environ[_config.HOROVOD_LOCAL_SIZE] = \
                        str(rec["local_size"])
                    os.environ[_config.HOROVOD_CROSS_RANK] = \
                        str(rec["cross_rank"])
                    os.environ[_config.HOROVOD_CROSS_SIZE] = \
                        str(rec["cross_size"])
                    os.environ["HVD_TPU_WORLD_VERSION"] = \
                        str(rec["version"])
                    return "refreshed"
        except SystemExit:
            raise
        except Exception as e:
            # A dead launcher means no world to rejoin: fail fast rather
            # than polling out the full elastic timeout (note() raises
            # RendezvousUnreachableError on sustained transport death).
            liveness.note(e)
            get_logger().debug("rendezvous refresh retry: %s", e)
        time.sleep(0.5)
    raise HorovodInternalError(
        "timed out waiting for a slot assignment after reset")


def _await_world_at_init_barrier() -> None:
    """Block until EVERY member incarnation of this world generation is
    alive at this barrier — only then is it safe to form the world's
    store and process group.

    Why: a rank that connects to a generation's store while a peer of
    that generation is still being respawned waits out the store's
    timeout, and a rank that gives up moves to another generation while
    its peers form this one.  Parking incarnations HERE (pure KV polling)
    until the full member set of the CURRENT generation is present makes
    the post-crash cycle converge: the last respawn unblocks everyone.

    Presence keys are scoped by WORLD VERSION and carry the same-world
    reset counter ``c`` of the rank's generation "w.c" as their value.
    The barrier completes only when every rank of the version is present
    AT THE SAME ``c`` — and ranks converge on one ``c`` by max-merge:
    in-place resets are not synchronized (one rank may have failed and
    bumped several times before its peer's collective even fails), so a
    rank that sees a LARGER counter announced adopts it (gen + store
    port) instead of waiting forever at its own.  If the world is
    superseded while waiting (version moved past ours — our spawn world
    died), the worker adopts its new slot record and re-announces under
    the new version; a worker with no slot in the new world exits
    gracefully via ``_refresh_world_from_rendezvous``.

    Key lifetime: presence keys persist after the barrier completes —
    safe because the driver bumps the world version on EVERY respawn,
    so a fresh incarnation always rendezvouses under a version whose keys
    only its own world wrote."""
    addr = os.environ.get(_config.HOROVOD_RENDEZVOUS_ADDR)
    port = os.environ.get(_config.HOROVOD_RENDEZVOUS_PORT)
    if not addr or not port or not _elastic():
        return
    from ..runner.http_server import KVStoreClient
    client = KVStoreClient(addr, int(port))
    deadline = time.time() + float(
        os.environ.get(_config.HOROVOD_ELASTIC_TIMEOUT, "600"))
    announced = None  # (version, c) last published
    liveness = _RendezvousLiveness(addr, port)

    def _set_gen(w: int, c: int) -> None:
        os.environ["HVD_TPU_NEGOTIATION_GEN"] = f"{w}.{c}"
        coord = _coordinator_for_gen(f"{w}.{c}")
        if coord:
            os.environ["HVD_TPU_COORDINATOR"] = coord

    while time.time() < deadline:
        my_version = int(os.environ.get("HVD_TPU_WORLD_VERSION", "0"))
        gen = os.environ.get("HVD_TPU_NEGOTIATION_GEN", f"{my_version}.0")
        w, _, c = gen.partition(".")
        my_c = int(c or 0)
        rank = int(os.environ.get(_config.HOROVOD_RANK, "0"))
        size = int(os.environ.get(_config.HOROVOD_SIZE, "1"))
        if size <= 1:
            return  # no peers to meet
        try:
            if announced != (my_version, my_c):
                client.put("initbar", f"{my_version}/{rank}",
                           str(my_c).encode())
                announced = (my_version, my_c)
            raw = client.get("rendezvous", "world")
            liveness.ok()
            world = json.loads(raw) if raw else {}
            if world.get("version", my_version) > my_version:
                # Spawn world superseded: adopt the new world's slot for
                # this (host, local_rank) and re-announce under it.
                _refresh_world_from_rendezvous()
                _set_gen(int(os.environ.get("HVD_TPU_WORLD_VERSION", "0")),
                         0)
                continue
            # One scope scan per poll (O(1) requests per rank per tick).
            bar = client.scan("initbar")
            counters = [int(v) for k, v in bar.items()
                        if k.startswith(f"{my_version}/")
                        and int(k.rsplit("/", 1)[1]) < size]
            cmax = max(counters + [my_c])
            if cmax > my_c:
                get_logger().info(
                    "elastic: init barrier adopting generation %d.%d "
                    "(peer reset further than us)", my_version, cmax)
                _set_gen(my_version, cmax)
                continue
            if len(counters) >= size and \
                    all(cc == cmax for cc in counters):
                return
        except HorovodInternalError:
            raise
        except Exception as e:
            liveness.note(e)
            get_logger().debug("init barrier poll failed: %s", e)
        time.sleep(0.2)
    raise HorovodInternalError(
        "timed out waiting for world members at the init barrier")


def coordinator_port_for(base: int, world_version: int,
                         reset_count: int = 0) -> int:
    """The world store's port for a world incarnation: a fresh TCPStore
    per (world, same-world reset), so no rank of a new generation reads
    an old one's records.  All ranks derive the same value from the same
    generation; the SAME formula feeds freshly spawned workers
    (launch_support) and surviving workers (_reset)."""
    return int(base) + (int(world_version) * 16 + int(reset_count)) % 2000


def _coordinator_for_gen(gen: str) -> Optional[str]:
    """Store address for a negotiation generation "w.c" (see
    coordinator_port_for)."""
    base = os.environ.get("HVD_TPU_COORD_BASE")
    cur = os.environ.get("HVD_TPU_COORDINATOR")
    if not base or not cur:
        return None
    host = cur.rsplit(":", 1)[0]
    w, _, c = gen.partition(".")
    return f"{host}:{coordinator_port_for(int(base), int(w), int(c or 0))}"


def _mark_elastic(phase: str, detail: str = "") -> None:
    """ELASTIC timeline instant around a reset (timeline.elastic_event):
    a trace of a wedged or slow reset shows WHERE the world change
    stalled.  Emitted into whatever timeline is live; never raises."""
    try:
        from .. import core as _core
        tl = _core._state.timeline
        if tl is not None:
            tl.elastic_event(
                phase,
                int(os.environ.get("HVD_TPU_WORLD_VERSION", "0") or 0),
                detail)
    except Exception:  # pragma: no cover - instrumentation only
        pass


def _reset(refresh_world: bool = True,
           allow_same_world: bool = False) -> None:
    """Full reinit: shut the world down, re-rendezvous, re-init on the
    same device (common/elastic.py run_fn 'reinit').

    ``refresh_world=False`` for recovery from a collective failure with
    UNCHANGED membership (HorovodInternalError): the slot env is still
    valid, and the generation's reset counter is bumped so the new world
    serves a fresh store (the init barrier adopts a newer world if the
    driver published one meanwhile)."""
    from .. import core as _core
    device = _core._state.last_device
    # Instant BEFORE shutdown — the old timeline is still alive here.
    _mark_elastic("reset", "refresh-world" if refresh_world
                  else "same-world reinit")
    _core.shutdown()
    if _elastic():
        if refresh_world:
            outcome = _refresh_world_from_rendezvous(
                allow_same_world=allow_same_world)
            if outcome == "same_world":
                refresh_world = False  # fall through to the gen-bump path
            else:
                # New world: generation = (world_version, 0).  Newly
                # spawned workers get the same value from the driver
                # (launch_support), so every member of the new world
                # serves and dials the same store.
                os.environ["HVD_TPU_NEGOTIATION_GEN"] = \
                    f"{os.environ.get('HVD_TPU_WORLD_VERSION', '0')}.0"
                coord = _coordinator_for_gen(
                    os.environ["HVD_TPU_NEGOTIATION_GEN"])
                if coord:
                    os.environ["HVD_TPU_COORDINATOR"] = coord
        if not refresh_world:
            cur = os.environ.get("HVD_TPU_NEGOTIATION_GEN", "0.0")
            w, _, c = cur.partition(".")
            os.environ["HVD_TPU_NEGOTIATION_GEN"] = \
                f"{w}.{int(c or 0) + 1}"
            coord = _coordinator_for_gen(
                os.environ["HVD_TPU_NEGOTIATION_GEN"])
            if coord:
                os.environ["HVD_TPU_COORDINATOR"] = coord
    _core.init(device=device)
    # Instant AFTER re-init — lands in the NEW world's timeline.
    _mark_elastic(
        "world",
        f"gen={os.environ.get('HVD_TPU_NEGOTIATION_GEN', '0.0')}")


def _agree_on_skip_sync(skip_sync: bool) -> bool:
    """Skip the sync only if every rank of the new world wants to: a
    worker spawned into a grown world has nothing to skip from, and a
    broadcast on some ranks against training collectives on others would
    hang.  One object allgather in a world of more than one rank."""
    from .. import core as _core
    from .. import functions as _functions
    if not _core.is_initialized() or _core.size() <= 1:
        return skip_sync
    return all(_functions.allgather_object(bool(skip_sync)))


def run(func):
    """Elastic retry decorator (hvd.elastic.run, common/elastic.py:151).

    Usage::

        state = hvd.elastic.TorchState(model, optimizer, epoch=0)

        @hvd.elastic.run
        def train(state):
            for epoch in range(state.epoch, 90):
                ...train...
                state.epoch = epoch
                state.commit()

        train(state)
    """
    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        import torch.distributed as dist
        notification_manager.init()
        notification_manager.register_listener(state)
        # Crash survival: if a previous incarnation of this worker spilled
        # a commit to disk (HVD_TPU_ELASTIC_SPILL_DIR) that is ahead of the
        # freshly constructed state, adopt it.  The first-iteration sync()
        # then broadcasts rank 0's adopted values so the new world agrees.
        if state.load_spill():
            get_logger().info(
                "elastic: resumed from on-disk spill (commit seq %d)",
                state._commit_seq)
        skip_sync = False
        reset_required = False
        refresh_world = True
        escalated = False
        reset_failures = 0
        no_progress_failures = 0
        try:
            while True:
                if reset_required and not refresh_world:
                    # In-place recovery assumes UNCHANGED membership; a
                    # pending host update (e.g. the failure was a peer
                    # being decommissioned) means the world DID change and
                    # re-initializing into the stale env would hang — take
                    # the refresh path instead.
                    try:
                        state.check_host_updates()
                    except HostsUpdatedInterrupt as e:
                        skip_sync = e.skip_sync
                        refresh_world = True
                        escalated = False  # confirmed membership change
                if reset_required:
                    try:
                        # The driver only notifies when a reshape IS
                        # coming, so the interrupt path waits for the new
                        # version rather than racing it with an in-place
                        # fallback.  escalated=True marks refreshes
                        # adopted on the retry heuristic (not a confirmed
                        # host change): those may fall back to in-place
                        # when the world version never actually moved.
                        _reset(refresh_world=refresh_world,
                               allow_same_world=escalated)
                    except Exception as e:
                        # Re-init can fail transiently while the new world
                        # is still assembling (store connect or process-
                        # group timeouts): retry the reset, letting the
                        # top-of-loop host-update check upgrade to a world
                        # refresh when membership changed again.
                        if not isinstance(e, (HorovodInternalError,
                                              dist.DistError)):
                            raise
                        if isinstance(e, RendezvousUnreachableError):
                            raise  # no launcher → no world to rejoin
                        reset_failures += 1
                        if reset_failures >= 6:
                            # A dead launcher/rendezvous makes every reset
                            # time out; re-raise so the worker terminates
                            # instead of looping timeout/warn forever.
                            raise
                        get_logger().warning(
                            "elastic: reset failed (%s); retrying "
                            "(%d/5)", e, reset_failures)
                        if reset_failures >= 3:
                            # Same-world retries keep failing: assume the
                            # world DID change under us and wait for a new
                            # version (bounded — _reset falls back to
                            # in-place if the version never moves).
                            refresh_world = True
                            escalated = True
                        time.sleep(1.0)
                        continue
                    reset_failures = 0
                    escalated = False
                    # Restore AFTER the reset, onto the new world's device
                    # state.  On the interrupt path this equals the
                    # current values: commit() saved immediately before
                    # raising.
                    state.restore()
                    state.on_reset()
                seq_before = getattr(state, "_commit_seq", 0)
                try:
                    skip_sync = _agree_on_skip_sync(skip_sync)
                    if not skip_sync:
                        state.sync()
                    result = func(state, *args, **kwargs)
                    # Completed: drop the spill so a later job reusing the
                    # directory does not resurrect this run's final state.
                    state.clear_spill()
                    return result
                except HorovodInternalError as e:
                    log_event("failure", error=str(e)[:200])
                    # Progress bound: a DETERMINISTIC failure (e.g. a
                    # device OOM surfacing through the collective error
                    # mapping) would otherwise restore-and-retry forever on
                    # the in-place path, invisible to --reset-limit.  Any
                    # committed progress between failures resets the count.
                    if getattr(state, "_commit_seq", 0) > seq_before:
                        no_progress_failures = 1
                    else:
                        no_progress_failures += 1
                    if no_progress_failures > 5:
                        raise
                    get_logger().info(
                        "elastic: collective failure (%s) — restoring last "
                        "commit", e)
                    skip_sync = False
                    refresh_world = False  # membership unchanged
                    escalated = False
                except HostsUpdatedInterrupt as e:
                    get_logger().info(
                        "elastic: host membership changed — reinitializing")
                    skip_sync = e.skip_sync
                    refresh_world = True
                    escalated = False
                reset_required = True
        finally:
            notification_manager.remove_listener(state)

    return wrapper
