"""Elastic training on Ray: autoscaler-driven discovery and actor workers.

Copy of ``horovod_tpu/ray_elastic.py`` (framework-free).  Reference:
horovod/ray/elastic_v2.py: RayHostDiscovery (:40) turns the Ray
cluster's alive nodes into the {hostname: slots} the ElasticDriver
consumes; ElasticAdapter (:197) spawns one Ray actor per assigned slot
with the elastic rendezvous env and feeds worker exits back to the
driver, so autoscaler events become elastic scale-up / scale-down.

The port's own ``ElasticDriver`` (``elastic/driver.py``) runs it; only
discovery (Ray node state) and the worker launch (Ray actors) differ
from the CLI's elastic path.  The actor-spawn layer is injectable
(``spawn_fn``), so the wiring is testable with a fake cluster.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import config as _config
from .elastic import coordinator_port_for
from .elastic.discovery import HostDiscovery
from .elastic.driver import ElasticDriver
from .runner import hosts as _hosts
from .runner.http_server import RendezvousServer
from .utils import get_logger


def _require_ray():
    try:
        import ray  # noqa: F401
        return ray
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.ray_elastic requires the 'ray' package "
            "(pip install ray); the core framework does not depend on it"
        ) from e


class RayHostDiscovery(HostDiscovery):
    """Maps the Ray cluster's alive nodes to {hostname: slots}
    (elastic_v2.py:40 RayHostDiscovery).

    Slots per node = GPU count / gpus_per_worker when ``use_gpu``, else
    TPU resource / tpu_per_worker when ``tpu_per_worker``, else
    CPU count / cpus_per_worker."""

    def __init__(self, use_gpu: bool = False, cpus_per_worker: int = 1,
                 gpus_per_worker: int = 1, tpu_per_worker: int = 0):
        self.use_gpu = use_gpu
        self.cpus_per_worker = cpus_per_worker
        self.gpus_per_worker = gpus_per_worker
        self.tpu_per_worker = tpu_per_worker

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        ray = _require_ray()
        result: Dict[str, int] = {}
        for node in ray.nodes():
            if not node.get("Alive", False):
                continue
            resources = node.get("Resources", {}) or {}
            hostname = node.get("NodeManagerHostname") or \
                node.get("NodeManagerAddress")
            if not hostname:
                continue
            if self.tpu_per_worker:
                slots = int(resources.get("TPU", 0) // self.tpu_per_worker)
            elif self.use_gpu:
                slots = int(resources.get("GPU", 0) //
                            max(self.gpus_per_worker, 1))
            else:
                slots = int(resources.get("CPU", 0) //
                            max(self.cpus_per_worker, 1))
            if slots > 0:
                result[hostname] = result.get(hostname, 0) + slots
        return result


def _worker_entry(fn, args, kwargs):
    """Runs INSIDE the worker: executes the user fn, then reports the
    worker's FINAL (world_version, rank, size) — a survivor's rank/world
    change across resets (elastic/__init__.py _refresh_world_from_rendezvous
    refreshes the env), so the spawn-time slot cannot key the result."""
    import os
    value = fn(*args, **(kwargs or {}))
    return (int(os.environ.get("HVD_TPU_WORLD_VERSION", "0")),
            int(os.environ.get(_config.HOROVOD_RANK, "0")),
            int(os.environ.get(_config.HOROVOD_SIZE, "1")),
            value)


class _RayActorHandle:
    """Default spawn layer: one Ray actor pinned to the slot's node."""

    def __init__(self, fn, args, kwargs, env: Dict[str, str],
                 hostname: str, opts: dict):
        ray = _require_ray()

        @ray.remote(**opts)
        class _ElasticWorker:
            def run(self, env, fn, args, kwargs):
                import os
                os.environ.update(env)
                return fn(*args, **(kwargs or {}))

        # Soft node affinity: the slot was assigned to this hostname by the
        # driver (elastic_v2.py _create_resources node_id resource pinning).
        try:
            from ray.util.scheduling_strategies import \
                NodeAffinitySchedulingStrategy
            for node in ray.nodes():
                if node.get("Alive") and \
                        (node.get("NodeManagerHostname") == hostname or
                         node.get("NodeManagerAddress") == hostname):
                    opts = dict(opts, scheduling_strategy=
                                NodeAffinitySchedulingStrategy(
                                    node_id=node["NodeID"], soft=True))
                    break
        except Exception:  # older ray: fall back to default scheduling
            pass
        self._actor = _ElasticWorker.options(**opts).remote() \
            if hasattr(_ElasticWorker, "options") else _ElasticWorker.remote()
        self._ref = self._actor.run.remote(env, fn, args, kwargs)
        self._result = None

    def wait(self, timeout: float) -> bool:
        """True when finished (result or failure)."""
        ray = _require_ray()
        done, _ = ray.wait([self._ref], timeout=timeout)
        return bool(done)

    def result(self) -> Tuple[int, Any]:
        """(exit_code, result) — nonzero when the actor died/raised."""
        ray = _require_ray()
        try:
            return 0, ray.get(self._ref)
        except Exception as e:
            get_logger().warning("ray elastic worker failed: %s", e)
            return 1, None

    def kill(self) -> None:
        ray = _require_ray()
        try:
            ray.kill(self._actor)
        except Exception:
            pass


class ElasticRayExecutor:
    """Elastic executor on Ray (elastic_v2.py:197 ElasticAdapter; v1 API
    name ElasticRayExecutor).

    Usage::

        executor = ElasticRayExecutor(min_workers=1, max_workers=4)
        executor.start()
        results = executor.run(train_fn)   # train_fn uses hvd.elastic.run
        executor.shutdown()
    """

    def __init__(self,
                 settings: Optional[dict] = None,
                 min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 reset_limit: Optional[int] = None,
                 cooldown_range: Optional[Tuple[float, float]] = None,
                 cpus_per_worker: int = 1,
                 use_gpu: bool = False,
                 gpus_per_worker: int = 0,
                 tpu_per_worker: int = 0,
                 elastic_timeout: float = 600.0,
                 override_discovery: Optional[HostDiscovery] = None,
                 spawn_fn: Optional[Callable] = None,
                 extra_env_vars: Optional[Dict[str, str]] = None):
        self.settings = settings or {}
        self.min_workers = min_workers
        self.max_workers = max_workers or min_workers
        self.reset_limit = reset_limit
        self.cooldown_range = cooldown_range
        self.cpus_per_worker = cpus_per_worker
        self.use_gpu = use_gpu
        self.gpus_per_worker = gpus_per_worker
        self.tpu_per_worker = tpu_per_worker
        self.elastic_timeout = elastic_timeout
        self.extra_env_vars = dict(extra_env_vars or {})
        self._discovery = override_discovery
        self._spawn_fn = spawn_fn  # injectable for tests / other backends
        self._rendezvous: Optional[RendezvousServer] = None
        self._driver: Optional[ElasticDriver] = None
        self._addr: Optional[str] = None
        self._port: Optional[int] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Start the rendezvous server and the elastic driver
        (elastic_v2.py ElasticAdapter.start)."""
        if self._discovery is None:
            self._discovery = RayHostDiscovery(
                use_gpu=self.use_gpu, cpus_per_worker=self.cpus_per_worker,
                gpus_per_worker=self.gpus_per_worker,
                tpu_per_worker=self.tpu_per_worker)
        self._rendezvous = RendezvousServer()
        self._port = self._rendezvous.start()
        self._addr = socket.gethostbyname(socket.gethostname())
        self._driver = ElasticDriver(
            self._rendezvous, self._discovery,
            self.min_workers, self.max_workers,
            reset_limit=self.reset_limit,
            cooldown_range=self.cooldown_range,
            timeout=self.elastic_timeout)

    def _worker_env(self, slot: _hosts.SlotInfo, world_version: int) -> Dict:
        from .elastic.launch_support import slot_env
        return {
            **slot_env(slot, world_version, self._addr, self._port,
                       self._driver, coord_base=self._port + 1),
            **self.extra_env_vars,
        }

    def _default_spawn(self, fn, args, kwargs, env, slot):
        opts = {"num_cpus": self.cpus_per_worker}
        if self.use_gpu or self.gpus_per_worker:
            opts["num_gpus"] = self.gpus_per_worker or 1
        if self.tpu_per_worker:
            opts["resources"] = {"TPU": self.tpu_per_worker}
        return _RayActorHandle(fn, args, kwargs, env, slot.hostname, opts)

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[dict] = None) -> List[Any]:
        """Launch the elastic world and block until it settles; returns the
        FINAL world's per-rank results ordered by rank (elastic_v2.py run).
        ``fn`` should wrap its training loop in ``hvd.elastic.run`` to
        survive reshapes."""
        import functools
        if self._driver is None:
            self.start()
        driver = self._driver
        spawn = self._spawn_fn or self._default_spawn
        entry = functools.partial(_worker_entry, fn, args, kwargs)
        results: Dict[Tuple[int, int], Any] = {}  # (version, rank) -> value
        results_lock = threading.Lock()

        def worker_fn(slot: _hosts.SlotInfo,
                      terminate_event: threading.Event,
                      world_version: int) -> int:
            env = self._worker_env(slot, world_version)
            handle = spawn(entry, (), {}, env, slot)
            while not handle.wait(timeout=0.25):
                if terminate_event.is_set():
                    handle.kill()
                    return 143
            code, value = handle.result()
            if code == 0:
                ver, rank, _size, v = value
                with results_lock:
                    results[(ver, rank)] = v
            return code

        driver.start(worker_fn)
        driver.join()
        if driver.error_message:
            raise RuntimeError(driver.error_message)
        states = driver.registry.last_rank_states()
        failed = [k for k, v in states.items() if v == "FAILURE"]
        if failed:
            raise RuntimeError(
                f"ray elastic run finished with failed slots: {failed}")
        final = driver.world_version
        with results_lock:
            final_results = {r: v for (ver, r), v in results.items()
                             if ver == final}
        return [final_results[r] for r in sorted(final_results)]

    def shutdown(self) -> None:
        if self._driver is not None:
            self._driver.stop()
            self._driver = None
        if self._rendezvous is not None:
            self._rendezvous.stop()
            self._rendezvous = None
