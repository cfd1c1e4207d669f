"""Ray cluster integration: ``RayExecutor``.

Copy of ``horovod_tpu/ray_integration.py`` (framework-free).  Reference:
horovod/ray/runner.py:45 RayExecutor (one actor per slot, a coordinator
that computes ranks and injects the rendezvous env, the run /
run_remote / execute API).  Each actor gets the ``HOROVOD_*``
rendezvous env the CLI launcher injects and runs the user function,
which calls ``hvd.init()`` (one card per actor with ``use_gpu``).  ray
is imported at call time: the port does not depend on it.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, Dict, List, Optional

from . import config as _config
from .runner import hosts as _hosts
from .runner.http_server import RendezvousServer


def _require_ray():
    try:
        import ray  # noqa: F401
        return ray
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.ray_integration requires the 'ray' package "
            "(pip install ray); the core framework does not depend on it"
        ) from e


class RayExecutor:
    """Job executor backed by Ray actors (ray/runner.py:45 RayExecutor).

    Usage::

        executor = RayExecutor(num_workers=4, cpus_per_worker=1)
        executor.start()
        results = executor.run(train_fn, args=(lr,))
        executor.shutdown()
    """

    def __init__(self,
                 settings: Optional[dict] = None,
                 num_workers: int = 1,
                 cpus_per_worker: int = 1,
                 use_gpu: bool = False,
                 gpus_per_worker: int = 0,
                 tpu_per_worker: int = 0,
                 use_current_placement_group: bool = True):
        self.settings = settings or {}
        self.num_workers = num_workers
        self.cpus_per_worker = cpus_per_worker
        self.use_gpu = use_gpu
        self.gpus_per_worker = gpus_per_worker
        self.tpu_per_worker = tpu_per_worker
        self.use_current_placement_group = use_current_placement_group
        self._workers: List[Any] = []
        self._rendezvous: Optional[RendezvousServer] = None

    def start(self,
              executable_cls: Optional[type] = None,
              executable_args: Optional[list] = None,
              extra_env_vars: Optional[Dict[str, str]] = None):
        """Create the actor pool and rendezvous (runner.py start)."""
        ray = _require_ray()
        self._rendezvous = RendezvousServer()
        port = self._rendezvous.start()
        addr = socket.gethostbyname(socket.gethostname())
        host_list = [_hosts.HostInfo(f"ray-slot-{i}", 1)
                     for i in range(self.num_workers)]
        assignments = _hosts.get_host_assignments(host_list,
                                                  self.num_workers)
        self._rendezvous.init(assignments)

        opts = {"num_cpus": self.cpus_per_worker}
        if self.use_gpu or self.gpus_per_worker:
            opts["num_gpus"] = self.gpus_per_worker or 1
        if self.tpu_per_worker:
            opts["resources"] = {"TPU": self.tpu_per_worker}
        if self.use_current_placement_group:
            # Run inside the caller's placement group when one exists
            # (ray/strategy.py pack semantics).
            pg = ray.util.get_current_placement_group()
            if pg is not None:
                from ray.util.scheduling_strategies import \
                    PlacementGroupSchedulingStrategy
                opts["scheduling_strategy"] = \
                    PlacementGroupSchedulingStrategy(placement_group=pg)

        @ray.remote(**opts)
        class Worker:
            def __init__(self, env: Dict[str, str]):
                os.environ.update(env)
                self._obj = None

            def setup(self, cls, args):
                self._obj = cls(*(args or []))
                return True

            def execute_fn(self, fn, *args, **kwargs):
                return fn(*args, **kwargs)

            def execute_obj(self, fn):
                return fn(self._obj)

        self._workers = []
        for slot in assignments:
            env = {
                _config.HOROVOD_RANK: str(slot.rank),
                _config.HOROVOD_SIZE: str(slot.size),
                _config.HOROVOD_LOCAL_RANK: str(slot.local_rank),
                _config.HOROVOD_LOCAL_SIZE: str(slot.local_size),
                _config.HOROVOD_CROSS_RANK: str(slot.cross_rank),
                _config.HOROVOD_CROSS_SIZE: str(slot.cross_size),
                _config.HOROVOD_RENDEZVOUS_ADDR: addr,
                _config.HOROVOD_RENDEZVOUS_PORT: str(port),
                # Derived from the dynamically-allocated rendezvous port so
                # concurrent executors on one head node don't collide.
                "HVD_TPU_COORDINATOR": f"{addr}:{port + 1}",
                **(extra_env_vars or {}),
            }
            self._workers.append(Worker.remote(env))
        if executable_cls is not None:
            ray.get([w.setup.remote(executable_cls, executable_args)
                     for w in self._workers])

    def run(self, fn: Callable, args: tuple = (), kwargs: Optional[dict] = None
            ) -> List[Any]:
        """Run fn(*args) on every worker, return per-rank results ordered by
        rank (runner.py run; fn never receives the executable object)."""
        ray = _require_ray()
        kwargs = kwargs or {}
        return ray.get([w.execute_fn.remote(fn, *args, **kwargs)
                        for w in self._workers])

    def run_remote(self, fn: Callable, args: tuple = (),
                   kwargs: Optional[dict] = None) -> List[Any]:
        """Async variant returning Ray object refs (runner.py run_remote)."""
        _require_ray()
        kwargs = kwargs or {}
        return [w.execute_fn.remote(fn, *args, **kwargs)
                for w in self._workers]

    def execute(self, fn: Callable) -> List[Any]:
        """Run fn(executable_obj) on every worker (runner.py execute;
        requires start(executable_cls=...))."""
        ray = _require_ray()
        return ray.get([w.execute_obj.remote(fn) for w in self._workers])

    def shutdown(self):
        ray = _require_ray()
        for w in self._workers:
            ray.kill(w)
        self._workers = []
        if self._rendezvous is not None:
            self._rendezvous.stop()
            self._rendezvous = None
