"""Spark cluster integration: run a training function on Spark executors.

Copy of ``horovod_tpu/spark_integration.py`` (framework-free).
Reference: horovod/spark/runner.py:200 ``horovod.spark.run``.  The
driver hosts the HTTP rendezvous KV store; each barrier-mode Spark task
becomes one rank, gets the slot's ``HOROVOD_*`` variables and
``HVD_TPU_COORDINATOR`` (rank 0's task publishes the address of the
world's store through the KV), calls the function, and ships its result
back through Spark's collect.  The Estimator / Store layer lives in
``horovod_tpu_torch.spark``.  pyspark is imported at call time: the port
does not depend on it.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, List, Optional

from . import config as _config
from .runner import hosts as _hosts
from .runner.http_server import RendezvousServer


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
        return pyspark
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark_integration requires 'pyspark'; the core "
            "framework does not depend on it") from e


def run(fn: Callable,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        num_proc: Optional[int] = None,
        extra_env_vars: Optional[dict] = None,
        verbose: int = 1) -> List[Any]:
    """Run ``fn`` on ``num_proc`` Spark tasks and return per-rank results
    ordered by rank (horovod.spark.run, spark/runner.py:200).

    The driver starts the rendezvous KV store; each barrier-mode task
    receives its rank env (HOROVOD_RANK/SIZE + rendezvous address), calls
    ``fn``, and ships its result back through Spark's collect."""
    pyspark = _require_pyspark()
    from pyspark import SparkContext

    sc = SparkContext._active_spark_context
    if sc is None:
        raise RuntimeError("no active SparkContext; create a SparkSession "
                           "before horovod_tpu_torch.spark_integration.run")
    num_proc = num_proc or sc.defaultParallelism
    kwargs = kwargs or {}

    rendezvous = RendezvousServer()
    port = rendezvous.start()
    addr = socket.gethostbyname(socket.gethostname())
    host_list = [_hosts.HostInfo(f"spark-task-{i}", 1)
                 for i in range(num_proc)]
    rendezvous.init(_hosts.get_host_assignments(host_list, num_proc))
    extra = dict(extra_env_vars or {})

    def task_fn(_iterator):
        # Barrier task context: Spark gang-schedules all partitions or fails
        # fast when the cluster lacks slots (spark/runner.py start_timeout
        # guard); a plain mapPartitions would deadlock half-scheduled.
        from pyspark import BarrierTaskContext
        ctx = BarrierTaskContext.get()
        index = ctx.partitionId()
        # The world's store (TCPStore) runs inside rank 0's task on
        # whatever executor it landed on — rank 0 publishes its address via
        # the driver-hosted KV store and everyone else polls it (the CLI
        # launcher knows hostnames up front, runner/launch.py; Spark does
        # not).
        from .runner.http_server import KVStoreClient
        import time as _time
        client = KVStoreClient(addr, port)
        if index == 0:
            my_ip = socket.gethostbyname(socket.gethostname())
            client.put("spark", "coordinator",
                       f"{my_ip}:{port + 1}".encode())
            coordinator = f"{my_ip}:{port + 1}"
        else:
            deadline = _time.time() + 300
            coordinator = None
            while _time.time() < deadline:
                raw = client.get("spark", "coordinator")
                if raw:
                    coordinator = raw.decode()
                    break
                _time.sleep(0.2)
            if coordinator is None:
                raise RuntimeError(
                    "timed out waiting for rank 0's coordinator address")
        os.environ.update({
            _config.HOROVOD_RANK: str(index),
            _config.HOROVOD_SIZE: str(num_proc),
            _config.HOROVOD_LOCAL_RANK: "0",
            _config.HOROVOD_LOCAL_SIZE: "1",
            _config.HOROVOD_CROSS_RANK: str(index),
            _config.HOROVOD_CROSS_SIZE: str(num_proc),
            _config.HOROVOD_RENDEZVOUS_ADDR: addr,
            _config.HOROVOD_RENDEZVOUS_PORT: str(port),
            "HVD_TPU_COORDINATOR": coordinator,
            **extra,
        })
        yield index, fn(*args, **kwargs)

    try:
        rdd = sc.parallelize(range(num_proc), num_proc)
        results = rdd.barrier().mapPartitions(task_fn).collect()
    finally:
        rendezvous.stop()
    return [r for _, r in sorted(results)]


def __getattr__(name):
    # Lazy re-export: the Estimator layer lives in horovod_tpu_torch.spark
    # (spark/estimator.py), but the old import path keeps working.
    if name in ("HorovodTpuEstimator", "TpuTransformer"):
        from .spark import estimator as _est
        return getattr(_est, name)
    raise AttributeError(name)
