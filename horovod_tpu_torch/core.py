"""Global runtime state and the init / info API.

Port of ``horovod_tpu/core.py:146-453``: ``init``, ``shutdown``,
``is_initialized``, rank / size / local / cross, ``num_slots``,
``local_slots``, ``is_homogeneous``, ``mesh`` / ``mesh_axis``
(``:387-393``), ``start_timeline`` / ``stop_timeline`` and the built /
enabled queries.  The state holds the
process-set table (``process_sets.py``), the async handles and the eager
engine (``ops/eager.py``), the world's store and the timeline.

The world forms through ``torch.distributed.init_process_group`` over a
store that ``init`` makes itself: NCCL for a CUDA device, gloo for
``device="cpu"``.  Under a launcher (``HOROVOD_RANK`` / ``HOROVOD_SIZE``
set, size > 1) the store is a ``TCPStore`` served by rank 0 at the
address the JAX package's ``_maybe_join_distributed`` reads
(``core.py:72-143``): ``HVD_TPU_COORDINATOR``, else the rendezvous
address at its port + 1.  The eager engine negotiates over the same
store (``ops/negotiation.py``).  A world of one still gets a one-member
group over an in-memory ``HashStore``, so a single card's training step
goes through NCCL like a many-card one.  ``HOROVOD_TIMELINE`` starts the
timeline on rank 0 at ``init`` (``core.py:271-277``).
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from . import config as _config
from . import topology as _topology
from .utils.device import resolve_device
from .utils.logging import get_logger


class _GlobalState:
    """Singleton per process (``HorovodGlobalState`` in the reference)."""

    def __init__(self):
        self.lock = threading.RLock()
        self.initialized = False
        self.config: Optional[_config.Config] = None
        self.topology: Optional[_topology.Topology] = None
        self.device: Optional[torch.device] = None
        self.backend: Optional[str] = None
        self.owns_group = False
        self.process_set_table = None
        self.handles = None
        self.engine = None
        self.store: Optional[dist.Store] = None
        # host, port of a TCPStore (None for a HashStore or a store the
        # caller's process group made): the negotiator's flusher opens
        # its own client connection there.
        self.store_address: Optional[tuple] = None
        self.timeline = None
        # The world as one mesh axis (``mesh()``), and the meshes
        # ``parallel.make_mesh`` made, newest last: ``parallel.axis``
        # resolves an axis name in them.
        self.world_mesh = None
        self.meshes: list = []


_state = _GlobalState()


def _store_address() -> str:
    coord = os.environ.get(_config.HVD_TPU_COORDINATOR)
    if coord:
        return coord
    addr = os.environ.get(_config.HOROVOD_RENDEZVOUS_ADDR)
    port = os.environ.get(_config.HOROVOD_RENDEZVOUS_PORT)
    if addr is None:
        raise ValueError(
            f"a world of more than one rank needs "
            f"{_config.HVD_TPU_COORDINATOR} or "
            f"{_config.HOROVOD_RENDEZVOUS_ADDR}/"
            f"{_config.HOROVOD_RENDEZVOUS_PORT} in the environment (the "
            f"launcher exports them)")
    return f"{addr}:{int(port) + 1 if port else 9999}"


def init(comm: Optional[Sequence[int]] = None, process_sets=None,
         device=None) -> None:
    """Join the world (``hvd.init``).  ``device`` is where this rank's
    tensors live: ``cuda`` unless named (it raises without a card);
    ``cpu`` forms a gloo world.  ``comm`` must be every rank.
    ``process_sets`` are registered once the world has formed, in their
    order, which must be the same on every rank."""
    from . import process_sets as _ps
    from .ops.eager import EagerEngine, HandleManager
    with _state.lock:
        if _state.initialized:
            return
        dev = resolve_device(device)
        cfg = _config.Config.from_env()
        topo = _topology.detect()
        if comm is not None and list(comm) != list(range(topo.size)):
            raise ValueError(
                "init(comm=...) with a strict subset of ranks is not "
                "supported; use process sets instead")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda",
                                   topo.local_rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        owns = not dist.is_initialized()
        address = None
        if owns:
            if topo.size > 1:
                host, port = _store_address().rsplit(":", 1)
                address = (host, int(port))
                store = dist.TCPStore(
                    host, int(port), topo.size, topo.rank == 0,
                    timeout=datetime.timedelta(
                        seconds=max(cfg.gloo_timeout_seconds, 300.0)))
            else:
                store = dist.HashStore()
            dist.init_process_group(backend, store=store,
                                    world_size=topo.size, rank=topo.rank)
        elif (dist.get_world_size(), dist.get_rank()) != (topo.size,
                                                          topo.rank):
            raise ValueError(
                f"torch.distributed is already initialized as rank "
                f"{dist.get_rank()} of {dist.get_world_size()}, but the "
                f"environment says rank {topo.rank} of {topo.size}")
        _state.config, _state.topology = cfg, topo
        _state.device, _state.backend = dev, dist.get_backend()
        _state.owns_group = owns
        _state.store = store if owns else \
            dist.distributed_c10d._get_default_store()
        _state.store_address = address
        _state.process_set_table = _ps.ProcessSetTable(topo.num_slots)
        _state.handles = HandleManager()
        _state.engine = EagerEngine(topo)
        if cfg.timeline_path and topo.rank == 0:
            # Rank 0 writes the trace, like the reference's coordinator.
            from .timeline import Timeline
            _state.timeline = Timeline(cfg.timeline_path,
                                       mark_cycles=cfg.timeline_mark_cycles,
                                       rank=topo.rank)
        _state.initialized = True
        for ps in process_sets or ():
            _state.process_set_table.register(ps)
        get_logger().info(
            "horovod_tpu_torch initialized: rank=%d size=%d local=%d/%d "
            "cross=%d/%d backend=%s device=%s", topo.rank, topo.size,
            topo.local_rank, topo.local_size, topo.cross_rank,
            topo.cross_size, _state.backend, dev)


def shutdown() -> None:
    """Leave the world (``horovod_shutdown``): closes the timeline and
    the negotiator (its flusher stops after shipping the pending
    records), then destroys every process set's group, and the world's
    if ``init`` created it."""
    with _state.lock:
        if not _state.initialized:
            return
        if _state.timeline is not None:
            _state.timeline.close()
            _state.timeline = None
        _state.engine.close()
        if dist.is_initialized():
            _state.process_set_table.destroy()
            if _state.owns_group:
                dist.destroy_process_group()
        _state.initialized = False
        _state.topology = _state.device = _state.backend = None
        _state.process_set_table = _state.handles = None
        _state.engine = _state.store = _state.store_address = None
        _state.world_mesh = None
        _state.meshes = []


def _require_init() -> _GlobalState:
    if not _state.initialized:
        raise ValueError(
            "horovod_tpu_torch has not been initialized; call "
            "horovod_tpu_torch.init() first")
    return _state


def is_initialized() -> bool:
    return _state.initialized


def rank() -> int:
    """Global process rank."""
    return _require_init().topology.rank


def size() -> int:
    """Number of ranks."""
    return _require_init().topology.size


def local_rank() -> int:
    """Rank within the node."""
    return _require_init().topology.local_rank


def local_size() -> int:
    """Ranks on this node."""
    return _require_init().topology.local_size


def cross_rank() -> int:
    """Node index."""
    return _require_init().topology.cross_rank


def cross_size() -> int:
    """Number of nodes."""
    return _require_init().topology.cross_size


def num_slots() -> int:
    """Cards in the job: one per rank."""
    return _require_init().topology.num_slots


def local_slots() -> int:
    """Cards this process drives: one."""
    return _require_init().topology.local_slots


def is_homogeneous() -> bool:
    """``horovod_is_homogeneous``: equal slots on every process."""
    return _require_init().topology.is_homogeneous


def mesh():
    """The world as one mesh axis named :func:`mesh_axis`
    (``parallel.Mesh``), rank ``r`` at position ``r``."""
    st = _require_init()
    if st.world_mesh is None:
        import numpy as np
        from .parallel import Mesh
        st.world_mesh = Mesh(np.arange(st.topology.size),
                             (st.config.mesh_axis,))
    return st.world_mesh


def mesh_axis() -> str:
    """The name of the world's axis (``HVD_TPU_MESH_AXIS``, ``"hvd"``)."""
    return _require_init().config.mesh_axis


def device() -> torch.device:
    """This rank's device (``init``'s ``device``)."""
    return _require_init().device


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Start writing the timeline to ``file_path``
    (``horovod_start_timeline``, operations.cc:1077); a running one is
    closed first."""
    from .timeline import Timeline
    st = _require_init()
    if st.timeline is not None:
        st.timeline.close()
    st.timeline = Timeline(file_path, mark_cycles=mark_cycles,
                           rank=st.topology.rank)


def stop_timeline() -> None:
    """Close the timeline (``horovod_stop_timeline``)."""
    st = _require_init()
    if st.timeline is not None:
        st.timeline.close()
        st.timeline = None


# ---------------------------------------------------------------------------
# Built / enabled queries (operations.cc:1050-1140 in the reference).
# ---------------------------------------------------------------------------

def mpi_threads_supported() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def mpi_built() -> bool:
    return False


def gloo_built() -> bool:
    return dist.is_gloo_available()


def gloo_enabled() -> bool:
    return _state.initialized and _state.backend == "gloo"


def nccl_built() -> bool:
    return dist.is_nccl_available() and torch.cuda.is_available()


def cuda_built() -> bool:
    return torch.backends.cuda.is_built() and torch.cuda.is_available()


def rocm_built() -> bool:
    return torch.version.hip is not None


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def xla_built() -> bool:
    return False


def xla_enabled() -> bool:
    return False
