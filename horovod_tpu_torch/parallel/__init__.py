"""Parallelism building blocks of the port: meshes of named axes, ring
and Ulysses sequence parallelism (``ring.py``, ``ulysses.py``) and
flash attention (``flash.py``, whose mask vocabulary serving's paged
attention shares).

Port of ``horovod_tpu/parallel/__init__.py``: ``make_mesh`` (``:32``)
and ``hierarchical_mesh`` (``:52``).  A JAX mesh is an array of devices
with axis names, and ``shard_map`` binds each name so that a collective
over ``axis_name`` runs along that axis.  The port runs one process per
card, so a :class:`Mesh` is an array of global ranks laid out row-major,
as JAX reshapes its devices, and each rank's line along an axis is a
process set with its own ``torch.distributed`` group (``None`` for a
line that covers the world).  ``make_mesh`` registers every line of
every axis through the process-set table on every rank, in one order,
because ``dist.new_group`` is collective over the world.

A function that takes ``axis_name`` resolves it with :func:`axis`: in
the ``mesh`` it is given, else in the most recent ``make_mesh`` that has
the axis, else as the world's one axis (``core.mesh_axis()``, ``"hvd"``,
the axis of ``core.mesh()``).  ``shard_step``, ``data_parallel_sharding``
and ``replicated_sharding`` are not ported yet (ROADMAP A6).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from .. import core as _core
from ..process_sets import ProcessSet, global_process_set


class Axis(NamedTuple):
    """One mesh axis as this rank sees it."""
    name: str
    size: int
    index: int                 # this rank's position along the axis
    ranks: Tuple[int, ...]     # this rank's line, in axis order
    process_set: ProcessSet
    group: Optional[dist.ProcessGroup]   # None: the world's group


class Mesh:
    """Global ranks laid out over named axes (``jax.sharding.Mesh``'s
    role).  ``devices`` is the int array of ranks, of shape
    ``tuple(shape.values())``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        self._sets: Dict[Tuple[str, ...], ProcessSet] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _dims(self, axes: Sequence[str]) -> List[int]:
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not in the mesh "
                                 f"{self.shape}")
        return [self.axis_names.index(a) for a in axes]

    def coords(self, rank: int) -> Tuple[int, ...]:
        """``rank``'s position on every axis."""
        hit = np.argwhere(self.devices == rank)
        if not len(hit):
            raise ValueError(f"rank {rank} is not in the mesh")
        return tuple(int(c) for c in hit[0])

    def lines(self, *axes: str) -> List[Tuple[int, ...]]:
        """Every sub-mesh spanning ``axes`` (the other axes fixed), each
        as its ranks in row-major order over ``axes``, in one order."""
        dims = self._dims(axes)
        rest = [d for d in range(self.devices.ndim) if d not in dims]
        moved = np.transpose(self.devices, rest + dims)
        width = int(np.prod([self.devices.shape[d] for d in dims]))
        return [tuple(int(r) for r in row)
                for row in moved.reshape(-1, width)]

    def line(self, rank: int, *axes: str) -> Tuple[int, ...]:
        """The sub-mesh spanning ``axes`` that holds ``rank``."""
        return next(ln for ln in self.lines(*axes) if rank in ln)

    def process_set(self, *axes: str) -> ProcessSet:
        """This rank's sub-mesh spanning ``axes`` as a process set: the
        global set when it covers the world.  The first call for a
        combination of axes registers every such sub-mesh on this rank
        (collective: every rank calls it, for the same axes, in the same
        order; ``make_mesh`` does it for each single axis)."""
        key = tuple(axes)
        if key not in self._sets:
            st = _core._require_init()
            world = st.topology.size
            if sorted(self.devices.ravel().tolist()) != list(range(world)):
                raise ValueError(f"a mesh of ranks {self.devices.tolist()} "
                                 f"does not lay out the world of {world}")
            mine = None
            for ln in self.lines(*axes):
                if list(ln) != sorted(ln):
                    raise ValueError(
                        f"the ranks along {key} must ascend, got {ln}: a "
                        f"process set orders its members by rank")
                ps = global_process_set if len(ln) == world else \
                    st.process_set_table.register(ProcessSet(list(ln)))
                if st.topology.rank in ln:
                    mine = ps
            self._sets[key] = mine
        return self._sets[key]

    def axis(self, name: str) -> Axis:
        """``name`` as this rank sees it: size, index, line, set, group."""
        st = _core._require_init()
        ps = self.process_set(name)
        line = self.line(st.topology.rank, name)
        group, _ = st.process_set_table.resolve(ps)
        return Axis(name, len(line), line.index(st.topology.rank), line,
                    ps, group)

    def __repr__(self):
        return f"Mesh({self.shape})"


def _layout(axis_sizes: dict, devices) -> Mesh:
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(s) for s in axis_sizes.values())
    total = int(np.prod(sizes))
    devices = np.asarray(list(devices), dtype=np.int64).ravel()
    if total != devices.size:
        raise ValueError(f"mesh {axis_sizes} needs {total} devices, "
                         f"have {devices.size}")
    return Mesh(devices.reshape(sizes), names)


def make_mesh(axis_sizes: dict, devices: Optional[Sequence[int]] = None
              ) -> Mesh:
    """A mesh of axis name → size over the world's ranks (or
    ``devices``), e.g. ``{"dp": 2, "sp": 2}``: rank ``r`` sits at the
    row-major position of ``r``.  When the runtime is initialized and
    the mesh lays out the world, every line of every axis is registered
    (collective: every rank makes the same meshes in the same order) and
    the mesh's axes become resolvable by name (:func:`axis`); otherwise
    the mesh is a layout only."""
    if devices is None:
        devices = range(_core._require_init().topology.size)
    mesh = _layout(axis_sizes, devices)
    if _core.is_initialized() and \
            sorted(mesh.devices.ravel().tolist()) == \
            list(range(_core.size())):
        for name in mesh.axis_names:
            mesh.process_set(name)
        _core._state.meshes.append(mesh)
    return mesh


def hierarchical_mesh() -> Mesh:
    """``{"cross": nodes, "local": ranks per node}`` from the topology
    (the JAX package's (cross, local) layout; the port's two-level
    allreduce is ``hvd.hierarchical_allreduce``)."""
    topo = _core._require_init().topology
    local = max(1, topo.local_size)
    return make_mesh({"cross": max(1, topo.size // local), "local": local})


def axis(axis_name: str, mesh: Optional[Mesh] = None) -> Axis:
    """Resolve ``axis_name``: in ``mesh``, else in the most recent
    ``make_mesh`` that has it, else as the world's axis of
    ``core.mesh()``."""
    if mesh is not None:
        return mesh.axis(axis_name)
    st = _core._require_init()
    for m in reversed(st.meshes):
        if axis_name in m.shape:
            return m.axis(axis_name)
    if axis_name == st.config.mesh_axis:
        return _core.mesh().axis(axis_name)
    raise ValueError(
        f"axis {axis_name!r} is not bound: build a mesh with it "
        f"(make_mesh) or pass mesh=; the world's axis is "
        f"{st.config.mesh_axis!r}")


def axes_process_set(axes: Sequence[str], mesh: Optional[Mesh] = None
                     ) -> ProcessSet:
    """This rank's sub-mesh spanning ``axes`` as a process set (the
    global set when the axes span the world), from ``mesh``, else the
    most recent ``make_mesh`` holding every axis, else the world's axis.
    Collective on first use for a combination (``Mesh.process_set``)."""
    axes = tuple(axes)
    st = _core._require_init()
    if mesh is None:
        mesh = next((m for m in reversed(st.meshes)
                     if all(a in m.shape for a in axes)), None)
    if mesh is None:
        if set(axes) != {st.config.mesh_axis}:
            raise ValueError(
                f"axes {axes} are not bound: build a mesh with them "
                f"(make_mesh); the world's axis is {st.config.mesh_axis!r}")
        return global_process_set
    return mesh.process_set(*axes)
