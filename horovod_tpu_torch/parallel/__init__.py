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
the axis of ``core.mesh()``).

Model parallelism: ``moe.py`` (experts over an axis, two alltoalls),
``tensor.py`` (Megatron's column / row pair, one allreduce) and
``pipeline.py`` (GPipe over P2P hops).  A parameter that holds a shard
of a larger weight carries the axes it is sharded over
(:func:`mark_sharded`, read by :func:`sharded_axes`), the port's stand-in
for JAX's varying-axes type: ``DistributedOptimizer(reduce_axes=...)``
does not sum its gradient over them.

``shard_step`` (``:63``) runs a per-rank step on this rank's pieces of
its arguments, as ``jax.shard_map`` hands each device its block:
:class:`PartitionSpec` ``P(axis)`` splits dim 0 by this rank's index on
the axis (a tuple of axes indexes their sub-mesh row-major), ``P()``
passes an argument whole; outputs under ``P(axis)`` are allgathered.
``data_parallel_sharding`` and ``replicated_sharding`` (``:134``,
``:143``) give the :class:`NamedSharding` that cuts a global batch.
Under ``HVD_ANALYZE=1`` ``shard_step`` checks its step on the first call
(``analysis/hook.py``, as JAX's ``:95-127``).  Inside that check's trace
the axis functions here resolve from the trace's axis environment and
register nothing: ``axis`` and ``Mesh.axis`` give the line as index 0
sees it, ``Mesh.process_set`` and ``axes_process_set`` a set named by
its axes.
"""

from __future__ import annotations

from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree

from .. import core as _core
from ..analysis import graph_check as _gc
from ..analysis import hook as _analysis_hook
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
        order; ``make_mesh`` does it for each single axis).  Inside an
        analysis trace it is the axes' trace set, registering nothing."""
        key = tuple(axes)
        if _gc.active() is not None:
            return _gc.axes_set(key, self)
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
                if ps is not global_process_set:
                    ps.axes = key
                if st.topology.rank in ln:
                    mine = ps
            self._sets[key] = mine
        return self._sets[key]

    def axis(self, name: str) -> Axis:
        """``name`` as this rank sees it: size, index, line, set, group
        (inside an analysis trace, as rank 0 of the line sees it)."""
        if _gc.active() is not None:
            return _trace_axis(name, self)
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


def _trace_axis(name: str, mesh: Optional[Mesh] = None) -> Axis:
    """An axis inside an analysis trace: its size from ``mesh``, the axis
    environment or the runtime's meshes (``NameError`` for an axis none
    binds), seen from index 0."""
    size = _gc.axis_size(_gc.active(), name, mesh)
    return Axis(name, size, 0, tuple(range(size)),
                _gc.AxesSet((name,), size), None)


def axis(axis_name: str, mesh: Optional[Mesh] = None) -> Axis:
    """Resolve ``axis_name``: in ``mesh``, else in the most recent
    ``make_mesh`` that has it, else as the world's axis of
    ``core.mesh()``."""
    if _gc.active() is not None:
        return _trace_axis(axis_name, mesh)
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
    if _gc.active() is not None:
        return _gc.axes_set(axes, mesh)
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


def mark_sharded(param: torch.Tensor, *axes: str) -> torch.Tensor:
    """Record that ``param`` holds this rank's shard over ``axes`` (its
    gradient differs between the members of each, so it is never summed
    over them); returns ``param``."""
    param.hvd_sharded_axes = tuple(axes)
    return param


def sharded_axes(param: torch.Tensor) -> Tuple[str, ...]:
    """The axes :func:`mark_sharded` recorded on ``param`` (none)."""
    return getattr(param, "hvd_sharded_axes", ())


# -- shard_step ---------------------------------------------------------------

class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per leading dim, each
    None (whole), an axis name, or a tuple of axis names (their
    sub-mesh, row-major).  ``P()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding(NamedTuple):
    """A spec over a mesh (``jax.sharding.NamedSharding``): ``shard``
    cuts this rank's block out of a global tensor, ``gather`` puts the
    blocks of every rank back together."""
    mesh: Mesh
    spec: PartitionSpec

    def _cut(self, dim: int, entry) -> Tuple[int, int]:
        """(pieces, this rank's piece) of ``dim`` under ``entry``."""
        axes = _entry_axes(entry)
        pieces, index = 1, 0
        for a in axes:
            ax = self.mesh.axis(a)
            pieces, index = pieces * ax.size, index * ax.size + ax.index
        return pieces, index

    def shard(self, x):
        if not isinstance(x, torch.Tensor):
            return x
        for dim, entry in enumerate(self.spec):
            pieces, index = self._cut(dim, entry)
            if pieces > 1:
                if x.shape[dim] % pieces:
                    raise ValueError(
                        f"dim {dim} of {tuple(x.shape)} does not divide "
                        f"into {pieces} pieces over {entry!r}")
                x = x.chunk(pieces, dim)[index]
        return x

    def gather(self, x):
        from .. import ops as _ops
        if not isinstance(x, torch.Tensor):
            return x
        for dim, entry in reversed(list(enumerate(self.spec))):
            axes = _entry_axes(entry)
            if self._cut(dim, entry)[0] > 1:
                ps = self.mesh.process_set(*axes)
                x = _ops.allgather(x.movedim(dim, 0).contiguous(),
                                   process_set=ps).movedim(0, dim)
        return x


def _tree_map(fn, spec, tree):
    """``fn(spec, leaf)`` over ``tree``, with ``spec`` a tree prefix of
    it (JAX's rule): a PartitionSpec applies to every leaf below it."""
    if isinstance(spec, PartitionSpec):
        return _pytree.tree_map(lambda leaf: fn(spec, leaf), tree)
    if isinstance(spec, dict):
        if set(spec) != set(tree):
            raise ValueError(f"spec keys {sorted(spec)} do not match "
                             f"{sorted(tree)}")
        return type(tree)((k, _tree_map(fn, spec[k], v))
                          for k, v in tree.items())
    if isinstance(spec, (list, tuple)) and len(spec) == len(tree):
        return type(tree)(_tree_map(fn, s, t) for s, t in zip(spec, tree))
    raise ValueError(f"spec {spec!r} is no prefix of the tree")


def shard_step(fn: Callable, *, mesh: Optional[Mesh] = None, in_specs=None,
               out_specs=None, axis_name: Optional[str] = None,
               donate_argnums: Tuple[int, ...] = (),
               check_vma: bool = True) -> Callable:
    """The SPMD step wrapper: ``wrapper(*args)`` calls ``fn`` on this
    rank's pieces of ``args`` under ``in_specs`` (default: the first
    argument whole, the others split on dim 0 over ``axis_name``, the
    world's axis by default) and returns ``fn``'s outputs under
    ``out_specs`` (default ``P()``: as they are; ``P(axis)`` allgathers
    them).  Each spec is one ``P`` for an argument or output, or a tree
    of them matching its structure.

    ``donate_argnums`` and ``check_vma`` are accepted for the JAX
    signature and change nothing: PyTorch runs eagerly and frees a
    buffer when its last reference goes, so there is nothing to donate,
    and it has no varying-axes types to check.

    Under ``HVD_ANALYZE=1`` the first call of each arity (and analysis
    generation) first checks ``fn`` on this rank's pieces
    (``analysis/hook.py``: a ``make_fx`` trace on fake tensors, then the
    collective census, HVD1xx, and the memory and comm walks, with the
    mesh's axes and the specs; label ``shard_step:<fn>/<arity>``).  It
    never raises into the step."""
    del donate_argnums, check_vma
    analyzed_gen = {}  # arity -> analysis generation it was checked in

    def wrapper(*args, **kwargs):
        if kwargs:
            raise TypeError(
                "shard_step-wrapped functions take positional arguments "
                f"only (the specs are positional); pass {sorted(kwargs)} "
                f"positionally")
        m = mesh or _core.mesh()
        axis_ = axis_name or _core.mesh_axis()
        ins = in_specs
        if ins is None:
            ins = tuple(P(axis_) if i else P() for i in range(len(args)))
        local = _tree_map(lambda s, x: NamedSharding(m, s).shard(x),
                          tuple(ins), args)
        outs = out_specs if out_specs is not None else P()
        key = len(args)
        if _analysis_hook.enabled() and \
                analyzed_gen.get(key) != _analysis_hook.generation():
            analyzed_gen[key] = _analysis_hook.generation()
            _analyze_step(fn, m, ins, outs, args, local, key)
        out = fn(*local)
        return _tree_map(lambda s, x: NamedSharding(m, s).gather(x), outs,
                         out)

    return wrapper


def _analyze_step(fn, mesh: Mesh, ins, outs, args, local, arity: int
                  ) -> None:
    """``shard_step``'s ``HVD_ANALYZE`` check of ``fn`` on ``local``:
    the mesh's axes bind and declare the trace's; each tensor argument's
    spec feeds HVD402, and every axis a spec names counts as used."""
    leaves: List[Tuple] = []

    def leaf(spec, x):
        if isinstance(x, torch.Tensor):
            leaves.append((tuple(spec), tuple(x.shape),
                           str(x.dtype).rpartition(".")[2],
                           x.numel() * x.element_size()))
        return x

    _tree_map(leaf, tuple(ins), args)
    named = set()
    for spec in _pytree.tree_leaves(
            outs, is_leaf=lambda s: isinstance(s, PartitionSpec)):
        if isinstance(spec, PartitionSpec):
            for entry in spec:
                named.update(_entry_axes(entry))
    _analysis_hook.analyze_traceable(
        fn, local, label=f"shard_step:{getattr(fn, '__name__', 'fn')}/"
                         f"{arity}",
        axis_env=list(mesh.shape.items()),
        declared_axes=tuple(mesh.axis_names), once=False,
        spec_leaves=leaves, spec_axes=sorted(named))


def data_parallel_sharding(mesh: Optional[Mesh] = None,
                           axis_name: Optional[str] = None
                           ) -> NamedSharding:
    """Dim 0 split over the mesh axis: ``.shard(batch)`` is this rank's
    rows of a global batch."""
    return NamedSharding(mesh or _core.mesh(),
                         P(axis_name or _core.mesh_axis()))


def replicated_sharding(mesh: Optional[Mesh] = None) -> NamedSharding:
    return NamedSharding(mesh or _core.mesh(), P())
