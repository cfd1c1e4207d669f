"""Trace-level collective-consistency checker + collective census, over a
``make_fx`` graph.

Port of ``horovod_tpu/analysis/jaxpr_check.py:48-310``, with the step's
graph source changed from ``jax.make_jaxpr`` to
``torch.fx.experimental.proxy_tensor.make_fx(fn, tracing_mode="fake")``
and ``GraphReport`` for ``JaxprReport``.  The trace runs on fake
tensors: no kernel is launched, no byte is allocated on the card and no
peer is contacted.  ``torch.export`` is stricter and refuses the port's
host-side Python, so it is not the source.

The reference framework discovers mismatched collective sequences at
RUNTIME, in the coordinator's negotiation (controller.cc
ComputeResponseList).  Here a step's collectives are visible in its
graph before it runs, so the same contract is checked statically: walk
the graph — the subgraphs of ``torch.cond`` and ``while_loop`` included
— and

* verify every collective names an axis the deployment declares
  (HVD101);
* flag ``torch.cond`` branches whose ordered collective signatures
  (kind, axes, shapes, dtypes) differ (HVD102);
* build the per-step **collective census**: count and payload bytes per
  collective.  A Python loop unrolls in the trace, so each trip counts;
  a ``while_loop`` body counts once and adds to ``dynamic_loops``.

**Trace mode of the collective layer.**  While a check runs, a
thread-local flag (``active()``) holds the axis environment — a
thread-local and not a ``ContextVar``, because Dynamo, which traces the
branches of ``torch.cond``, reads the one and not the other — and each
entry
point of ``ops`` (``allreduce``, ``grouped_allreduce``,
``_fused_allreduce``, ``allgather``, ``broadcast``, ``alltoall``,
``reducescatter``) and the ring's P2P rotation (``parallel/ring.py``)
emit one op this package owns, ``hvd_analyze::collective(tensors, kind,
axes, group_size)``, instead of calling the eager engine: no
negotiation, no host read of sizes.  Its fake implementation gives the
output's shape and dtype; its real one raises, since it only runs inside
a trace.  A process set maps to mesh axes: the global set (and any set
without axes) to the world's axis (``core.mesh_axis()``, ``"hvd"`` of
size 1 before ``init``, or the size the axis environment gives it), a
set a mesh made (``parallel.Mesh.process_set`` / ``parallel.axis``) to
its axes.  So a world of one censuses a mesh of 2 x 4, as JAX's
``axis_env`` does.  An axis that neither the environment nor a mesh
binds raises ``NameError("unbound axis name: ...")``, which the checker
reports as HVD101.  The census also reads the ``c10d.*`` /
``_c10d_functional.*`` nodes of code that calls ``torch.distributed``
directly; their group size comes from the group.

A step that fails to trace is reported as HVD100: the checker never
raises on user programs, so the ``HVD_ANALYZE=1`` hook can run
mid-training.  The step's arguments enter the trace as fake tensors.
A tensor it closes over stays real, and ``make_fx`` runs an op whose
tensors are all such for real (a view of a weight, say); so the trace
refuses an op that would write one (``_NoRealWrites``), and the step
fails to trace (HVD100) instead of changing the caller's state.  Not
caught: a write inside a ``torch.cond`` branch, which Dynamo traces on
its own.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .findings import Finding

#: ``torch.distributed``'s ops as they enter a graph: (kind, index of the
#: payload argument).
_C10D = {
    "allreduce_": ("allreduce", 0),
    "allreduce_coalesced_": ("allreduce", 0),
    "allgather_": ("allgather", 1),
    "_allgather_base_": ("allgather", 1),
    "allgather_into_tensor_coalesced_": ("allgather", 1),
    "broadcast_": ("broadcast", 0),
    "reduce_scatter_": ("reducescatter", 1),
    "_reduce_scatter_base_": ("reducescatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reducescatter", 1),
    "alltoall_": ("alltoall", 1),
    "alltoall_base_": ("alltoall", 1),
    "send": ("ppermute", 0),
}
_C10D_FUNCTIONAL = {
    "all_reduce": ("allreduce", 0),
    "all_reduce_coalesced": ("allreduce", 0),
    "all_gather_into_tensor": ("allgather", 0),
    "all_gather_into_tensor_coalesced": ("allgather", 0),
    "reduce_scatter_tensor": ("reducescatter", 0),
    "reduce_scatter_tensor_coalesced": ("reducescatter", 0),
    "all_to_all_single": ("alltoall", 0),
    "broadcast": ("broadcast", 0),
}


# -- trace mode -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceEnv:
    """The axes a trace binds: ``axis_sizes`` (the axis environment),
    and the world's axis with its size (the global process set's)."""

    axis_sizes: Dict[str, int]
    world_axis: str
    world_size: int


_LOCAL = threading.local()


def active() -> Optional[TraceEnv]:
    """The axis environment of the trace this thread is running, or None
    on the real path (one attribute read)."""
    return getattr(_LOCAL, "env", None)


class AxesSet:
    """The process set of mesh axes inside a trace: what
    ``Mesh.process_set`` / ``parallel.axis`` / ``axes_process_set``
    return while a trace is active.  Only the trace mode of ``ops`` reads
    it."""

    def __init__(self, axes: Sequence[str], size: int):
        self.axes = tuple(axes)
        self.ranks = list(range(int(size)))

    def __repr__(self):
        return f"AxesSet({self.axes}, size={len(self.ranks)})"


def axis_size(env: TraceEnv, name: str, mesh=None) -> int:
    """``name``'s size in a trace: from ``mesh`` when it has the axis,
    else the axis environment, else the meshes the runtime made, else the
    world's; ``NameError`` for an axis nothing binds (JAX's unbound axis
    name)."""
    shape = getattr(mesh, "shape", None) or {}
    if name in shape:
        return int(shape[name])
    if name in env.axis_sizes:
        return int(env.axis_sizes[name])
    from .. import core as _core
    for m in reversed(_core._state.meshes):
        if name in m.shape:
            return int(m.shape[name])
    if name == env.world_axis:
        return env.world_size
    raise NameError(f"unbound axis name: {name}")


def axes_set(axes: Sequence[str], mesh=None) -> AxesSet:
    env = active()
    return AxesSet(axes, math.prod(axis_size(env, a, mesh) for a in axes))


def _set_axes(env: TraceEnv, process_set) -> Tuple[Tuple[str, ...], int]:
    """(axes, group size) of a collective over ``process_set``."""
    axes = getattr(process_set, "axes", None)
    ranks = getattr(process_set, "ranks", None)
    if axes:
        return tuple(axes), len(ranks)
    size = env.axis_sizes.get(env.world_axis, env.world_size)
    if ranks is not None and len(ranks) != env.world_size:
        size = len(ranks)
    return (env.world_axis,), int(size)


_OP = []


def _collective_op():
    """``hvd_analyze::collective``, defined at its first use (the
    package imports no torch at module level)."""
    if not _OP:
        import torch

        @torch.library.custom_op(
            "hvd_analyze::collective", mutates_args=(),
            schema="(Tensor[] tensors, str kind, str axes, int group_size)"
                   " -> Tensor[]")
        def collective(tensors, kind, axes, group_size):
            raise RuntimeError(
                "hvd_analyze::collective runs only inside an analysis "
                "trace (graph_check.check_step_fn)")

        @collective.register_fake
        def _(tensors, kind, axes, group_size):
            outs = []
            for t in tensors:
                rows = t.shape[0] if t.dim() else 1
                if kind == "allgather":
                    rows = rows * group_size
                elif kind == "reducescatter":
                    rows = -(-rows // group_size)
                shape = (rows,) + tuple(t.shape[1:]) if t.dim() else ()
                outs.append(t.new_empty(shape))
            return outs

        def setup_context(ctx, inputs, output):
            ctx.args = inputs[1:]
            ctx.rows = [t.shape[0] if t.dim() else None for t in inputs[0]]

        def backward(ctx, grads):
            # The transposes of the port's differentiable collectives; an
            # allreduce passes its cotangent through (the eager one is an
            # in-place reduction autograd does not see), a broadcast's
            # input is detached.
            kind, axes, size = ctx.args
            inverse = {"allgather": "reducescatter",
                       "reducescatter": "allgather", "alltoall": "alltoall",
                       "ppermute": "ppermute"}.get(kind)
            if kind == "broadcast":
                return None, None, None, None
            if inverse is None:
                return list(grads), None, None, None
            outs = collective([g.contiguous() for g in grads], inverse,
                              axes, size)
            return [o if r is None or o.shape[0] == r else o[:r]
                    for o, r in zip(outs, ctx.rows)], None, None, None

        collective.register_autograd(backward, setup_context=setup_context)
        _OP.append(collective)
    return _OP[0]


def emit(kind: str, tensors, process_set=None):
    """The trace-mode form of a collective: one ``hvd_analyze::collective``
    node over ``tensors`` (a tensor or a list of them), whose outputs —
    of the collective's shapes, dtypes and device — are returned in the
    same form.  ``allgather`` assumes every member's dim 0 equals this
    one's, as JAX's ``all_gather`` does."""
    axes, size = _set_axes(active(), process_set)
    single = not isinstance(tensors, (list, tuple))
    ts = [tensors] if single else list(tensors)
    outs = _collective_op()(ts, kind, ",".join(axes), size)
    return outs[0] if single else list(outs)


def start_trace(axis_env: Optional[Sequence[Tuple[str, int]]] = None
                ) -> Optional[TraceEnv]:
    """Enter trace mode on this thread with ``axis_env``; returns the
    environment it replaced, for ``end_trace``."""
    from .. import core as _core
    if _core.is_initialized():
        world_axis, world_size = _core.mesh_axis(), _core.size()
    else:
        world_axis, world_size = "hvd", 1
    sizes = {str(a): int(s) for a, s in (axis_env or ())}
    # The op is defined before make_fx runs: Dynamo, tracing a cond
    # branch, cannot define one.
    _collective_op()
    prev = active()
    _LOCAL.env = TraceEnv(sizes, world_axis,
                          sizes.get(world_axis, world_size))
    return prev


def end_trace(prev: Optional[TraceEnv]) -> None:
    _LOCAL.env = prev


# -- report -----------------------------------------------------------------------

@dataclasses.dataclass
class GraphReport:
    """Result of one program check: findings + the collective census."""

    label: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    # collective -> {"count": executions (loop-unrolled), "bytes":
    # payload-in bytes across those executions}
    census: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    dynamic_loops: int = 0   # while_loops whose trip count is unknown
    # hvdmem liveness walk of the same graph (memplan.MemReport.to_dict();
    # attached by the HVD_ANALYZE hook).
    memory: Optional[dict] = None
    # hvdshard communication walk of the same graph
    # (shardplan.CommReport.to_dict(); attached by the hook).
    comm: Optional[dict] = None
    # Trace wall time (ms), not part of to_dict().
    trace_ms: float = 0.0

    def ok(self) -> bool:
        return not self.findings

    def total_collectives(self) -> int:
        return sum(c["count"] for c in self.census.values())

    def total_bytes(self) -> int:
        return sum(c["bytes"] for c in self.census.values())

    def to_dict(self) -> dict:
        return {"label": self.label,
                "findings": [f.to_dict() for f in self.findings],
                "census": self.census,
                "dynamic_loops": self.dynamic_loops,
                "memory": self.memory,
                "comm": self.comm}


# -- graph plumbing -----------------------------------------------------------------

def _tensors(val) -> list:
    """The tensors in a node's ``meta["val"]`` (nested tuples / lists)."""
    import torch
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (tuple, list)):
        return [t for v in val for t in _tensors(v)]
    return []


def tensor_bytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def _arg_tensors(node, index: int) -> list:
    """The tensors of a node's ``index``-th argument (a node or a list of
    nodes), from their ``meta["val"]``."""
    if index >= len(node.args):
        return []
    arg = node.args[index]
    items = arg if isinstance(arg, (list, tuple)) else [arg]
    out = []
    for a in items:
        if hasattr(a, "meta"):
            out += _tensors(a.meta.get("val"))
    return out


def _group_size(node, gm) -> int:
    """The group size of a ``torch.distributed`` node: its process group
    (a ``get_attr`` of the graph), its ``group_size`` argument, or its
    group's name."""
    import torch.distributed as dist
    for a in node.args:
        if hasattr(a, "op") and a.op == "get_attr":
            obj = getattr(gm, a.target, None)
            size = getattr(obj, "size", None)
            if callable(size):
                try:
                    return int(size())
                except Exception:
                    pass
    schema = getattr(node.target, "_schema", None)
    names = [a.name for a in schema.arguments] if schema is not None else []
    for name, a in zip(names, node.args):
        if name == "group_size" and isinstance(a, int):
            return a
        if name == "group_name" and isinstance(a, str):
            try:
                return dist.distributed_c10d._resolve_process_group(
                    a).size()
            except Exception:
                pass
    return dist.get_world_size() if dist.is_initialized() else 1


def collective_of(node, gm) -> Optional[Tuple[str, Tuple[str, ...], int,
                                               list]]:
    """``(kind, axes, group size, payload tensors)`` when ``node`` is a
    collective, else None."""
    if node.op != "call_function":
        return None
    schema = getattr(node.target, "_schema", None)
    ns, _, name = (schema.name if schema is not None else "").partition(
        "::")
    if ns == "hvd_analyze" and name == "collective":
        kind, axes, size = node.args[1], node.args[2], node.args[3]
        return (kind, tuple(a for a in axes.split(",") if a), int(size),
                _arg_tensors(node, 0))
    table = _C10D if ns == "c10d" else \
        _C10D_FUNCTIONAL if ns == "_c10d_functional" else None
    if table is None or name not in table:
        return None
    kind, index = table[name]
    size = _group_size(node, gm)
    import torch.distributed as dist
    from .. import core as _core
    world = _core.mesh_axis() if _core.is_initialized() else "hvd"
    whole = not dist.is_initialized() or size == dist.get_world_size()
    return kind, ((world,) if whole else ()), size, _arg_tensors(node,
                                                                  index)


def subgraphs(node, gm) -> Tuple[str, list]:
    """``("cond" | "while" | "other", [subgraph modules])`` of a
    higher-order node."""
    import torch
    mods = []
    for a in node.args:
        if hasattr(a, "op") and a.op == "get_attr":
            sub = getattr(gm, a.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                mods.append(sub)
    name = getattr(node.target, "__name__", str(node.target))
    if name == "cond":
        return "cond", mods
    if name in ("while_loop", "while_loop_stack_output"):
        return "while", mods
    return "other", mods


def payload_bytes(tensors) -> int:
    return sum(tensor_bytes(t) for t in tensors)


def _signature(gm) -> Tuple:
    """Ordered collective signature of a (sub)graph: the tuple the
    reference's negotiation would have diffed across ranks.  A Python
    loop is unrolled in the trace, so trips count; a ``while_loop`` body
    contributes its signature once."""
    sig: List[Tuple] = []
    for node in gm.graph.nodes:
        c = collective_of(node, gm)
        if c is not None:
            kind, axes, _, ts = c
            sig.append((kind, axes, tuple(
                (tuple(t.shape), str(t.dtype).rpartition(".")[2])
                for t in ts)))
        elif node.op == "call_function":
            for sub in subgraphs(node, gm)[1]:
                sig.extend(_signature(sub))
    return tuple(sig)


def _fmt_sig(sig: Tuple) -> str:
    if not sig:
        return "(no collectives)"
    return "; ".join(
        f"{name}[{','.join(axes) or '-'}]"
        f"({'+'.join(f'{s}{d}' for s, d in shapes) or '-'})"
        for name, axes, shapes in sig)


# -- the walker ---------------------------------------------------------------------

class _Walker:
    def __init__(self, report: GraphReport):
        self.report = report

    def emit(self, rule: str, message: str) -> None:
        self.report.findings.append(Finding(
            rule=rule, path=self.report.label, line=0, col=0,
            message=message, source="graph"))

    def walk(self, gm, declared) -> None:
        for node in gm.graph.nodes:
            c = collective_of(node, gm)
            if c is not None:
                kind, axes, _, ts = c
                entry = self.report.census.setdefault(
                    kind, {"count": 0, "bytes": 0})
                entry["count"] += 1
                entry["bytes"] += payload_bytes(ts)
                if declared is not None:
                    for axis in axes:
                        if axis not in declared:
                            self.emit(
                                "HVD101",
                                f"collective '{kind}' reduces over axis "
                                f"'{axis}' but the enclosing mesh only "
                                f"declares {sorted(declared)}")
                continue
            if node.op != "call_function":
                continue
            kind, subs = subgraphs(node, gm)
            if kind == "cond":
                self._walk_cond(subs, declared)
            elif kind == "while":
                self.report.dynamic_loops += 1
                for sub in subs:
                    self.walk(sub, declared)
            else:
                for sub in subs:
                    self.walk(sub, declared)

    def _walk_cond(self, branches, declared) -> None:
        sigs = [_signature(b) for b in branches]
        if sigs and any(s != sigs[0] for s in sigs[1:]):
            rendered = "; vs ".join(
                f"branch {i}: {_fmt_sig(s)}" for i, s in enumerate(sigs))
            self.emit(
                "HVD102",
                f"torch.cond branches disagree on their collective "
                f"signature — {rendered}.  If the predicate diverges "
                f"across ranks this deadlocks exactly like a Horovod "
                f"negotiation mismatch")
        # Census counts every branch's collectives (static upper bound:
        # which branch runs is a runtime property).
        for b in branches:
            self.walk(b, declared)


# -- public API ---------------------------------------------------------------------

def check_graph(gm, declared_axes: Optional[Sequence[str]] = None,
                label: str = "<graph>") -> GraphReport:
    """Check an already-traced graph.  ``declared_axes=None`` means "no
    declaration info": the axis check is off."""
    report = GraphReport(label=label)
    declared = frozenset(declared_axes) if declared_axes is not None \
        else None
    _Walker(report).walk(gm, declared)
    return report


def _no_real_writes():
    """A dispatch mode, entered inside the traced function, that raises
    on an op writing a tensor that is not fake (module docstring)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    import torch

    class _NoRealWrites(TorchDispatchMode):
        supports_higher_order_operators = True

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            schema = getattr(func, "_schema", None)
            for i, arg in enumerate(schema.arguments if schema is not None
                                    and schema.is_mutable else ()):
                if arg.alias_info is None or not arg.alias_info.is_write:
                    continue
                val = args[i] if i < len(args) else kwargs.get(arg.name)
                for t in val if isinstance(val, (list, tuple)) else [val]:
                    if isinstance(t, torch.Tensor) and \
                            not isinstance(t, FakeTensor):
                        raise RuntimeError(
                            f"the step writes a tensor it closes over "
                            f"({func}); the trace does not run it")
            return func(*args, **kwargs)

    return _NoRealWrites()


def trace(fn: Callable, args: Sequence[Any] = (),
          kwargs: Optional[dict] = None,
          axis_env: Optional[Sequence[Tuple[str, int]]] = None):
    """``make_fx(fn, tracing_mode="fake")`` over ``args`` in trace mode:
    the graph module, each of whose nodes carries its fake value in
    ``meta["val"]``.  Raises what the trace raises."""
    from torch.fx.experimental.proxy_tensor import make_fx
    kw = kwargs or {}

    def guarded(*a):
        with _no_real_writes():
            return fn(*a, **kw)

    prev = start_trace(axis_env)
    try:
        return make_fx(guarded, tracing_mode="fake",
                       _allow_non_fake_inputs=True)(*args)
    finally:
        end_trace(prev)


def check_step_fn(fn: Callable,
                  args: Sequence[Any] = (),
                  kwargs: Optional[dict] = None,
                  *,
                  axis_env: Optional[Sequence[Tuple[str, int]]] = None,
                  declared_axes: Optional[Sequence[str]] = None,
                  label: Optional[str] = None) -> GraphReport:
    """Trace ``fn(*args, **kwargs)`` (``trace``) and check it.

    ``axis_env`` binds axis sizes for the trace (``[("hvd", 8)]``);
    ``declared_axes`` is the set the deployment actually provides — it
    defaults to the ``axis_env`` names, so pass it explicitly to detect a
    collective over an axis the mesh won't carry.  A module's parameters
    go in as arguments through ``torch.func.functional_call``.

    Never raises on the user's program: a trace failure comes back as an
    HVD100 finding (an unbound axis name as HVD101), so the
    ``HVD_ANALYZE=1`` hook is safe mid-training.
    """
    import time
    name = label or getattr(fn, "__name__", None) or "step"
    t0 = time.perf_counter()
    try:
        gm = trace(fn, args, kwargs, axis_env)
    except Exception as e:  # loud-but-graceful: report, never crash
        report = GraphReport(label=name)
        # Only the literal unbound-axis message is an HVD101; any other
        # failure (an ordinary NameError from a typo'd variable, even one
        # named like `axis_scale`) is a generic HVD100.
        if isinstance(e, NameError) and "unbound axis" in str(e).lower():
            report.findings.append(Finding(
                rule="HVD101", path=name, line=0, col=0, source="graph",
                message=f"trace failed on an unbound axis name — a "
                        f"collective references an axis no mesh "
                        f"declares: {e}"))
        else:
            report.findings.append(Finding(
                rule="HVD100", path=name, line=0, col=0, source="graph",
                message=f"step function failed to trace: "
                        f"{type(e).__name__}: {e}"))
        report.trace_ms = (time.perf_counter() - t0) * 1e3
        return report
    declared: Optional[Sequence[str]] = declared_axes
    if declared is None and axis_env:
        declared = [a for a, _ in axis_env]
    report = check_graph(gm, declared_axes=declared, label=name)
    report.trace_ms = (time.perf_counter() - t0) * 1e3
    # The traced graph, for the memory and comm walks of the hook (one
    # trace for all three); not part of to_dict().
    report._graph = gm
    return report
