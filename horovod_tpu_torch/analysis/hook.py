"""HVD_ANALYZE=1 trace-time hook: run the graph checker on a step's first
call.

Copied from ``horovod_tpu/analysis/hook.py``, with the graph source a
``make_fx`` trace (``analysis/graph_check.py``) in place of a jaxpr.
Opt-in via the environment (``HVD_ANALYZE=1``), wired into the three
places a step first becomes visible:

* ``parallel.shard_step`` — analyzes the per-rank step (model +
  collectives + optimizer reduction) on the first call's pieces of its
  arguments, once per wrapper instance/arity/generation, with the mesh
  and the specs;
* ``DistributedOptimizer`` — analyzes the gradient reduction
  (``_allreduce_list``) over the first reducing ``step()``'s gradients,
  once per optimizer instance/generation (``analyze_reduction``);
* the serve engine's adapter programs (``engine._maybe_analyze``) —
  once per program kind and batch rows (and chunk width), so serve
  programs get the same census + HVD1xx walk and must census zero
  collectives: a replica is self-contained.

Every analysis also runs the hvdmem liveness walk AND the hvdshard
communication walk over the SAME traced graph (memplan.py /
shardplan.py — no second trace): the memory census attaches as
``GraphReport.memory`` (HVD300/302/303/304 findings merged,
``Timeline.memory_census`` charts it) and the comm census as
``GraphReport.comm`` (HVD401-404 findings merged,
``Timeline.comm_census`` charts it).

Findings are logged as warnings, the report is appended to
``core._state.analysis_reports`` (``core.analysis_reports()``), and the
collective census lands in the active timeline as counter events
(``Timeline.collective_census``).  The trace runs on fake tensors: it
launches no kernel and contacts no peer.  The hook NEVER raises into
training or serving code: any analysis failure is logged and swallowed —
the loudly-but-gracefully contract of the HVD100 rule.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from typing import Any, Optional, Sequence, Tuple

from ..utils import get_logger

_lock = threading.Lock()
_analyzed: set = set()
_generation = 0
_instance_seq = itertools.count(1)  # distinguishes same-named instances


def enabled() -> bool:
    return os.environ.get("HVD_ANALYZE", "") not in ("", "0", "false",
                                                     "False")


def generation() -> int:
    """Monotonic analysis generation, bumped by ``reset()``.  Integration
    sites (shard_step, DistributedOptimizer) remember the generation at which
    they analyzed, so an elastic re-init (which calls reset) re-analyzes
    the programs that recompile in the new world."""
    return _generation


def reset() -> None:
    """Start a new analysis generation (new world / test isolation).
    Called by ``core.init`` so every (re)initialized runtime re-analyzes
    its first call."""
    global _generation
    with _lock:
        _generation += 1
        _analyzed.clear()


def analyze_traceable(fn, args: Sequence[Any],
                      kwargs: Optional[dict] = None, *,
                      label: str,
                      declared_axes: Optional[Sequence[str]] = None,
                      axis_env: Optional[Sequence[Tuple[str, int]]] = None,
                      once: bool = True,
                      spec_leaves: Sequence[Tuple] = (),
                      spec_axes: Sequence[str] = ()):
    """Check ``fn(*args)``; returns the GraphReport (or None when
    disabled/already done/failed).  ``once=True`` dedupes globally by
    ``label``; callers that own their dedup (shard_step's per-wrapper
    generation tracking, which labels aren't unique enough for) pass
    ``once=False``.  ``axis_env`` is the mesh's ``(axis, size)`` pairs:
    it binds the trace's axes and seeds the hvdshard walk's declared
    axes; ``spec_leaves`` / ``spec_axes`` are shard_step's specs
    (``shardplan.measure_graph_comm``).  Safe to call on the hot path."""
    if not enabled():
        return None
    if once:
        with _lock:
            if label in _analyzed:
                return None
            _analyzed.add(label)
    log = get_logger()
    try:
        from . import graph_check
        report = graph_check.check_step_fn(
            fn, args, kwargs, axis_env=axis_env,
            declared_axes=declared_axes, label=label)
    except Exception as e:  # never break training over analysis
        log.warning("HVD_ANALYZE: analysis of %s failed: %s: %s",
                    label, type(e).__name__, e)
        return None
    # hvdmem ride-along: liveness-walk the SAME traced graph (no second
    # trace) — peak live bytes, per-op allocation breakdown, rules
    # HVD300/302/303/304.
    # The graph goes with the walks: a published report holds no tensor
    # (the graph's constants are the step's real weights).
    gm = vars(report).pop("_graph", None)
    if gm is not None:
        try:
            from . import memplan
            mem = memplan.measure_graph(gm, label=label)
            report.memory = mem.to_dict()
            report.findings.extend(mem.findings)
        except Exception as e:  # analysis must never break training
            log.warning("HVD_ANALYZE: memory analysis of %s failed: "
                        "%s: %s", label, type(e).__name__, e)
        # hvdshard ride-along: communication walk of the SAME trace —
        # comm census, budget and axis rules HVD401-404.
        try:
            from . import shardplan
            comm = shardplan.measure_graph_comm(
                gm, label=label,
                axis_sizes=dict(axis_env) if axis_env else None,
                spec_leaves=spec_leaves, spec_axes=spec_axes)
            report.comm = comm.to_dict()
            report.findings.extend(comm.findings)
        except Exception as e:  # analysis must never break training
            log.warning("HVD_ANALYZE: comm analysis of %s failed: "
                        "%s: %s", label, type(e).__name__, e)
    _publish(report, log)
    return report


def _publish(report, log) -> None:
    for f in report.findings:
        log.warning("HVD_ANALYZE: %s", f.format())
    if report.census:
        log.info("HVD_ANALYZE: %s collective census: %s%s",
                 report.label, json.dumps(report.census, sort_keys=True),
                 f" ({report.dynamic_loops} dynamic loop(s) counted once)"
                 if report.dynamic_loops else "")
    try:
        from .. import core as _core
        st = _core._state
        st.analysis_reports.append(report)
        tl = st.timeline
        if tl is not None and report.census:
            tl.collective_census(report.label, report.census)
        mem = getattr(report, "memory", None)
        if tl is not None and mem:
            tl.memory_census(report.label, mem)
        comm = getattr(report, "comm", None)
        if tl is not None and comm:
            tl.comm_census(report.label, comm)
    except Exception as e:  # pragma: no cover - publication is best-effort
        log.warning("HVD_ANALYZE: could not publish report: %s", e)


def analyze_reduction(reduce_fn, grads, label: str):
    """``DistributedOptimizer``'s counterpart of JAX's ``wrap_optimizer``:
    check the gradient reduction ``reduce_fn(grads)`` under the world's
    axes, once per call (the optimizer owns its per-instance,
    per-generation dedup).  The axes are the world's (``"hvd"`` of size
    1 before ``init``) and those of every mesh the runtime made.  The
    label is the optimizer's ``DistributedOptimizer:<n>``, numbered from
    ``next_instance``."""
    from .. import core as _core
    env = {"hvd": 1}
    if _core.is_initialized():
        env = {_core.mesh_axis(): _core.size()}
        for m in _core._state.meshes:
            for axis, size in m.shape.items():
                env.setdefault(axis, int(size))
    env = list(env.items())
    return analyze_traceable(reduce_fn, (list(grads),), label=label,
                             axis_env=env,
                             declared_axes=[a for a, _ in env], once=False)


def next_instance(label: str = "DistributedOptimizer") -> str:
    """A label no other instance shares (never an ``id()``, which the
    allocator recycles)."""
    return f"{label}:{next(_instance_seq)}"
