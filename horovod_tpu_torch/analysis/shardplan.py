"""hvdshard — communication-plan analysis (HVD4xx).

Copied from ``horovod_tpu/analysis/shardplan.py``: the walk
(``shardplan.py:159-231`` and ``:288-630``) over a ``make_fx`` graph
(``analysis/graph_check.py``) in place of a jaxpr, the replica plan's
go/no-go, and the ``--comm`` AST pass's HVD404.

* **The communication walk** (``measure_graph_comm`` /
  ``measure_step_fn_comm``): the census ``by_primitive`` / ``by_axis``
  of every collective node — payload bytes, and wire bytes = payload x
  group size (a ``ppermute`` hop moves its payload once) — with
  ``axes_declared`` (the mesh's) and ``axes_used`` (named by a
  collective or by ``shard_step``'s specs).  Rules: HVD401 (wire bytes
  past ``HVD_COMM_BUDGET_BYTES``), HVD402 (a ``P()`` argument of at
  least ``REPLICATED_MIN_BYTES`` whose dim 0 an axis its sharded peers
  use divides — read from ``shard_step``'s ``in_specs``: the port has no
  compiler shardings), HVD403 (a collective over an axis the mesh does
  not declare) and HVD404 (a mesh axis of size > 1 that no collective
  and no spec names).
* **The replica plan** (``check_replica_plan``): the static go/no-go
  combining hvdmem's HVD302 pool-vs-budget verdict with HVD401 on the
  sequence-parallel ring's per-prefill K/V rotation, exposed as
  ``plan_go`` / ``plan_findings`` on ``kv_stats`` / ``healthz``.
* **The ``--comm`` AST pass** (HVD404): reads the port's spellings of a
  collective over an axis besides ``P(...)`` specs and ``axis_name=``:
  ``reduce_axes=`` (``DistributedOptimizer``), ``axis_names=`` /
  ``expert_axis=``, and the axis arguments of ``mesh.process_set`` /
  ``lines`` / ``line`` / ``axis`` / ``group``, ``axes_process_set`` and
  ``mark_sharded``.

Left out (ROADMAP.md): HVD400, implicit resharding, in the walk and in
the AST pass — torch makes no implicit reshard: ``NamedSharding.shard``
/ ``gather`` move data only where the code calls them; and the
ICI / DCN split (the cross-host sub-budget
``HVD_COMM_DCN_BUDGET_BYTES``, HVD403's mixed-fabric arm) — no
configuration of the port crosses hosts.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, \
    Tuple

from .findings import Finding, rule_selected

#: Floor for HVD402: a replicated bias vector next to a sharded batch is
#: the normal data-parallel layout; a replicated multi-MB operand whose
#: leading dim a declared axis divides evenly is a missed sharding.
REPLICATED_MIN_BYTES = 1 << 20


def comm_budget_bytes() -> Optional[int]:
    """Per-step wire-byte budget HVD401 measures against
    (``HVD_COMM_BUDGET_BYTES``); None (unset/malformed) disables the
    check.  Read per call like the sibling hvdmem knobs so a bad value
    degrades to "no budget" instead of breaking import."""
    try:
        env = os.environ.get("HVD_COMM_BUDGET_BYTES", "")
        return int(env) if env else None
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CommReport:
    """Result of one communication walk (or of a replica plan's comm
    half)."""

    label: str
    # collective -> {"count": executions (loop-unrolled), "bytes": payload
    # bytes in, "wire_bytes": payload x group size}
    by_primitive: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    # axis name -> {"size", "count", "wire_bytes"}: a multi-axis
    # collective's wire bytes charge each axis it names (an upper bound
    # per axis, exact for single-axis collectives).
    by_axis: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    total_wire_bytes: int = 0
    axes_declared: Dict[str, int] = dataclasses.field(default_factory=dict)
    axes_used: Set[str] = dataclasses.field(default_factory=set)
    dynamic_loops: int = 0
    budget_bytes: Optional[int] = None
    headroom_bytes: Optional[int] = None
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "total_wire_bytes": int(self.total_wire_bytes),
            "budget_bytes": self.budget_bytes,
            "headroom_bytes": self.headroom_bytes,
            "dynamic_loops": int(self.dynamic_loops),
            "axes_declared": dict(sorted(self.axes_declared.items())),
            "axes_used": sorted(self.axes_used),
            "by_primitive": {k: dict(v)
                             for k, v in sorted(self.by_primitive.items())},
            "by_axis": {k: dict(v)
                        for k, v in sorted(self.by_axis.items())},
        }


# ---------------------------------------------------------------------------
# Graph communication walk
# ---------------------------------------------------------------------------

class _CommWalker:
    """One pass over a graph accumulating the communication census and
    HVD403 findings."""

    def __init__(self, report: CommReport):
        self.report = report

    def _emit(self, rule: str, message: str) -> None:
        self.report.findings.append(Finding(
            rule=rule, path=self.report.label, line=0, col=0,
            message=message, source="comm"))

    def _record(self, kind: str, axes: Tuple[str, ...], group: int,
                payload: int) -> None:
        # Wire bytes: payload x communicator group size (the all-gather/
        # reduce upper bound); a ppermute rotates the payload one hop, so
        # the group size does not multiply.
        wire = payload * (1 if kind == "ppermute" else group)
        entry = self.report.by_primitive.setdefault(
            kind, {"count": 0, "bytes": 0, "wire_bytes": 0})
        entry["count"] += 1
        entry["bytes"] += payload
        entry["wire_bytes"] += wire
        self.report.total_wire_bytes += wire
        declared = self.report.axes_declared
        for axis in axes:
            self.report.axes_used.add(axis)
            ax = self.report.by_axis.setdefault(
                axis, {"size": int(declared.get(
                    axis, group if len(axes) == 1 else 1)),
                       "count": 0, "wire_bytes": 0})
            ax["count"] += 1
            ax["wire_bytes"] += wire
            # HVD403: the axis is not on the mesh — the static form of
            # reducing over a process set that does not exist in this
            # deployment.
            if declared and axis not in declared:
                self._emit(
                    "HVD403",
                    f"collective '{kind}' communicates over axis "
                    f"'{axis}' but the mesh only declares "
                    f"{sorted(declared)} — no process set carries that "
                    f"axis in this deployment")

    def walk(self, gm) -> None:
        from .graph_check import collective_of, payload_bytes, subgraphs
        for node in gm.graph.nodes:
            c = collective_of(node, gm)
            if c is not None:
                kind, axes, group, ts = c
                self._record(kind, axes, group, payload_bytes(ts))
                continue
            if node.op != "call_function":
                continue
            kind, subs = subgraphs(node, gm)
            if kind == "while":
                self.report.dynamic_loops += 1
            for sub in subs:
                self.walk(sub)


def _spec_axes(spec) -> Set[str]:
    out: Set[str] = set()
    for entry in spec or ():
        if entry is None:
            continue
        out.update((entry,) if isinstance(entry, str) else tuple(entry))
    return out


def measure_graph_comm(gm, *, label: str = "<graph>",
                       axis_sizes: Optional[Dict[str, int]] = None,
                       spec_leaves: Sequence[Tuple] = (),
                       spec_axes: Iterable[str] = (),
                       budget_bytes: Optional[int] = None,
                       replicated_min_bytes: int = REPLICATED_MIN_BYTES
                       ) -> CommReport:
    """Communication-walk an already-traced graph
    (``graph_check.trace``).

    ``axis_sizes`` are the mesh's axes (``shard_step`` passes its mesh's
    shape, the optimizer hook the world's axes).  ``spec_leaves`` are
    ``(spec, shape, dtype, bytes)`` of each tensor argument under
    ``shard_step``'s ``in_specs`` (HVD402 reads them); ``spec_axes`` are
    the axes its specs name besides.  ``budget_bytes`` defaults to
    ``HVD_COMM_BUDGET_BYTES``; when known, HVD401 fires on overshoot."""
    report = CommReport(label=label)
    for axis, size in (axis_sizes or {}).items():
        report.axes_declared[str(axis)] = int(size)
    walker = _CommWalker(report)
    walker.walk(gm)
    report.axes_used.update(spec_axes)
    peers: Set[str] = set()
    for spec, _, _, _ in spec_leaves:
        peers |= _spec_axes(spec)
    report.axes_used |= peers

    # HVD402: a large fully-replicated argument riding next to sharded
    # peers — an axis they use that divides its leading dim would shard
    # it instead of handing every rank a copy.
    for spec, shape, dtype, b in spec_leaves:
        if _spec_axes(spec) or b < replicated_min_bytes or not shape:
            continue
        for axis in sorted(peers):
            size = report.axes_declared.get(axis, 0)
            if size > 1 and shape[0] % size == 0:
                walker._emit(
                    "HVD402",
                    f"replicated operand {dtype}{tuple(shape)} ({b} "
                    f"bytes) rides next to peers sharded over '{axis}' "
                    f"(size {size}, which divides dim 0) — sharding it "
                    f"saves {b - b // size} bytes per device")
                break

    # HVD404: declared-but-never-communicated axes — cards reserved for
    # a parallelism dimension the program never exercises.
    for axis, size in sorted(report.axes_declared.items()):
        if size > 1 and axis not in report.axes_used:
            walker._emit(
                "HVD404",
                f"mesh axis '{axis}' (size {size}) is never named by a "
                f"collective or a sharding spec — dead parallelism: "
                f"{size}x the cards for 1x the work; drop the axis or "
                f"shard over it")

    budget = budget_bytes if budget_bytes is not None else \
        comm_budget_bytes()
    report.budget_bytes = budget
    if budget is not None:
        report.headroom_bytes = int(budget) - int(report.total_wire_bytes)
        if report.headroom_bytes < 0:
            walker._emit(
                "HVD401",
                f"estimated per-step wire bytes {report.total_wire_bytes} "
                f"exceed the comm budget {budget} bytes "
                f"(HVD_COMM_BUDGET_BYTES) by {-report.headroom_bytes} "
                f"bytes")
    return report


def measure_step_fn_comm(fn, args=(), kwargs: Optional[dict] = None, *,
                         label: Optional[str] = None,
                         axis_env: Optional[Sequence[Tuple[str, int]]] =
                         None, **measure_kwargs) -> CommReport:
    """Trace ``fn(*args, **kwargs)`` and comm-walk it, with the
    ``axis_env`` sizes as the mesh.  Trace failures come back as an empty
    report (the graph checker owns trace-failure reporting, HVD100)."""
    from .graph_check import trace
    name = label or getattr(fn, "__name__", None) or "step"
    try:
        gm = trace(fn, args, kwargs, axis_env)
    except Exception:
        return CommReport(label=name)
    return measure_graph_comm(gm, label=name,
                              axis_sizes=dict(axis_env or ()),
                              **measure_kwargs)


def publish_report(report: CommReport) -> None:
    """Log findings, append to ``core.analysis_reports()``, and chart the
    comm census on the active timeline (``comm_census``).  Never
    raises."""
    from ..utils import get_logger
    log = get_logger()
    for f in report.findings:
        log.warning("hvdshard: %s", f.format())
    try:
        from .. import core as _core
        _core._state.analysis_reports.append(report)
        tl = _core._state.timeline
        if tl is not None:
            tl.comm_census(report.label, report.to_dict())
    except Exception as e:  # pragma: no cover - publication is best-effort
        log.warning("hvdshard: could not publish report: %s", e)


# ---------------------------------------------------------------------------
# Replica-plan go/no-go (the serve layer's admission primitive)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanVerdict:
    """One static go/no-go for a replica plan: hvdmem's pool-vs-budget
    verdict (HVD302) combined with the comm budget (HVD401)."""

    label: str
    go: bool
    mem: dict
    comm: dict
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {"label": self.label, "go": self.go,
                "mem": self.mem, "comm": self.comm,
                "findings": [f.to_dict() for f in self.findings]}


def check_replica_plan(label: str, *,
                       pool_bytes: int = 0,
                       weight_bytes: int = 0,
                       step_comm_bytes: int = 0,
                       mem_budget_bytes: Optional[int] = None,
                       comm_budget: Optional[int] = None,
                       device: Any = None) -> PlanVerdict:
    """Static admission check for one replica plan, BEFORE any traffic:
    does the KV pool + weights fit the card's memory (hvdmem HVD302;
    ``device`` names the card to probe when no budget is given), and
    do the per-step wire bytes fit the comm budget (HVD401)?  ``go`` is
    False iff any check fails.

    A data-parallel replica runs no collective in its serve steps, so its
    comm half passes trivially; sequence-parallel prefill supplies its
    ring's bytes.  The engine runs this at construction and exposes the
    verdict on ``kv_stats`` / ``healthz``."""
    from .memplan import check_pool_budget
    mem = check_pool_budget(label, pool_bytes, weight_bytes,
                            budget=mem_budget_bytes, device=device)
    comm = CommReport(label=label, total_wire_bytes=int(step_comm_bytes))
    budget = comm_budget if comm_budget is not None else comm_budget_bytes()
    comm.budget_bytes = budget
    if budget is not None:
        comm.headroom_bytes = int(budget) - comm.total_wire_bytes
        if comm.headroom_bytes < 0:
            comm.findings.append(Finding(
                rule="HVD401", path=label, line=0, col=0, source="comm",
                message=f"replica plan's per-step wire bytes "
                        f"{comm.total_wire_bytes} exceed the comm "
                        f"budget {budget} bytes (HVD_COMM_BUDGET_BYTES) "
                        f"by {-comm.headroom_bytes} bytes"))
    findings = list(mem.findings) + list(comm.findings)
    return PlanVerdict(label=label, go=not findings,
                       mem=mem.to_dict(), comm=comm.to_dict(),
                       findings=findings)


def publish_verdict(verdict: PlanVerdict) -> None:
    """Surface a failed (or any) replica-plan verdict: findings logged as
    warnings, the verdict appended to ``core.analysis_reports()``.  Never
    raises."""
    from ..utils import get_logger
    log = get_logger()
    for f in verdict.findings:
        log.warning("hvdshard: %s", f.format())
    try:
        from .. import core as _core
        _core._state.analysis_reports.append(verdict)
    except Exception as e:  # pragma: no cover - publication is best-effort
        log.warning("hvdshard: could not publish verdict: %s", e)


# ---------------------------------------------------------------------------
# AST half (the CLI --comm pass): HVD404 source shapes
# ---------------------------------------------------------------------------

_MESH_CTORS = {"Mesh", "make_mesh"}

#: Keywords that name the axes a call communicates or shards over.
_AXIS_KEYWORDS = {"axis_name", "axis", "axis_names", "reduce_axes",
                  "expert_axis"}

#: Calls whose string arguments are axes of a mesh (the port's process
#: sets over axes, its sharded-parameter marks, its axis lookups).
_AXIS_CALLS = {"process_set", "axes_process_set", "lines", "line", "axis",
               "group", "mark_sharded"}


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _mesh_literal_axes(call: ast.Call) -> Optional[List[str]]:
    """Literal axis names of a mesh constructor call: the dict keys of
    ``make_mesh({"x": ..})`` or the string tuple of
    ``Mesh(devs, ("x", "y"))`` / ``axis_names=(...)``.  None when the
    axes are not statically visible."""
    candidates: List[ast.AST] = list(call.args)
    for kw in call.keywords:
        if kw.arg in ("axes", "axis_names", "shape"):
            candidates.insert(0, kw.value)
    for arg in candidates:
        if isinstance(arg, ast.Dict) and arg.keys and all(
                isinstance(k, ast.Constant) and isinstance(k.value, str)
                for k in arg.keys if k is not None):
            return [k.value for k in arg.keys if k is not None]
        if isinstance(arg, (ast.Tuple, ast.List)) and arg.elts and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in arg.elts):
            return [e.value for e in arg.elts]
    return None


def _strings(nodes: Sequence[ast.AST]) -> List[str]:
    """The string literals in ``nodes``: a bare axis name, or the names
    in a tuple / list / nested spec of them."""
    return [sub.value for node in nodes for sub in ast.walk(node)
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str)]


def _iter_functions(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class _CommVisitor:
    """Module walk collecting the HVD404 source findings."""

    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []

    def run(self, tree: ast.Module) -> List[Finding]:
        for fn in _iter_functions(tree):
            self._check_hvd404(fn)
        seen: Set[Tuple] = set()
        uniq: List[Finding] = []
        for f in sorted(self.findings,
                        key=lambda f: (f.line, f.col, f.rule)):
            key = (f.rule, f.line, f.col)
            if key not in seen:
                seen.add(key)
                uniq.append(f)
        return uniq

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0) + 1,
            message=message, source="comm"))

    # -- HVD404: mesh axis never exercised by this function's specs ---------

    def _check_hvd404(self, fn: ast.AST) -> None:
        """A mesh built from literal axes, consumed in the same function
        whose literal specs exercise SOME of those axes but never one of
        them: the dead axis multiplies chips without parallelizing
        anything.  Meshes that escape (returned / stored on self) are
        skipped — their axes may be used by callers."""
        meshes: List[Tuple[str, List[str], ast.Call]] = []
        escaped: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    _call_name(node.value) in _MESH_CTORS:
                axes = _mesh_literal_axes(node.value)
                if not axes:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        meshes.append((t.id, axes, node.value))
                    else:
                        escaped.add("")  # stored into an attribute etc.
            elif isinstance(node, ast.Return) and node.value is not None:
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Name):
                        escaped.add(sub.id)
        if not meshes:
            return
        mesh_lines = {m[2].lineno for m in meshes}
        used: Set[str] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name in ("P", "PartitionSpec") or name in _AXIS_CALLS:
                if getattr(node, "lineno", 0) not in mesh_lines:
                    used.update(_strings(node.args))
            for kw in node.keywords:
                if kw.arg in _AXIS_KEYWORDS:
                    used.update(_strings([kw.value]))
        if not used:
            return  # no literal spec usage at all: no static claim
        for name, axes, call in meshes:
            if name in escaped:
                continue
            dead = [a for a in axes if a not in used]
            if dead and len(dead) < len(axes):
                self._emit(
                    "HVD404", call,
                    f"mesh '{name}' declares axes {axes} but "
                    f"{dead} never appear in any spec, axis_name or "
                    f"reduce_axes in this function while "
                    f"{sorted(set(axes) - set(dead))} do — dead "
                    f"parallelism: those cards replicate work")


def analyze_source(source: str, path: str = "<string>",
                   select: Sequence[str] = (),
                   ignore: Sequence[str] = ()) -> List[Finding]:
    """AST --comm pass over one source string (HVD404), honoring the shared hvdlint pragma + select/ignore
    contract."""
    from .linter import _parse_pragmas, _suppressed
    try:
        tree = ast.parse(source, filename=path)
    except (SyntaxError, ValueError, RecursionError) as e:
        if not rule_selected("HVD000", select, ignore):
            return []
        line = getattr(e, "lineno", 0) or 0
        col = (getattr(e, "offset", 0) or 0)
        return [Finding(rule="HVD000", path=path, line=line,
                        col=max(col, 1), source="comm",
                        message=f"could not parse: {type(e).__name__}: "
                                f"{e}")]
    findings = _CommVisitor(path).run(tree)
    per_line, file_wide = _parse_pragmas(source)
    out: List[Finding] = []
    for f in findings:
        if not rule_selected(f.rule, select, ignore):
            continue
        f.suppressed = _suppressed(f, per_line, file_wide)
        out.append(f)
    return out


def analyze_paths(paths: Iterable[str], select: Sequence[str] = (),
                  ignore: Sequence[str] = ()) -> List[Finding]:
    """AST --comm pass over files/directories (the dogfooding command:
    ``python -m horovod_tpu_torch.analysis --comm horovod_tpu_torch``)."""
    from .linter import iter_python_files
    findings: List[Finding] = []
    files: List[str] = []
    for path in paths:
        if not os.path.exists(path):
            if rule_selected("HVD000", select, ignore):
                findings.append(Finding(
                    rule="HVD000", path=path, line=0, col=1,
                    source="comm", message="path does not exist"))
        else:
            files.append(path)
    for fpath in iter_python_files(files):
        try:
            with open(fpath, "rb") as fh:
                source = fh.read().decode("utf-8", errors="replace")
        except OSError as e:
            if rule_selected("HVD000", select, ignore):
                findings.append(Finding(
                    rule="HVD000", path=fpath, line=0, col=1,
                    source="comm",
                    message=f"could not read file: {e}"))
            continue
        findings.extend(analyze_source(source, path=fpath, select=select,
                                       ignore=ignore))
    return findings
