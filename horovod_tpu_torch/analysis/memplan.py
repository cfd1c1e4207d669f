"""hvdmem — device-memory liveness and budget analysis (HVD3xx).

Copied from ``horovod_tpu/analysis/memplan.py``: the budget half
(``device_budget_bytes``, ``params_bytes``, ``MemReport``,
``check_pool_budget``, ``publish_report``, the knobs) and the walk half
(``memplan.py:127-520``) over a ``make_fx`` graph
(``analysis/graph_check.py``) in place of a jaxpr.

* **The liveness walk** (``measure_graph`` / ``measure_step_fn``):
  node by node over the graph, a tensor's storage is allocated by the
  node that first produces it and dies after the last node that reads
  it or a view of it (views and in-place ops allocate nothing).  Inputs
  and the tensors a step closes over stay live throughout — the caller
  holds them.  A ``torch.cond`` contributes its larger branch's
  transient, never the sum; a ``while_loop`` its body's, once.  Output:
  ``peak_live_bytes`` and allocation bytes by aten op.  Rules on the
  walk: HVD300 (an input of at least ``DONATION_MIN_BYTES`` that the
  graph does not update in place, next to a freshly allocated output of
  its shape and dtype — torch's reading of "donatable but undonated"),
  HVD302 (the peak against ``HVD_MEM_BUDGET_BYTES`` / the card's
  memory), HVD303 (bf16 / f16 promoted to f32 by ``_to_copy`` /
  ``convert_element_type`` dominating the peak) and HVD304 (a rank-1
  ``cat`` past the fusion threshold: ``_fused_allreduce``'s flat
  buffer).
* **The pool budget** (``check_pool_budget``): the serve engine folds
  its allocation plan — ``paged_block_bytes() * num_blocks`` plus the
  weight bytes — into the same HVD302 check at construction and exposes
  the headroom as ``kv_headroom_bytes`` on ``healthz`` / ``/metrics``.

The budget is ``HVD_MEM_BUDGET_BYTES`` when set (empty reads as unset, a
malformed value as "no budget"), else the card's memory as
``torch.cuda`` reports it, else None.  The JAX package's ``--mem`` AST
pass over ``donate_argnums`` (HVD300 / HVD301) is not here: torch has
no buffer donation (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

from .findings import Finding

# Bytes below which an input the graph could update in place is noise,
# not a finding: a [B]-sized token vector saves nothing, a KV pool
# halves the steady-state footprint.
DONATION_MIN_BYTES = 1 << 20


def upcast_min_bytes_default() -> int:
    """Floor for one bf16/f16 → f32 promotion to count toward HVD303
    (HVD_MEM_UPCAST_MIN_BYTES, bytes): the f32 layernorm islands the
    serve adapter runs on purpose are a few KB; a whole activation/param
    set silently widening is MBs.  Read per call like the sibling knobs
    so a malformed value degrades to the default instead of breaking the
    package import."""
    try:
        return int(os.environ.get("HVD_MEM_UPCAST_MIN_BYTES",
                                  str(8 << 20)))
    except ValueError:
        return 8 << 20


def fusion_threshold_bytes() -> int:
    """The tensor-fusion bucket bound (HOROVOD_FUSION_THRESHOLD, bytes —
    the same knob the eager fusion path sizes its flat buffers by)."""
    try:
        return int(os.environ.get("HOROVOD_FUSION_THRESHOLD",
                                  str(128 << 20)))
    except ValueError:
        return 128 << 20


def device_budget_bytes(device: Any = None) -> Optional[int]:
    """The device-memory budget the HVD302 check measures against:
    ``HVD_MEM_BUDGET_BYTES`` when set, else the memory of ``device``
    (a card: ``torch.cuda.get_device_properties(...).total_memory``; the
    current card when ``device`` is None and one is present), else None
    (no budget known — HVD302 stays silent).  A CPU ``device`` has no
    budget."""
    env = os.environ.get("HVD_MEM_BUDGET_BYTES", "")
    if env:
        try:
            return int(env)
        except ValueError:
            return None
    try:
        import torch
        if device is not None:
            device = torch.device(device)
            if device.type != "cuda":
                return None
        elif not torch.cuda.is_available():
            return None
        else:
            device = torch.device("cuda", torch.cuda.current_device())
        limit = int(torch.cuda.get_device_properties(device).total_memory)
        return limit or None
    except Exception:
        return None


def params_bytes(tree: Any) -> int:
    """Total bytes of the tensors in ``tree``: a tensor, an
    ``nn.Module`` (its parameters), a state dict, or nested dicts /
    lists / tuples of them; arrays with ``nbytes`` count too.  A tensor
    reached twice counts once (0 for None / tensor-free)."""
    if tree is None:
        return 0
    try:
        import torch
    except Exception:  # pragma: no cover - the port always has torch
        torch = None
    seen, total = set(), 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif torch is not None and isinstance(node, torch.nn.Module):
            stack.extend(node.parameters())
        elif id(node) in seen:
            continue
        elif torch is not None and isinstance(node, torch.Tensor):
            seen.add(id(node))
            total += node.numel() * node.element_size()
        elif getattr(node, "nbytes", None) is not None:
            seen.add(id(node))
            total += int(node.nbytes)
    return total


@dataclasses.dataclass
class MemReport:
    """Result of one liveness walk (or one pool-budget check)."""

    label: str
    peak_live_bytes: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    # aten op -> {"count": nodes (a while_loop body counted once),
    # "bytes": storage those nodes allocate}
    by_primitive: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    budget_bytes: Optional[int] = None
    headroom_bytes: Optional[int] = None
    upcast_f32_bytes: int = 0
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "peak_live_bytes": int(self.peak_live_bytes),
            "input_bytes": int(self.input_bytes),
            "output_bytes": int(self.output_bytes),
            "budget_bytes": self.budget_bytes,
            "headroom_bytes": self.headroom_bytes,
            "upcast_f32_bytes": int(self.upcast_f32_bytes),
            "by_primitive": {k: dict(v)
                             for k, v in sorted(self.by_primitive.items())},
        }


# ---------------------------------------------------------------------------
# Graph liveness walk
# ---------------------------------------------------------------------------

def _storages(val) -> List[Any]:
    """``(storage key, bytes)`` of each tensor in a node's value (views
    and in-place results share their base's key)."""
    from torch.multiprocessing.reductions import StorageWeakRef
    from .graph_check import _tensors
    out = []
    for t in _tensors(val):
        try:
            st = t.untyped_storage()
            out.append((StorageWeakRef(st), int(st.nbytes())))
        except Exception:  # a tensor with no storage (sparse, nested)
            continue
    return out


class _Keys:
    """Storage keys of a graph's values.  A fake value's storage is not
    always its base's: ``make_fx`` gives each use of a closed-over
    tensor a ``get_attr`` node of its own, and the value of a view of
    one may carry a storage of its own.  So the keys follow the graph:
    the ``get_attr`` nodes of one attribute share the first's key, and
    the result of an op whose schema says it aliases an argument (a view,
    an in-place op) takes that argument's key."""

    def __init__(self, gm):
        self.alias: Dict[Any, Any] = {}
        first: Dict[str, Any] = {}
        for node in gm.graph.nodes:
            if node.op == "get_attr":
                for k, _ in _storages(node.meta.get("val")):
                    self.alias[k] = first.setdefault(node.target, k)
                continue
            schema = getattr(node.target, "_schema", None)
            if node.op != "call_function" or schema is None or not any(
                    r.alias_info is not None for r in schema.returns):
                continue
            src = next((node.args[i] for i, arg in enumerate(
                schema.arguments) if arg.alias_info is not None
                and i < len(node.args) and hasattr(node.args[i], "meta")),
                None)
            base = self(src.meta.get("val")) if src is not None else []
            if base:
                for k, _ in _storages(node.meta.get("val")):
                    self.alias.setdefault(k, base[0][0])

    def __call__(self, val) -> List[Any]:
        return [(self.alias.get(k, k), b) for k, b in _storages(val)]


def _op_name(node) -> str:
    schema = getattr(node.target, "_schema", None)
    if schema is not None:
        return schema.name.replace("::", ".")
    return getattr(node.target, "__name__", str(node.target))


def _written(node, keys: _Keys) -> List[Any]:
    """The storages a mutating op writes (its schema's ``(a!)``
    arguments)."""
    schema = getattr(node.target, "_schema", None)
    if schema is None or not schema.is_mutable:
        return []
    out = []
    for i, arg in enumerate(schema.arguments):
        info = arg.alias_info
        if info is None or not info.is_write:
            continue
        val = node.args[i] if i < len(node.args) else \
            node.kwargs.get(arg.name)
        items = val if isinstance(val, (list, tuple)) else [val]
        for a in items:
            if hasattr(a, "meta"):
                out += [k for k, _ in keys(a.meta.get("val"))]
    return out


class _LivenessWalker:
    """Simulates allocation order over a graph: a node's new storages
    are allocated before its inputs can die (an op cannot free an
    operand mid-op); a storage dies after the last node that reads or
    writes it, unless pinned (the top level's inputs and constants: the
    caller still holds them); subgraphs contribute their internal
    transient (their peak beyond the boundary values the outer level
    already counts)."""

    def __init__(self, report: MemReport, fusion_threshold: int,
                 upcast_min: int):
        self.report = report
        self.fusion_threshold = fusion_threshold
        self.upcast_min = upcast_min
        self._upcast_sites = 0
        self._first_upcast = ""
        self.written = set()   # storages some node updates in place

    def _transient(self, sub) -> int:
        """A subgraph's peak beyond its boundary values (its
        placeholders alias outer operands already counted as live)."""
        boundary, keys = {}, _Keys(sub)
        for node in sub.graph.nodes:
            if node.op == "placeholder":
                boundary.update(keys(node.meta.get("val")))
        peak = self.walk(sub, pinned=frozenset())
        return max(0, peak - sum(boundary.values()))

    def _node_transient(self, node, gm) -> int:
        from .graph_check import subgraphs
        subs = subgraphs(node, gm)[1]
        # Branches are exclusive at runtime: the peak takes the MAX; a
        # loop's cond and body run one after the other.
        return max((self._transient(s) for s in subs), default=0)

    # -- per-node rule checks ------------------------------------------------

    def _check_upcast(self, node) -> None:
        """HVD303 input gathering: a bf16/f16 value promoted to f32/f64,
        element count preserved, past the size floor."""
        if _op_name(node) not in ("aten._to_copy",
                                  "prims.convert_element_type"):
            return
        from .graph_check import _tensors, tensor_bytes
        src = [t for a in node.args[:1] if hasattr(a, "meta")
               for t in _tensors(a.meta.get("val"))]
        dst = _tensors(node.meta.get("val"))
        if not src or not dst:
            return
        src_dt = str(src[0].dtype).rpartition(".")[2]
        dst_dt = str(dst[0].dtype).rpartition(".")[2]
        if src_dt not in ("bfloat16", "float16") or \
                dst_dt not in ("float32", "float64"):
            return
        out_bytes = tensor_bytes(dst[0])
        if out_bytes < self.upcast_min:
            return
        self.report.upcast_f32_bytes += out_bytes
        self._upcast_sites += 1
        if not self._first_upcast:
            self._first_upcast = (
                f"{src_dt}{tuple(src[0].shape)} -> {dst_dt}")

    def _check_fusion(self, node) -> None:
        """HVD304: a rank-1 flat-buffer concatenation bigger than the
        tensor-fusion threshold knob — the fused-bucket overshoot that
        doubles a step's transient footprint past what the knob
        promises."""
        if _op_name(node) != "aten.cat":
            return
        from .graph_check import _tensors, tensor_bytes
        out = _tensors(node.meta.get("val"))
        if len(out) != 1 or out[0].dim() != 1:
            return
        out_bytes = tensor_bytes(out[0])
        if out_bytes > self.fusion_threshold:
            self.report.findings.append(Finding(
                rule="HVD304", path=self.report.label, line=0, col=0,
                source="mem",
                message=f"fused flat buffer of {out_bytes} bytes exceeds "
                        f"the tensor-fusion threshold "
                        f"({self.fusion_threshold} bytes, "
                        f"HOROVOD_FUSION_THRESHOLD) — the bucket overshoot "
                        f"costs its full size twice (gather-in + "
                        f"collective result) at peak"))

    def finish_upcast(self) -> None:
        """HVD303 fires when the promotions dominate: total upcast bytes
        at least a quarter of the peak ("promotes the whole live set"),
        not the few param-sized bf16→f32 accumulation casts every
        mixed-precision backward pass legitimately performs."""
        up = self.report.upcast_f32_bytes
        if self._upcast_sites and \
                up * 4 >= max(self.report.peak_live_bytes, 1):
            self.report.findings.append(Finding(
                rule="HVD303", path=self.report.label, line=0, col=0,
                source="mem",
                message=f"{self._upcast_sites} low-precision value(s) "
                        f"promoted to f32 for {up} bytes — "
                        f"{100 * up // max(self.report.peak_live_bytes, 1)}"
                        f"% of the {self.report.peak_live_bytes}-byte "
                        f"peak (first: {self._first_upcast}): the "
                        f"silent-upcast footprint — the live set widens "
                        f"2x through these ops"))

    # -- the walk -----------------------------------------------------------

    def walk(self, gm, pinned) -> int:
        """Returns this graph's peak live bytes, counting its
        placeholders and constants as live at entry.  ``pinned``
        storages never die."""
        nodes = list(gm.graph.nodes)
        keys = _Keys(gm)
        touched = []        # per node: every storage it reads or makes
        last_use: Dict[Any, int] = {}
        for i, node in enumerate(nodes):
            used = {k for k, _ in keys(node.meta.get("val"))}
            for a in node.all_input_nodes:
                used.update(k for k, _ in keys(a.meta.get("val")))
            touched.append(used)
            for k in used:
                last_use[k] = i
        outset = set()
        for node in nodes:
            if node.op == "output":
                for a in node.all_input_nodes:
                    outset.update(k for k, _ in keys(a.meta.get("val")))
        live: Dict[Any, int] = {}
        for node in nodes:
            if node.op in ("placeholder", "get_attr"):
                live.update(keys(node.meta.get("val")))
        live_bytes = sum(live.values())
        peak = live_bytes
        for i, node in enumerate(nodes):
            if node.op != "call_function":
                continue
            self.written.update(_written(node, keys))
            transient = self._node_transient(node, gm)
            new = 0
            for k, b in keys(node.meta.get("val")):
                if k not in live:
                    live[k] = b
                    new += b
            live_bytes += new
            entry = self.report.by_primitive.setdefault(
                _op_name(node), {"count": 0, "bytes": 0})
            entry["count"] += 1
            entry["bytes"] += new
            self._check_upcast(node)
            self._check_fusion(node)
            peak = max(peak, live_bytes + transient)
            for k in touched[i]:
                if k in outset or k in pinned or last_use.get(k, i) > i:
                    continue
                live_bytes -= live.pop(k, 0)
        return peak


def _donation_findings(gm, keys: _Keys, report: MemReport, written,
                       label: str, min_bytes: int) -> None:
    """HVD300 in torch's terms: an input the graph does not update in
    place, next to a freshly allocated output of its shape and dtype —
    writing the result into the input would hold one copy, not two."""
    from .graph_check import _tensors, tensor_bytes

    def key(t):
        return tuple(t.shape), str(t.dtype).rpartition(".")[2]

    def skey(t):
        s = keys(t)
        return s[0][0] if s else None

    inputs = [n for n in gm.graph.nodes if n.op == "placeholder"]
    held = {k for n in gm.graph.nodes if n.op in ("placeholder", "get_attr")
            for k, _ in keys(n.meta.get("val"))}
    fresh: Dict[Any, int] = {}
    outset = set()
    for node in gm.graph.nodes:
        if node.op != "output":
            continue
        for a in node.all_input_nodes:
            for t in _tensors(a.meta.get("val")):
                k = skey(t)
                outset.add(k)
                if k not in held:
                    fresh[key(t)] = fresh.get(key(t), 0) + 1
    flat = [(n, t) for n in inputs for t in _tensors(n.meta.get("val"))]
    # An input updated in place takes its matching fresh output first:
    # that output cannot justify updating a second input.
    for _, t in flat:
        if skey(t) in written and fresh.get(key(t)):
            fresh[key(t)] -= 1
    for idx, (_, t) in enumerate(flat):
        k = skey(t)
        if k in written or k in outset:
            continue
        b = tensor_bytes(t)
        if b < min_bytes or not fresh.get(key(t)):
            continue
        fresh[key(t)] -= 1
        shape, dtype = key(t)
        report.findings.append(Finding(
            rule="HVD300", path=label, line=0, col=0, source="mem",
            message=f"arg {idx} ({dtype}{shape}, {b} bytes) matches a "
                    f"freshly allocated output's shape and dtype but is "
                    f"not updated in place — writing the result into it "
                    f"(an in-place op or out=) holds one copy live "
                    f"instead of two"))


def _graph_device(gm) -> Any:
    """The device of the graph's first tensor input or constant (None
    without one)."""
    from .graph_check import _tensors
    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            for t in _tensors(node.meta.get("val")):
                return t.device
    return None


def measure_graph(gm, *, label: str = "<graph>",
                  budget_bytes: Optional[int] = None,
                  fusion_threshold: Optional[int] = None,
                  upcast_min_bytes: Optional[int] = None,
                  donation_min_bytes: int = DONATION_MIN_BYTES
                  ) -> MemReport:
    """Liveness-walk an already-traced graph
    (``graph_check.trace``).  ``budget_bytes`` defaults to
    ``device_budget_bytes`` of the graph's device (a CPU graph has none);
    when known, HVD302 fires if the peak exceeds it."""
    report = MemReport(label=label)
    walker = _LivenessWalker(
        report,
        fusion_threshold if fusion_threshold is not None
        else fusion_threshold_bytes(),
        upcast_min_bytes if upcast_min_bytes is not None
        else upcast_min_bytes_default())
    keys = _Keys(gm)
    held, outs = {}, {}
    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            held.update(keys(node.meta.get("val")))
        elif node.op == "output":
            for a in node.all_input_nodes:
                outs.update(keys(a.meta.get("val")))
    report.input_bytes = sum(held.values())
    report.output_bytes = sum(outs.values())
    report.peak_live_bytes = walker.walk(gm, frozenset(held))
    walker.finish_upcast()
    _donation_findings(gm, keys, report, walker.written, label,
                       donation_min_bytes)
    budget = budget_bytes if budget_bytes is not None \
        else device_budget_bytes(_graph_device(gm) or "cpu")
    report.budget_bytes = budget
    if budget is not None:
        report.headroom_bytes = int(budget) - int(report.peak_live_bytes)
        if report.headroom_bytes < 0:
            report.findings.append(Finding(
                rule="HVD302", path=label, line=0, col=0, source="mem",
                message=f"estimated peak live footprint "
                        f"{report.peak_live_bytes} bytes exceeds the "
                        f"memory budget {budget} bytes "
                        f"(HVD_MEM_BUDGET_BYTES / the card's memory) by "
                        f"{-report.headroom_bytes} bytes"))
    return report


def measure_step_fn(fn, args=(), kwargs: Optional[dict] = None, *,
                    label: Optional[str] = None,
                    axis_env=None, **measure_kwargs) -> MemReport:
    """Trace ``fn(*args, **kwargs)`` and liveness-walk it.  Never raises
    on the user's program: a trace failure comes back as an empty report
    (the graph checker owns trace-failure reporting, HVD100)."""
    from .graph_check import trace
    name = label or getattr(fn, "__name__", None) or "step"
    try:
        gm = trace(fn, args, kwargs, axis_env)
    except Exception:
        return MemReport(label=name)
    return measure_graph(gm, label=name, **measure_kwargs)


def check_pool_budget(label: str, pool_bytes: int, weight_bytes: int,
                      budget: Optional[int] = None,
                      device: Any = None) -> MemReport:
    """Verify a concrete allocation plan — the BlockManager pool
    (``paged_block_bytes() * num_blocks``) plus the replica's weight
    bytes — against the budget (``device_budget_bytes(device)`` when
    ``budget`` is None).  Returns a MemReport whose ``headroom_bytes`` is
    what the engine exposes as ``kv_headroom_bytes``; an HVD302 finding
    when the plan overshoots."""
    budget = budget if budget is not None else device_budget_bytes(device)
    report = MemReport(label=label,
                       peak_live_bytes=int(pool_bytes) + int(weight_bytes),
                       input_bytes=int(weight_bytes),
                       output_bytes=int(pool_bytes),
                       budget_bytes=budget)
    if budget is not None:
        report.headroom_bytes = int(budget) - report.peak_live_bytes
        if report.headroom_bytes < 0:
            report.findings.append(Finding(
                rule="HVD302", path=label, line=0, col=0, source="mem",
                message=f"KV pool ({pool_bytes} bytes) + weights "
                        f"({weight_bytes} bytes) = "
                        f"{report.peak_live_bytes} bytes exceeds the "
                        f"memory budget {budget} bytes by "
                        f"{-report.headroom_bytes} bytes — shrink "
                        f"HVD_SERVE_NUM_BLOCKS or quantize KV blocks "
                        f"(HVD_SERVE_KV_DTYPE=int8)"))
    return report


def publish_report(report: MemReport) -> None:
    """Log findings, append to ``core.analysis_reports()``, and chart
    the report on the active timeline (``memory_census``).  Never
    raises."""
    from ..utils import get_logger
    log = get_logger()
    for f in report.findings:
        log.warning("hvdmem: %s", f.format())
    try:
        from .. import core as _core
        _core._state.analysis_reports.append(report)
        tl = _core._state.timeline
        if tl is not None:
            tl.memory_census(report.label, report.to_dict())
    except Exception as e:  # pragma: no cover - publication is best-effort
        log.warning("hvdmem: could not publish report: %s", e)
