"""hvdmem's budget half: the serve pool's device bytes against a budget
(HVD302).

Copied from the budget half of ``horovod_tpu/analysis/memplan.py``
(``device_budget_bytes``, ``params_bytes``, ``MemReport``,
``check_pool_budget``, ``publish_report``).  The budget is
``HVD_MEM_BUDGET_BYTES`` when set (empty reads as unset, a malformed
value as "no budget"), else the card's memory as ``torch.cuda`` reports
it, else None.  The JAX package's other half — the jaxpr liveness walk
(HVD300 / HVD303 / HVD304) and the ``--mem`` AST pass over
``donate_argnums`` (HVD300 / HVD301) — is not here: the walk needs a
torch graph source, and torch has no buffer donation (ROADMAP.md).

The serve engine folds its allocation plan — ``paged_block_bytes() *
num_blocks`` plus the weight bytes — into ``check_pool_budget`` at
construction and exposes the headroom as ``kv_headroom_bytes`` on
``healthz`` / ``/metrics``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional

from .findings import Finding


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
    """Result of one pool-budget check (the JAX package's report, cut to
    the fields the check sets)."""

    label: str
    peak_live_bytes: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    budget_bytes: Optional[int] = None
    headroom_bytes: Optional[int] = None
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
        }


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
