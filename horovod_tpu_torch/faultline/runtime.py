"""Process-global fault-plan registry the injection points consult.

Copied unchanged from ``horovod_tpu/faultline/runtime.py``: ``install``
wires the port's own timeline (``core._state.timeline``).

Off by default with zero hot-path cost: the guard every instrumented
code path uses is ``runtime.PLAN is not None`` — one module-attribute
read next to a decode step or an HTTP round-trip.  Only when a
plan is installed does any fault logic run.

Activation paths:

* programmatic — ``faultline.install(FaultPlan([...], seed=...))``
  (tests, bench);
* environment — ``HVD_FAULTLINE_PLAN`` (spec grammar, plan.parse_spec)
  with ``HVD_FAULTLINE_SEED`` assigning the step indices of step-less
  specs.  ``maybe_install_from_env`` is called once from each
  instrumented subsystem's constructor (engine / scheduler / KV client /
  sentinel), so an env-configured chaos run needs no code changes.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

from .plan import FaultPlan, FaultSpec, parse_plan

#: The active plan, or None (the default — injection points no-op).
PLAN: Optional[FaultPlan] = None

_env_lock = threading.Lock()
_env_checked = False


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process's active fault plan and wire the ambient
    timeline (if one is running) so firings land in the trace."""
    global PLAN
    try:
        from .. import core as _core
        tl = getattr(_core._state, "timeline", None)
        if tl is not None:
            plan.set_timeline(tl)
    except Exception:
        pass
    PLAN = plan
    return plan


def uninstall() -> None:
    global PLAN
    PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return PLAN


def fire(point: str, instance: Optional[str] = None) -> List[FaultSpec]:
    """Fast-path helper: () when no plan is installed."""
    plan = PLAN
    return plan.fire(point, instance) if plan is not None else []


def maybe_install_from_env() -> Optional[FaultPlan]:
    """One-shot env bootstrap (HVD_FAULTLINE_PLAN / HVD_FAULTLINE_SEED).

    Constructor-time, not import-time: the env is read when the first
    instrumented subsystem comes up, so a test harness exporting the
    knobs after import still gets its plan.  Checked once per process —
    a programmatically-installed plan is never overridden."""
    global _env_checked
    if PLAN is not None:
        return PLAN
    with _env_lock:
        if _env_checked or PLAN is not None:
            return PLAN
        _env_checked = True
        text = os.environ.get("HVD_FAULTLINE_PLAN", "")
        if not text:
            return None
        seed = int(os.environ.get("HVD_FAULTLINE_SEED", "0"))
        return install(parse_plan(text, seed=seed))
