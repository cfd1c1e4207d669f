"""hvdrace runtime half: the HVD_SANITIZE=1 lock-witness sanitizer.

Copied from ``horovod_tpu/analysis/witness.py``; findings publish to the
port's ``core.analysis_reports()`` and its timeline's ``witness_event``.

FreeBSD's WITNESS adapted to Python ``threading``: an instrumented lock
factory (plus a monkey-patch installer that routes ``threading.Lock`` /
``RLock`` / ``Condition`` through it) records per-thread held-lock sets
and maintains the acquisition-order graph LIVE.  Lock identity is the
*construction site* (``serve/batcher.py:170``), so every instance of a
class contributes to one witness class — exactly the static half's
(lockgraph.py) identity, observed instead of inferred.

Findings (structured ``Finding`` objects, rule IDs in findings.py):

* **HVD210** — order inversion: lock B acquired while holding A after an
  earlier A-while-holding-B acquisition anywhere in the process.  The
  finding carries both acquisition sites and thread names.
* **HVD211** — ``Condition.wait()`` / ``Event.wait()`` with **no
  timeout** while holding a second lock: the wait releases only its own
  lock; the other one is held until a wakeup that may never come.

The sanitizer NEVER raises into the instrumented program by default —
findings are recorded (``findings()``), published to
``core.analysis_reports()`` (as a ``WitnessReport``) and emitted as
``WITNESS/<rule>`` Timeline instants like the faultline firings.  Set
``HVD_RACE_RAISE=1`` to raise ``LockOrderViolation`` at the violating
acquisition instead (debugging).  Overhead is a few dict operations per
acquisition — cheap enough to run a serving fleet under it (the serve
package installs it at import when ``HVD_SANITIZE=1``).

Usage::

    from horovod_tpu_torch.analysis import witness
    witness.install()            # or maybe_install_from_env()
    ...                          # run the threaded system
    assert not witness.findings()
    witness.uninstall()

``install()`` only wraps locks constructed AFTER it runs; install first,
construct the fleet second.
"""

from __future__ import annotations

import os
import sys
import threading
import _thread
from typing import Dict, List, Optional, Tuple

from .findings import Finding

# Real constructors, captured at import time so the wrappers and the
# sanitizer's own state never recurse through the patched factories.
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

# Frames whose construction sites must not name the lock (the wrappers
# themselves, and threading.py internals like Event/Thread bookkeeping).
_SKIP_BASENAMES = ("witness.py", "threading.py")


class LockOrderViolation(RuntimeError):
    """Raised at the violating acquisition when HVD_RACE_RAISE=1."""


class _State:
    def __init__(self):
        self.lock = _REAL_LOCK()           # guards graph/findings
        self.local = threading.local()     # .held: List[_Held]
        # (first label, second label) -> (site, thread name) of the first
        # observation of that order.
        self.graph: Dict[Tuple[str, str], Tuple[str, str]] = {}
        self.findings: List[Finding] = []
        self.reported: set = set()         # dedup keys
        self.installed = False
        self.originals: dict = {}
        self.raise_on_violation = False

    def held(self) -> list:
        held = getattr(self.local, "held", None)
        if held is None:
            held = self.local.held = []
        return held


_state = _State()


def enabled() -> bool:
    return os.environ.get("HVD_SANITIZE", "") not in ("", "0", "false",
                                                      "False")


def _raise_enabled() -> bool:
    return os.environ.get("HVD_RACE_RAISE", "") not in ("", "0", "false",
                                                        "False")


def _caller_site() -> str:
    """Construction/acquisition site label: nearest frame outside this
    module and threading.py internals."""
    f = sys._getframe(2)
    while f is not None:
        name = os.path.basename(f.f_code.co_filename)
        if name not in _SKIP_BASENAMES:
            parts = f.f_code.co_filename.replace(os.sep, "/").split("/")
            return "/".join(parts[-2:]) + f":{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


# ---------------------------------------------------------------------------
# Bookkeeping
# ---------------------------------------------------------------------------

class _Held:
    __slots__ = ("label", "oid", "site", "count")

    def __init__(self, label: str, oid: int, site: str):
        self.label = label
        self.oid = oid    # id() of the raw primitive: re-entry detection
        self.site = site
        self.count = 1


def _record_finding(rule: str, site: str, message: str, key) -> None:
    with _state.lock:
        if key in _state.reported:
            return
        _state.reported.add(key)
        path, _, line = site.rpartition(":")
        try:
            lineno = int(line)
        except ValueError:
            path, lineno = site, 0
        finding = Finding(rule=rule, path=path or site, line=lineno, col=1,
                          message=message, source="witness")
        _state.findings.append(finding)
    _publish(finding)
    if _state.raise_on_violation:
        raise LockOrderViolation(finding.format())


def _publish(finding: Finding) -> None:
    """Best-effort surfacing: log, core.analysis_reports(), Timeline
    WITNESS instant.  Never raises into the instrumented program."""
    try:
        from ..utils import get_logger
        get_logger().error("HVD_SANITIZE: %s", finding.format())
    except Exception:
        pass
    try:
        from .. import core as _core
        st = _core._state
        report = next((r for r in st.analysis_reports
                       if isinstance(r, WitnessReport)), None)
        if report is None:
            report = WitnessReport()
            st.analysis_reports.append(report)
        report.findings.append(finding)
        tl = st.timeline
        if tl is not None:
            tl.witness_event(finding.rule, finding.path, finding.line,
                             threading.current_thread().name)
    except Exception:
        pass


class WitnessReport:
    """analysis_reports() entry mirroring JaxprReport's surface."""

    label = "lock-witness"

    def __init__(self):
        self.findings: List[Finding] = []

    def ok(self) -> bool:
        return not self.findings


def _note_acquire(label: str, oid: int) -> None:
    held = _state.held()
    for h in held:
        if h.oid == oid:
            h.count += 1          # re-entrant (RLock): no order edge
            return
    site = _caller_site()
    pending = None
    if held:
        tname = threading.current_thread().name
        # Collect under the state lock, report after releasing it
        # (_record_finding re-takes it; the state lock is a plain,
        # non-reentrant raw lock).
        with _state.lock:
            for h in held:
                if h.label == label:
                    # Distinct instances of the same witness class (two
                    # locks from one construction site): no self-edge.
                    continue
                key = (h.label, label)
                if key not in _state.graph:
                    _state.graph[key] = (site, tname)
                inv = _state.graph.get((label, h.label))
                if inv is not None and pending is None:
                    dedup = ("HVD210", frozenset((h.label, label)))
                    if dedup not in _state.reported:
                        inv_site, inv_thread = inv
                        pending = (dedup, site, (
                            f"lock-order inversion: '{label}' acquired at "
                            f"{site} (thread {tname}) while holding "
                            f"'{h.label}' (acquired {h.site}), but the "
                            f"opposite order '{h.label}'-after-'{label}' "
                            f"was witnessed at {inv_site} (thread "
                            f"{inv_thread}) — an HVD200 AB/BA deadlock "
                            f"observed live"))
    held.append(_Held(label, oid, site))
    if pending is not None:
        _record_finding("HVD210", pending[1], pending[2], pending[0])


def _note_release(oid: int) -> None:
    held = _state.held()
    for i in range(len(held) - 1, -1, -1):
        if held[i].oid == oid:
            held[i].count -= 1
            if held[i].count <= 0:
                del held[i]
            return


# Thread-lifecycle internals whose timeout-less waits are benign by
# construction (Thread.start's _started.wait is always promptly set by
# the child; join waits are the caller's explicit choice surfaced by
# HVD201 statically).  User-level Event.wait goes through threading.py's
# "wait" frame only, which is NOT in this set — it stays checked.
_THREADING_LIFECYCLE_FNS = {"start", "join", "_wait_for_tstate_lock",
                            "_bootstrap", "_bootstrap_inner", "_stop"}


def _wait_is_threading_internal() -> bool:
    f = sys._getframe(2)
    while f is not None:
        name = os.path.basename(f.f_code.co_filename)
        if name == "witness.py":
            f = f.f_back
            continue
        if name != "threading.py":
            return False
        if f.f_code.co_name in _THREADING_LIFECYCLE_FNS:
            return True
        f = f.f_back
    return False


def _check_naked_wait(own_label: Optional[str], timeout) -> None:
    if timeout is not None:
        return
    held = _state.held()
    others = [h for h in held if h.label != own_label]
    if not others:
        return
    if _wait_is_threading_internal():
        return
    site = _caller_site()
    locks = ", ".join(sorted(h.label for h in others))
    _record_finding(
        "HVD211", site,
        f"timeout-less wait at {site} while holding {locks} — the wait "
        f"releases only its own lock; the other lock is held until a "
        f"wakeup that may never come",
        ("HVD211", site))


# ---------------------------------------------------------------------------
# Instrumented lock types
# ---------------------------------------------------------------------------

class SanitizedLock:
    """threading.Lock/RLock stand-in with witness bookkeeping."""

    def __init__(self, raw, label: str):
        self._raw = raw
        self._witness_label = label

    def acquire(self, blocking=True, timeout=-1):
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            try:
                _note_acquire(self._witness_label, id(self._raw))
            except LockOrderViolation:
                # HVD_RACE_RAISE debug mode: the with-statement's
                # __exit__ never runs when __enter__ raises — undo the
                # acquisition or the raw lock is held forever.
                _note_release(id(self._raw))
                self._raw.release()
                raise
        return ok

    def release(self):
        self._raw.release()
        _note_release(id(self._raw))

    def locked(self):
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<SanitizedLock {self._witness_label} {self._raw!r}>"

    # stdlib Condition integration (it probes these on custom locks).
    def _is_owned(self):
        if hasattr(self._raw, "_is_owned"):
            return self._raw._is_owned()
        if self._raw.acquire(False):
            self._raw.release()
            return False
        return True

    def _release_save(self):
        _note_release(id(self._raw))
        if hasattr(self._raw, "_release_save"):
            return self._raw._release_save()
        self._raw.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._raw, "_acquire_restore"):
            self._raw._acquire_restore(state)
        else:
            self._raw.acquire()
        _note_acquire(self._witness_label, id(self._raw))


class SanitizedRLock(SanitizedLock):
    def locked(self):  # RLocks have no .locked() pre-3.12
        locked = getattr(self._raw, "locked", None)
        return locked() if callable(locked) else False


class SanitizedCondition:
    """threading.Condition stand-in: a real Condition over the underlying
    raw lock, with witness bookkeeping and the HVD211 naked-wait check.
    The condition shares its lock's witness identity (a Condition IS its
    lock plus a wait queue)."""

    def __init__(self, lock=None, label: Optional[str] = None):
        if lock is None:
            lock = SanitizedRLock(_REAL_RLOCK(),
                                  label or _caller_site())
        if isinstance(lock, SanitizedLock):
            self._wrapped = lock
        else:
            self._wrapped = SanitizedLock(lock, label or _caller_site())
        self._witness_label = self._wrapped._witness_label
        # The real Condition drives the RAW lock so its _release_save /
        # _is_owned semantics stay exactly stdlib's.
        self._cond = _REAL_CONDITION(self._wrapped._raw)

    def acquire(self, *args, **kwargs):
        ok = self._wrapped._raw.acquire(*args, **kwargs)
        if ok:
            try:
                _note_acquire(self._witness_label,
                              id(self._wrapped._raw))
            except LockOrderViolation:
                _note_release(id(self._wrapped._raw))
                self._wrapped._raw.release()
                raise
        return ok

    def release(self):
        self._wrapped._raw.release()
        _note_release(id(self._wrapped._raw))

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout=None):
        _check_naked_wait(self._witness_label, timeout)
        _note_release(id(self._wrapped._raw))
        try:
            return self._cond.wait(timeout)
        finally:
            _note_acquire(self._witness_label, id(self._wrapped._raw))

    def wait_for(self, predicate, timeout=None):
        _check_naked_wait(self._witness_label, timeout)
        _note_release(id(self._wrapped._raw))
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            _note_acquire(self._witness_label, id(self._wrapped._raw))

    def notify(self, n=1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()

    notifyAll = notify_all

    def __repr__(self):
        return f"<SanitizedCondition {self._witness_label}>"


# ---------------------------------------------------------------------------
# Factories + installer
# ---------------------------------------------------------------------------

def make_lock(label: Optional[str] = None) -> SanitizedLock:
    return SanitizedLock(_REAL_LOCK(), label or _caller_site())


def make_rlock(label: Optional[str] = None) -> SanitizedRLock:
    return SanitizedRLock(_REAL_RLOCK(), label or _caller_site())


def make_condition(lock=None,
                   label: Optional[str] = None) -> SanitizedCondition:
    return SanitizedCondition(lock, label=label)


def install(raise_on_violation: Optional[bool] = None) -> bool:
    """Monkey-patch ``threading.Lock``/``RLock``/``Condition`` so every
    lock constructed from here on is witness-wrapped.  Idempotent;
    returns True when the patch is active after the call."""
    with _state.lock:
        if _state.installed:
            return True
        _state.originals = {
            "Lock": threading.Lock,
            "RLock": threading.RLock,
            "Condition": threading.Condition,
        }
        _state.installed = True
        _state.raise_on_violation = (
            raise_on_violation if raise_on_violation is not None
            else _raise_enabled())
    threading.Lock = make_lock
    threading.RLock = make_rlock
    threading.Condition = make_condition
    return True


def uninstall() -> None:
    """Restore the real factories (already-wrapped locks keep working —
    the wrappers delegate to real primitives)."""
    with _state.lock:
        if not _state.installed:
            return
        originals = _state.originals
        _state.installed = False
        _state.originals = {}
    threading.Lock = originals["Lock"]
    threading.RLock = originals["RLock"]
    threading.Condition = originals["Condition"]


def maybe_install_from_env() -> bool:
    """Install iff ``HVD_SANITIZE`` is set (serve CLI / conftest hook).
    Off by default: one env read, no patching."""
    if not enabled():
        return False
    return install()


def installed() -> bool:
    return _state.installed


def reset() -> None:
    """Clear the witness graph and findings (test isolation).  Held-lock
    state is per-thread and self-clearing; the graph is global."""
    with _state.lock:
        _state.graph.clear()
        _state.findings.clear()
        _state.reported.clear()


def findings() -> List[Finding]:
    with _state.lock:
        return list(_state.findings)


def order_graph() -> Dict[Tuple[str, str], Tuple[str, str]]:
    """Snapshot of the observed acquisition-order graph (diagnostics)."""
    with _state.lock:
        return dict(_state.graph)


def declare_order(first: str, second: str) -> None:
    """Pre-seed the canonical order for a pair of lock sites (the runtime
    analog of the static ``# hvdrace: order=a<b`` pragma): a later
    observation of the opposite order fires HVD210 even if the declared
    direction is never actually witnessed."""
    with _state.lock:
        _state.graph.setdefault((first, second), ("<declared>", "-"))
