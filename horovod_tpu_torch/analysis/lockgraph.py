"""hvdrace static half: lock-order & thread-lifecycle analysis (HVD20x).

Copied from ``horovod_tpu/analysis/lockgraph.py``; the one change is the
HVD201 arm for a compiled step, which reads the port's traced-function
marking (``torch.compile``, rules.py).

The serve/elastic control plane is a heavily threaded system whose two
worst historical bugs were concurrency bugs found by hand: the
batcher-lock/metrics-lock AB/BA deadlock and the revived-engine
duplicate-loop thread leak.  This module reports those classes
statically, in the spirit of FreeBSD's WITNESS lock-order checker and
ThreadSanitizer, adapted to pure-Python control-plane code:

* **HVD200** — lock-order cycle.  Locks are identified by their
  *creation site class* (``DynamicBatcher._lock``), so two instances of
  the same class share an identity, exactly like WITNESS lock classes.
  An edge A→B means "some path acquires B while holding A"; edges are
  collected per function and closed over the same- and known-class call
  graph (``self.method()``, ``self.attr.method()`` where ``attr``'s
  class is statically known, bare in-module calls).  A cycle in the
  global graph is a potential deadlock; the finding prints one witness
  path per direction.
* **HVD201** — blocking call (KV/HTTP transport, subprocess,
  ``time.sleep``, ``Thread.join``, in-module ``torch.compile``'d
  function) while holding a lock.
* **HVD202** — callback/user-hook (``on_*`` / ``*_fn`` / ``*_callback``
  / ``*_hook`` attributes or registered-callable containers) invoked
  while holding a lock — the exact shape of the batcher's ``on_shed`` deadlock.
* **HVD203** — non-daemon ``threading.Thread`` with no tracked
  ``join()`` on any stop/close path.

Declared orders: ``# hvdrace: order=A<B`` (comment token anywhere in an
analyzed file; lock names as the findings print them) declares that A is
*intended* to be acquired before B.  A declared pair does not silence a
cycle — it re-attributes it: the report points at the acquisition that
INVERTS the declaration, and a single observed B-while-holding-A edge
fires even when the analyzer cannot see the matching A→B path.
Contradictory declarations (both directions) are themselves reported.
Per-line ``# hvdlint: disable=HVD200`` pragmas work as in the linter for
the rare over-approximation false positive.

Like the linter, this module is stdlib-only (ast + tokenize) and never
raises on user input: unparseable files surface as HVD000 findings.
"""

from __future__ import annotations

import ast
import os
import re
import tokenize
import io
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding
from . import rules as _rules
from .rules import _dotted

# Lock constructors (threading module factories/classes).  Semaphores
# gate counts rather than exclusive regions but still order-deadlock.
LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition",
              "Semaphore": "lock", "BoundedSemaphore": "lock"}

# Method-name tables for HVD201 (blocking while holding a lock).
_BLOCKING_SLEEP = {"sleep"}
_BLOCKING_SUBPROCESS = {"run", "call", "check_output", "check_call",
                        "Popen", "communicate"}
_BLOCKING_HTTP = {"urlopen", "getresponse", "request", "create_connection"}
_HTTPISH_BASES = ("http", "conn", "sock", "client", "session", "url")

_CALLBACK_NAME = re.compile(
    r"(^on_)|(^_on_)|(_cb$)|(_callback$)|(_callbacks$)|(_hook$)|(_hooks$)"
    r"|(_fn$)|(_fns$)|(^callback)|(^hook)")

_STOPPISH = re.compile(
    r"stop|close|shutdown|teardown|finalize|terminate|join|__exit__|__del__",
    re.IGNORECASE)

_ORDER_PRAGMA = re.compile(
    r"#\s*hvdrace:\s*order\s*=\s*([A-Za-z0-9_.:]+)\s*<\s*([A-Za-z0-9_.:]+)")


def _is_kv_request(dotted: str) -> bool:
    """A KV-transport verb through a base that is recognizably a CLIENT
    (narrower than HVD009's any-'kv'-base: ``kv_stats.get(...)`` is a
    dict read and ``self.rendezvous.put(...)`` an in-process server
    write, not round-trips — the dogfood runs' false positives)."""
    parts = dotted.split(".")
    if len(parts) < 2 or parts[-1] not in _rules.KV_TRANSPORT_FNS:
        return False
    return any("client" in p.lower() or p.lower() == "kv"
               for p in parts[:-1])


# ---------------------------------------------------------------------------
# Per-module model
# ---------------------------------------------------------------------------

class _LockInfo:
    """One lock identity: ``Class.attr`` or ``module:NAME``."""

    def __init__(self, label: str, kind: str, path: str, line: int):
        self.label = label
        self.kind = kind  # lock | rlock | condition
        self.path = path
        self.line = line


class _ClassInfo:
    def __init__(self, name: str, node: ast.ClassDef, module: "_ModuleInfo"):
        self.name = name
        self.node = node
        self.module = module
        self.methods: Dict[str, ast.AST] = {}
        self.lock_attrs: Dict[str, _LockInfo] = {}   # attr -> lock
        self.lock_alias: Dict[str, str] = {}         # cond attr -> lock attr
        self.attr_class: Dict[str, str] = {}         # attr -> class name
        self.joined_attrs: Set[str] = set()          # attrs .join()ed

    def lock_for_attr(self, attr: str) -> Optional[_LockInfo]:
        attr = self.lock_alias.get(attr, attr)
        return self.lock_attrs.get(attr)


class _ModuleInfo:
    def __init__(self, tree: ast.Module, path: str, source: str):
        self.tree = tree
        self.path = path
        self.source = source
        self.classes: Dict[str, _ClassInfo] = {}
        self.functions: Dict[str, ast.AST] = {}
        self.module_locks: Dict[str, _LockInfo] = {}  # global name -> lock
        self.declared_orders: List[Tuple[str, str, int]] = []
        # rules._Module gives traced-function marking for the compiled
        # arm of HVD201 (same syntactic closure the traced-fn detector
        # uses).
        try:
            self.rules_mod = _rules._Module(tree, path)
        except RecursionError:  # pragma: no cover - pathological nesting
            self.rules_mod = None

    @property
    def label(self) -> str:
        return os.path.splitext(os.path.basename(self.path))[0]


def _lock_ctor(call: ast.Call) -> Optional[str]:
    dotted = _dotted(call.func)
    if not dotted:
        return None
    parts = dotted.split(".")
    last = parts[-1]
    if last not in LOCK_CTORS:
        return None
    # Accept bare (from threading import Lock) and threading.Lock; reject
    # e.g. multiprocessing.Condition?  Same semantics — accept any base.
    return LOCK_CTORS[last]


def _unwrap_value(value: ast.AST) -> ast.AST:
    """Peel ``x or Ctor()`` / ``Ctor() if c else y`` down to the Call arm
    (common default-argument idioms for owned sub-objects)."""
    if isinstance(value, ast.BoolOp):
        for v in value.values:
            if isinstance(v, ast.Call):
                return v
    if isinstance(value, ast.IfExp):
        for v in (value.body, value.orelse):
            if isinstance(v, ast.Call):
                return v
    return value


def _annotation_names(node: ast.AST) -> List[str]:
    """Class names referenced by a parameter annotation, including string
    annotations and Optional[...]/"..." forms."""
    names: List[str] = []
    if node is None:
        return names
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return names
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            names.append(sub.id)
        elif isinstance(sub, ast.Attribute):
            names.append(sub.attr)
    return names


def _index_module(tree: ast.Module, path: str, source: str) -> _ModuleInfo:
    mod = _ModuleInfo(tree, path, source)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            ci = _ClassInfo(node.name, node, mod)
            mod.classes[node.name] = ci
            _index_class(ci)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions[node.name] = node
        elif isinstance(node, ast.Assign):
            value = _unwrap_value(node.value)
            if isinstance(value, ast.Call):
                kind = _lock_ctor(value)
                if kind:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            mod.module_locks[tgt.id] = _LockInfo(
                                f"{mod.label}:{tgt.id}", kind, path,
                                node.lineno)
    mod.declared_orders = _parse_order_pragmas(source)
    return mod


def _index_class(ci: _ClassInfo) -> None:
    # Class-body assignments (e.g. batcher._Counter.lock) count as lock
    # attrs too; methods indexed for call resolution.
    for node in ci.node.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ci.methods[node.name] = node
        elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call):
            kind = _lock_ctor(node.value)
            if kind:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        ci.lock_attrs[tgt.id] = _LockInfo(
                            f"{ci.name}.{tgt.id}", kind,
                            ci.module.path, node.lineno)
    # self.X = ... assignments anywhere in the class body (mostly
    # __init__): locks, condition aliases, attribute classes, threads.
    ann: Dict[str, List[str]] = {}
    init = ci.methods.get("__init__")
    if init is not None:
        args = init.args
        for a in list(args.posonlyargs) + list(args.args) + \
                list(args.kwonlyargs):
            names = _annotation_names(a.annotation)
            if names:
                ann[a.arg] = names
    for node in ast.walk(ci.node):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "join":
                root = node.func.value
                if isinstance(root, ast.Attribute) and \
                        isinstance(root.value, ast.Name) and \
                        root.value.id in ("self", "cls"):
                    ci.joined_attrs.add(root.attr)
            continue
        value = _unwrap_value(node.value)
        for tgt in targets:
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id in ("self", "cls")):
                continue
            attr = tgt.attr
            if isinstance(value, ast.Call):
                dotted = _dotted(value.func)
                last = dotted.split(".")[-1] if dotted else ""
                kind = _lock_ctor(value)
                if kind:
                    if kind == "condition" and value.args and \
                            isinstance(value.args[0], ast.Attribute) and \
                            isinstance(value.args[0].value, ast.Name) and \
                            value.args[0].value.id == "self":
                        # Condition(self._lock): SAME lock identity.
                        ci.lock_alias[attr] = value.args[0].attr
                    elif attr not in ci.lock_attrs:
                        ci.lock_attrs[attr] = _LockInfo(
                            f"{ci.name}.{attr}", kind,
                            ci.module.path, node.lineno)
                elif last and last[0].isupper() and last != "Thread":
                    ci.attr_class.setdefault(attr, last)
            elif isinstance(value, ast.Name):
                # self.X = param — resolvable via annotation only.
                for name in ann.get(value.id, ()):
                    if name and name[0].isupper() and \
                            name not in ("Optional", "None"):
                        ci.attr_class.setdefault(attr, name)
                        break


def _parse_order_pragmas(source: str) -> List[Tuple[str, str, int]]:
    out: List[Tuple[str, str, int]] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError, ValueError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _ORDER_PRAGMA.search(tok.string)
        if m:
            out.append((m.group(1), m.group(2), tok.start[0]))
    return out


# ---------------------------------------------------------------------------
# Per-function lock-region walk
# ---------------------------------------------------------------------------

class _Frame:
    """One acquisition/call site for witness-path printing."""

    def __init__(self, path: str, line: int, fn: str, what: str):
        self.path, self.line, self.fn, self.what = path, line, fn, what

    def format(self) -> str:
        return f"{self.path}:{self.line} ({self.fn}) {self.what}"


class _FnSummary:
    def __init__(self, qualname: str, path: str):
        self.qualname = qualname
        self.path = path
        # Locks this function acquires directly: (lock, line, held_at_entry
        # relative) — ordered edges come from the nesting walk below.
        self.acquires: List[Tuple[_LockInfo, int]] = []
        # (callee key, held locks snapshot, line)
        self.calls: List[Tuple[str, Tuple[_LockInfo, ...], int]] = []
        # Direct lock-order edges: (outer, inner, line)
        self.edges: List[Tuple[_LockInfo, _LockInfo, int]] = []
        # HVD200 self-deadlock candidates handled in the walk directly.


class _Analyzer:
    """Whole-run state: every module, the cross-module class registry, the
    global lock graph, and the findings."""

    def __init__(self):
        self.modules: List[_ModuleInfo] = []
        self.classes: Dict[str, List[_ClassInfo]] = {}
        self.findings: List[Finding] = []
        self.summaries: Dict[str, _FnSummary] = {}
        # lock label -> representative frame of first sighting
        self.lock_sites: Dict[str, _LockInfo] = {}
        # (A label, B label) -> witness path (list of _Frame)
        self.graph: Dict[Tuple[str, str], List[_Frame]] = {}
        self.lock_kinds: Dict[str, str] = {}
        self.declared: Dict[Tuple[str, str], Tuple[str, int]] = {}

    # -- loading -----------------------------------------------------------

    def add_module(self, tree: ast.Module, path: str, source: str) -> None:
        mod = _index_module(tree, path, source)
        self.modules.append(mod)
        for name, ci in mod.classes.items():
            self.classes.setdefault(name, []).append(ci)

    def resolve_class(self, name: str,
                      prefer: Optional[_ModuleInfo] = None) \
            -> Optional[_ClassInfo]:
        cands = self.classes.get(name, [])
        if not cands:
            return None
        if prefer is not None:
            same = [c for c in cands if c.module is prefer]
            if same:
                return same[0]
        return cands[0] if len(cands) == 1 else None

    # -- analysis ----------------------------------------------------------

    def run(self) -> List[Finding]:
        for mod in self.modules:
            for ci in mod.classes.values():
                for mname, fn in ci.methods.items():
                    self._walk_function(mod, ci, fn,
                                        f"{ci.name}.{mname}")
            for fname, fn in mod.functions.items():
                self._walk_function(mod, None, fn, fname)
            self._check_threads(mod)
            for a, b, line in mod.declared_orders:
                key = (a, b)
                if key not in self.declared:
                    self.declared[key] = (mod.path, line)
        self._close_call_graph()
        self._check_cycles()
        self._dedup_sort()
        return self.findings

    def emit(self, rule: str, path: str, line: int, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=path, line=line, col=1, message=message,
            source="race"))

    # -- lock resolution ---------------------------------------------------

    def _resolve_lock(self, mod: _ModuleInfo, ci: Optional[_ClassInfo],
                      expr: ast.AST) -> Optional[_LockInfo]:
        """Lock identity of an expression used in ``with``/acquire():
        ``self._lock`` / ``cls.lock`` / module-level ``NAME`` /
        ``self.attr._lock`` (attr of known class)."""
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name) and base.id in ("self", "cls") \
                    and ci is not None:
                return ci.lock_for_attr(expr.attr)
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id in ("self", "cls") and ci is not None:
                owner = self.resolve_class(
                    ci.attr_class.get(base.attr, ""), prefer=mod)
                if owner is not None:
                    return owner.lock_for_attr(expr.attr)
            if isinstance(base, ast.Name):
                owner = None
                cls = self.resolve_class(base.id, prefer=mod)
                if cls is not None:  # ClassName.lock class attribute
                    owner = cls
                if owner is not None:
                    return owner.lock_for_attr(expr.attr)
        elif isinstance(expr, ast.Name):
            return mod.module_locks.get(expr.id)
        return None

    def _resolve_callee(self, mod: _ModuleInfo, ci: Optional[_ClassInfo],
                        call: ast.Call) -> Optional[str]:
        """Summary key of a statically-resolvable callee, or None."""
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in mod.functions:
                return f"{mod.path}::{func.id}"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        base = func.value
        if isinstance(base, ast.Name) and base.id in ("self", "cls") \
                and ci is not None:
            if func.attr in ci.methods:
                return f"{ci.module.path}::{ci.name}.{func.attr}"
            return None
        # self.attr.method() with attr of known class (possibly imported
        # from another analyzed module).
        if isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name) and \
                base.value.id in ("self", "cls") and ci is not None:
            owner = self.resolve_class(
                ci.attr_class.get(base.attr, ""), prefer=mod)
            if owner is not None and func.attr in owner.methods:
                return f"{owner.module.path}::{owner.name}.{func.attr}"
        return None

    # -- the function walk -------------------------------------------------

    def _walk_function(self, mod: _ModuleInfo, ci: Optional[_ClassInfo],
                       fn: ast.AST, qualname: str) -> None:
        key = f"{mod.path}::{qualname}"
        summary = _FnSummary(qualname, mod.path)
        self.summaries[key] = summary
        held: List[Tuple[_LockInfo, int]] = []

        def register(lock: _LockInfo, line: int) -> None:
            self.lock_sites.setdefault(lock.label, lock)
            self.lock_kinds.setdefault(lock.label, lock.kind)
            for outer, oline in held:
                if outer.label == lock.label:
                    if lock.kind != "rlock":
                        self.emit(
                            "HVD200", mod.path, line,
                            f"'{lock.label}' re-acquired at line {line} "
                            f"while already held (line {oline}) in "
                            f"{qualname} — a non-reentrant "
                            f"{lock.kind} self-deadlocks here")
                    return
            summary.acquires.append((lock, line))
            for outer, _ in held:
                summary.edges.append((outer, lock, line))

        def handle_call(node: ast.Call) -> None:
            callee = self._resolve_callee(mod, ci, node)
            if callee is not None:
                summary.calls.append(
                    (callee, tuple(l for l, _ in held), node.lineno))
            if held:
                self._check_blocking(mod, ci, node, qualname,
                                     [l for l, _ in held])
                self._check_callback(mod, ci, node, qualname,
                                     [l for l, _ in held])

        def walk(nodes: Iterable[ast.AST]) -> None:
            for node in nodes:
                self._walk_stmt(node, mod, ci, held, register,
                                handle_call, walk)

        body = fn.body if isinstance(fn.body, list) else [fn.body]
        walk(body)

    def _walk_stmt(self, node: ast.AST, mod, ci, held, register,
                   handle_call, walk) -> None:
        if isinstance(node, ast.With) or isinstance(node, ast.AsyncWith):
            acquired: List[_LockInfo] = []
            for item in node.items:
                lock = self._resolve_lock(mod, ci, item.context_expr)
                # Also descend into the context expressions themselves
                # (calls inside them run before acquisition).
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Call):
                        handle_call(sub)
                if lock is not None:
                    register(lock, node.lineno)
                    if not any(h.label == lock.label for h, _ in held):
                        held.append((lock, node.lineno))
                        acquired.append(lock)
            walk(node.body)
            for lock in acquired:
                for i in range(len(held) - 1, -1, -1):
                    if held[i][0].label == lock.label:
                        del held[i]
                        break
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return  # nested scopes walked separately (methods) or skipped
        # Compound statements recurse through the walker so a `with`
        # nested inside them still registers its acquisition (the
        # generic fallthrough below only scans calls).
        if isinstance(node, (ast.If, ast.While)):
            for sub in ast.walk(node.test):
                if isinstance(sub, ast.Call):
                    handle_call(sub)
            walk(node.body)
            walk(node.orelse)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            for sub in ast.walk(node.iter):
                if isinstance(sub, ast.Call):
                    handle_call(sub)
            walk(node.body)
            walk(node.orelse)
            return
        if isinstance(node, ast.Try):
            walk(node.body)
            for handler in node.handlers:
                walk(handler.body)
            walk(node.orelse)
            walk(node.finalbody)
            return
        if hasattr(ast, "Match") and isinstance(node, ast.Match):
            for sub in ast.walk(node.subject):
                if isinstance(sub, ast.Call):
                    handle_call(sub)
            for case in node.cases:
                walk(case.body)
            return
        # acquire()/release() pairs: flow-insensitive within a statement
        # list — acquire() pushes, release() pops the matching lock.
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            if isinstance(call.func, ast.Attribute) and \
                    call.func.attr in ("acquire", "release"):
                lock = self._resolve_lock(mod, ci, call.func.value)
                if lock is not None:
                    if call.func.attr == "acquire":
                        register(lock, node.lineno)
                        if not any(h.label == lock.label for h, _ in held):
                            held.append((lock, node.lineno))
                    else:
                        for i in range(len(held) - 1, -1, -1):
                            if held[i][0].label == lock.label:
                                del held[i]
                                break
                    return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                handle_call(sub)

    # -- HVD201 / HVD202 ---------------------------------------------------

    def _check_blocking(self, mod: _ModuleInfo, ci, call: ast.Call,
                        qualname: str, held: List[_LockInfo]) -> None:
        dotted = _dotted(call.func)
        if not dotted:
            return
        parts = dotted.split(".")
        last = parts[-1]
        what = None
        if last in _BLOCKING_SLEEP and parts[0] in ("time", "sleep"):
            what = f"'{dotted}' sleeps"
        elif last in _BLOCKING_SUBPROCESS and parts[0] == "subprocess":
            what = f"'{dotted}' runs a subprocess"
        elif _is_kv_request(dotted):
            what = f"KV-transport call '{dotted}' does a network round-trip"
        elif last in _BLOCKING_HTTP and (
                len(parts) == 1 or
                any(b in p.lower() for p in parts[:-1]
                    for b in _HTTPISH_BASES) or parts[0] in
                ("urllib", "requests", "socket")):
            what = f"HTTP/socket call '{dotted}' blocks on the network"
        elif last == "join" and len(parts) >= 2 and (
                "thread" in parts[-2].lower() or parts[-2] in ("t", "th")):
            what = f"'{dotted}()' joins a thread"
        elif isinstance(call.func, ast.Name) and mod.rules_mod is not None:
            for fdef in mod.rules_mod.funcs_by_name.get(call.func.id, ()):
                if fdef in mod.rules_mod.traced:
                    what = (f"'{dotted}' is torch.compile'd — first call "
                            f"compiles for seconds")
                    break
        if what is None:
            return
        locks = ", ".join(sorted(l.label for l in held))
        self.emit("HVD201", mod.path, call.lineno,
                  f"{what} while {qualname} holds {locks}; every thread "
                  f"needing that lock stalls for the call's full latency")

    def _check_callback(self, mod: _ModuleInfo, ci, call: ast.Call,
                        qualname: str, held: List[_LockInfo]) -> None:
        func = call.func
        name = None
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and \
                func.value.id in ("self", "cls"):
            name = func.attr
        elif isinstance(func, ast.Name):
            name = func.id
        elif isinstance(func, ast.Subscript):
            root = func.value
            if isinstance(root, ast.Attribute):
                name = root.attr
            elif isinstance(root, ast.Name):
                name = root.id
        if name is None or not _CALLBACK_NAME.search(name):
            return
        if (ci is not None and name in ci.methods) or \
                name in mod.functions:
            return  # a real, resolvable callee that happens to match
        locks = ", ".join(sorted(l.label for l in held))
        self.emit("HVD202", mod.path, call.lineno,
                  f"callback '{name}' invoked while {qualname} holds "
                  f"{locks} — the callee is arbitrary code that may take "
                  f"its own lock (the batcher on_shed deadlock shape); "
                  f"collect callbacks under the lock, fire them after "
                  f"release")

    # -- interprocedural closure -------------------------------------------

    def _close_call_graph(self) -> None:
        """Transitive may-acquire sets per function, then cross-call
        edges: caller holds H at a call whose callee may acquire M ⇒
        edge H→M (witness path: caller site + callee chain)."""
        acq_cache: Dict[str, Dict[str, List[_Frame]]] = {}

        def acq(key: str, stack: Set[str]) -> Dict[str, List[_Frame]]:
            if key in acq_cache:
                return acq_cache[key]
            if key in stack:
                return {}
            stack.add(key)
            summary = self.summaries.get(key)
            out: Dict[str, List[_Frame]] = {}
            if summary is not None:
                for lock, line in summary.acquires:
                    out.setdefault(lock.label, [_Frame(
                        summary.path, line, summary.qualname,
                        f"acquires {lock.label}")])
                for callee, _held, line in summary.calls:
                    for label, chain in acq(callee, stack).items():
                        if label not in out:
                            out[label] = [_Frame(
                                summary.path, line, summary.qualname,
                                f"calls {callee.split('::')[-1]}")] + chain
            stack.discard(key)
            acq_cache[key] = out
            return out

        for key, summary in self.summaries.items():
            # Direct edges first.
            for outer, inner, line in summary.edges:
                self._add_edge(outer.label, inner.label, [
                    _Frame(summary.path, line, summary.qualname,
                           f"acquires {inner.label} while holding "
                           f"{outer.label}")])
            # Call-mediated edges.
            for callee, held, line in summary.calls:
                if not held:
                    continue
                reachable = acq(callee, set())
                for label, chain in reachable.items():
                    for h in held:
                        if h.label != label:
                            self._add_edge(h.label, label, [
                                _Frame(summary.path, line,
                                       summary.qualname,
                                       f"holding {h.label}, calls "
                                       f"{callee.split('::')[-1]}")
                            ] + chain)
                        elif self.lock_kinds.get(label) != "rlock":
                            self.emit(
                                "HVD200", summary.path, line,
                                f"{summary.qualname} holds '{label}' and "
                                f"calls {callee.split('::')[-1]}, which "
                                f"re-acquires it (path: " +
                                " -> ".join(f.format() for f in chain) +
                                f") — a non-reentrant lock self-deadlocks")

    def _add_edge(self, a: str, b: str, path: List[_Frame]) -> None:
        key = (a, b)
        if key not in self.graph:
            self.graph[key] = path

    # -- cycle detection ---------------------------------------------------

    def _check_cycles(self) -> None:
        # Declared-order inversions: a single observed edge B→A with a
        # declaration A<B is reported even without an observed A→B path
        # (the declaration IS the other witness).
        reported: Set[frozenset] = set()
        for (b, a), path in sorted(self.graph.items()):
            decl = self.declared.get((a, b))
            if decl is None:
                continue
            pair = frozenset((a, b))
            if pair in reported:
                continue
            reported.add(pair)
            dpath, dline = decl
            self.emit(
                "HVD200", path[0].path, path[0].line,
                f"acquisition order {b} -> {a} inverts the declared "
                f"order '{a} < {b}' ({dpath}:{dline}); witness path: " +
                " -> ".join(f.format() for f in path))
        # Contradictory declarations.
        for (a, b), (dpath, dline) in sorted(self.declared.items()):
            if (b, a) in self.declared and a < b:
                opath, oline = self.declared[(b, a)]
                self.emit(
                    "HVD200", dpath, dline,
                    f"contradictory declared orders: '{a} < {b}' here but "
                    f"'{b} < {a}' at {opath}:{oline}")
        # Observed cycles (2-cycles and longer, via DFS over the edge
        # set); each unordered lock set reported once, with one witness
        # path per direction for the 2-cycle case.
        adj: Dict[str, List[str]] = {}
        for (a, b) in self.graph:
            adj.setdefault(a, []).append(b)
        for (a, b), path_ab in sorted(self.graph.items()):
            if (b, a) in self.graph:
                pair = frozenset((a, b))
                if pair in reported or a > b:
                    continue
                reported.add(pair)
                path_ba = self.graph[(b, a)]
                self.emit(
                    "HVD200", path_ab[0].path, path_ab[0].line,
                    f"lock-order cycle between {a} and {b} — "
                    f"path 1 ({a} then {b}): " +
                    " -> ".join(f.format() for f in path_ab) +
                    f"; path 2 ({b} then {a}): " +
                    " -> ".join(f.format() for f in path_ba) +
                    "; if both paths can run concurrently this deadlocks")
                # A disable pragma on EITHER witness head suppresses (the
                # "violating" direction of a cycle is a judgment call).
                self.findings[-1].alt_sites = [
                    (path_ba[0].path, path_ba[0].line)]
        # Longer cycles: DFS from each node with the 2-cycles removed
        # would over-report; a simple 3-cycle scan covers the practical
        # case without a full enumeration.
        labels = sorted(adj)
        for a in labels:
            for b in adj.get(a, ()):
                if b == a or frozenset((a, b)) in reported:
                    continue
                for c in adj.get(b, ()):
                    if c in (a, b):
                        continue
                    if (c, a) in self.graph:
                        trio = frozenset((a, b, c))
                        if trio in reported:
                            continue
                        if any(frozenset(p) in reported for p in
                               ((a, b), (b, c), (c, a))):
                            continue
                        reported.add(trio)
                        frames = (self.graph[(a, b)] +
                                  self.graph[(b, c)] +
                                  self.graph[(c, a)])
                        self.emit(
                            "HVD200", frames[0].path, frames[0].line,
                            f"lock-order cycle {a} -> {b} -> {c} -> {a}; "
                            f"witness: " +
                            " -> ".join(f.format() for f in frames))

    # -- HVD203: thread lifecycle ------------------------------------------

    def _check_threads(self, mod: _ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if not dotted or dotted.split(".")[-1] != "Thread":
                continue
            parts = dotted.split(".")
            if len(parts) > 1 and parts[-2] not in ("threading", "th"):
                continue
            if self._thread_ok(mod, node):
                continue
            self.emit(
                "HVD203", mod.path, node.lineno,
                "non-daemon Thread with no tracked join() on any "
                "stop/close path — interpreter exit blocks on it, and an "
                "exception between spawn and an in-line join leaks it; "
                "pass daemon=True or join the stored handle from every "
                "stop()/close() path")

    def _thread_ok(self, mod: _ModuleInfo, call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "daemon":
                if isinstance(kw.value, ast.Constant):
                    return bool(kw.value.value)
                return True  # dynamic daemon flag: benefit of the doubt
        # Not daemon: find what the Thread is bound to and whether that
        # binding is ever joined.
        rm = mod.rules_mod
        parent = rm.parents.get(call) if rm is not None else None
        # t.daemon = True after construction?
        target_attr = None
        target_name = None
        if isinstance(parent, ast.Assign):
            for tgt in parent.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id in ("self", "cls"):
                    target_attr = tgt.attr
                elif isinstance(tgt, ast.Name):
                    target_name = tgt.id
        elif isinstance(parent, (ast.List, ast.Tuple)):
            gp = rm.parents.get(parent) if rm is not None else None
            if isinstance(gp, ast.Assign):
                for tgt in gp.targets:
                    if isinstance(tgt, ast.Name):
                        target_name = tgt.id
        if target_attr is not None:
            # Joined anywhere in the OWNING class (stop/close paths are
            # the convention; any tracked join counts) — an unrelated
            # class joining its own same-named `_thread` must not
            # suppress this one's leak.
            owner = None
            cur = rm.parents.get(call) if rm is not None else None
            while cur is not None:
                if isinstance(cur, ast.ClassDef):
                    owner = mod.classes.get(cur.name)
                    break
                cur = rm.parents.get(cur)
            if owner is not None:
                return target_attr in owner.joined_attrs
            return any(target_attr in ci.joined_attrs
                       for ci in mod.classes.values())
        if target_name is not None and rm is not None:
            # Same-function .join( on the name, or `name.daemon = True`.
            fns = rm.enclosing_functions(call)
            scope = fns[0] if fns else mod.tree
            for sub in ast.walk(scope):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr == "join":
                    root = sub.func.value
                    if isinstance(root, ast.Name) and (
                            root.id == target_name):
                        return True
                    # for t in threads: t.join() over the stored list
                    if isinstance(root, ast.Name):
                        for loop in ast.walk(scope):
                            if isinstance(loop, ast.For) and \
                                    isinstance(loop.target, ast.Name) and \
                                    loop.target.id == root.id and \
                                    isinstance(loop.iter, ast.Name) and \
                                    loop.iter.id == target_name:
                                return True
                if isinstance(sub, ast.Assign):
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Attribute) and \
                                tgt.attr == "daemon" and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == target_name and \
                                isinstance(sub.value, ast.Constant) and \
                                sub.value.value:
                            return True
            return False
        # Fire-and-forget `Thread(...).start()` with no daemon flag.
        return False

    # -- ordering ----------------------------------------------------------

    def _dedup_sort(self) -> None:
        seen, out = set(), []
        for f in sorted(self.findings,
                        key=lambda f: (f.path, f.line, f.rule, f.message)):
            key = (f.rule, f.path, f.line, f.message)
            if key not in seen:
                seen.add(key)
                out.append(f)
        self.findings = out


# ---------------------------------------------------------------------------
# Public API (same shape as linter.lint_paths / lint_source)
# ---------------------------------------------------------------------------

def analyze_sources(sources: Sequence[Tuple[str, str]],
                    select: Sequence[str] = (),
                    ignore: Sequence[str] = ()) -> List[Finding]:
    """Race-analyze a set of ``(source, path)`` pairs as ONE program (the
    lock graph is global: serve's batcher lock and metrics lock live in
    different modules).  Returns suppression-filtered Findings."""
    from .linter import _parse_pragmas, _suppressed, _rule_selected

    analyzer = _Analyzer()
    findings: List[Finding] = []
    pragma_by_path: Dict[str, tuple] = {}
    for source, path in sources:
        try:
            tree = ast.parse(source, filename=path)
        except (SyntaxError, ValueError, RecursionError) as e:
            if _rule_selected("HVD000", select, ignore):
                line = getattr(e, "lineno", 0) or 0
                findings.append(Finding(
                    rule="HVD000", path=path, line=line,
                    col=max(getattr(e, "offset", 0) or 0, 1),
                    message=f"could not parse: {type(e).__name__}: {e}",
                    source="race"))
            continue
        analyzer.add_module(tree, path, source)
        pragma_by_path[path] = _parse_pragmas(source)
    findings.extend(analyzer.run())
    out: List[Finding] = []
    for f in findings:
        if not _rule_selected(f.rule, select, ignore):
            continue
        per_line, file_wide = pragma_by_path.get(f.path, ({}, set()))
        f.suppressed = _suppressed(f, per_line, file_wide)
        if not f.suppressed:
            # Cycle findings carry the other direction's witness head
            # (alt_sites); a pragma there suppresses too.
            for apath, aline in getattr(f, "alt_sites", ()):
                a_per_line, a_file_wide = pragma_by_path.get(
                    apath, ({}, set()))
                ids = a_per_line.get(aline, set()) | a_file_wide
                if "ALL" in ids or f.rule in ids:
                    f.suppressed = True
                    break
        out.append(f)
    return out


def analyze_source(source: str, path: str = "<string>",
                   select: Sequence[str] = (),
                   ignore: Sequence[str] = ()) -> List[Finding]:
    """Single-module convenience (corpus tests)."""
    return analyze_sources([(source, path)], select=select, ignore=ignore)


def analyze_paths(paths: Iterable[str], select: Sequence[str] = (),
                  ignore: Sequence[str] = ()) -> List[Finding]:
    """Race-analyze every .py file under the given files/directories as
    one global lock graph (CLI ``--race`` entry)."""
    from .linter import iter_python_files, _rule_selected

    findings: List[Finding] = []
    files: List[str] = []
    for path in paths:
        if not os.path.exists(path):
            if _rule_selected("HVD000", select, ignore):
                findings.append(Finding(
                    rule="HVD000", path=path, line=0, col=1,
                    message="path does not exist", source="race"))
        else:
            files.append(path)
    sources: List[Tuple[str, str]] = []
    for fpath in iter_python_files(files):
        try:
            with open(fpath, "rb") as fh:
                sources.append(
                    (fh.read().decode("utf-8", errors="replace"), fpath))
        except OSError as e:
            if _rule_selected("HVD000", select, ignore):
                findings.append(Finding(
                    rule="HVD000", path=fpath, line=0, col=1,
                    message=f"could not read file: {e}", source="race"))
    findings.extend(analyze_sources(sources, select=select, ignore=ignore))
    return findings
