"""AST rules HVD001-HVD011: distributed-training antipatterns.

Copied from ``horovod_tpu/analysis/rules.py``.  HVD001, HVD002, HVD006
and HVD009 keep the JAX package's logic; they also read torch's
spellings of a collective (``dist.all_reduce`` and the rest of
``torch.distributed``'s, through a ``dist`` base) and HVD006 the port's
axis keywords (``reduce_axes=``, ``expert_axis=``).  The traced-code
rules (HVD003, HVD004, HVD005, HVD007, HVD008) and the serving rules
(HVD010, HVD011) read torch's spellings: ``torch.compile`` (and
``torch.jit.script`` / ``trace``, ``torch.export.export``,
``torch.fx.symbolic_trace``) as the tracer, ``.item()`` / ``.cpu()`` /
``.tolist()`` / ``.numpy()`` / ``.synchronize()`` as the blocking syncs,
and ``torch.Generator`` / ``torch.manual_seed`` / ``torch.rand*`` as the
serving PRNG.

The rules encode, as source-level patterns, the failure classes the
reference framework only catches at runtime in the coordinator's
negotiation phase (controller.cc ComputeResponseList "Mismatched
allreduce" stalls) or never catches at all (rank-divergent trace
constants).  ``analyze(tree, path)`` runs every rule over one parsed
module and returns Findings; suppression comments are applied by the
linter (linter.py), not here.

Design notes:

* **Traced-function detection** is syntactic: a function is considered
  traced when it is (a) decorated by a known tracer (``torch.compile``,
  ``torch.compile(mode=...)``, ``partial(torch.compile, ...)``,
  ``torch.jit.script``), (b) passed by name or as a lambda into a
  tracer call (``torch.compile(f)``, ``torch.jit.trace(f, x)``), (c)
  lexically nested inside a traced function, or (d) called by name from
  inside a traced function (one-module call-graph closure, so
  ``torch.compile(lambda *a: local_step(*a))`` marks ``local_step``).
  Cross-module tracing is out of scope.  The port's ``shard_step`` and
  ``torch.utils.checkpoint`` run the function eagerly: they trace
  nothing.
* Rules only ever match syntactically-resolvable names (dotted
  attribute chains ending in a known collective / RNG / clock name);
  aliased imports (``from torch import compile as c``) are out of
  scope by design — cheap to evade, but lint is a seatbelt, not a
  cage.
* The HVD2xx lock-order / thread-lifecycle rules live in lockgraph.py:
  they need a GLOBAL cross-module lock graph, not the per-module pass
  this file implements (they reuse ``_Module``'s traced-fn closure and
  the name tables here).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set

from .findings import Finding

# -- name tables ------------------------------------------------------------

# jax.lax collective primitives (axis-name based): HVD006 reads them as the
# JAX package's linter does, so both give one verdict on one source.
LAX_COLLECTIVES = {
    "psum", "pmean", "pmax", "pmin", "ppermute", "pshuffle",
    "all_gather", "all_to_all", "psum_scatter", "pbroadcast",
}

# horovod-API collectives (engine/negotiation based; no axis argument).
HVD_COLLECTIVES = {
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_", "grouped_allreduce_async",
    "grouped_allreduce_async_",
    "allgather", "allgather_async", "grouped_allgather",
    "grouped_allgather_async",
    "broadcast", "broadcast_", "broadcast_async", "broadcast_async_",
    "alltoall", "alltoall_async",
    "reducescatter", "reducescatter_async",
    "grouped_reducescatter", "grouped_reducescatter_async",
    "barrier", "join",
    "broadcast_variables", "broadcast_parameters",
    "broadcast_optimizer_state", "broadcast_object", "allgather_object",
    "sparse_allreduce", "hierarchical_allreduce", "adasum_allreduce",
    "sync_batch_stats",
}

COLLECTIVES = LAX_COLLECTIVES | HVD_COLLECTIVES

# torch.distributed's collectives and P2P ops: they count only through a
# ``dist`` / ``torch.distributed`` base (``torch.gather`` and
# ``functools.reduce`` are no collectives).
DIST_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all",
    "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "broadcast_object_list", "all_gather_object",
    "gather_object", "scatter_object_list", "batch_isend_irecv", "send",
    "recv", "isend", "irecv", "reduce", "gather", "scatter", "barrier",
    "monitored_barrier",
}
DIST_BASES = {"dist", "distributed"}

# Names that collide with ubiquitous non-collective Python ("".join,
# os.path.join, Thread.join, lax.broadcast the shape op): these only count
# as collectives when called bare or through a recognizably hvd-ish base.
AMBIGUOUS_COLLECTIVES = {"join", "barrier", "broadcast", "broadcast_"}
HVD_BASES = {"hvd", "horovod_tpu", "ops", "_ops", "collective_ops",
             "functions", "eager", "engine"}

# Calls that capture the function passed to them into a graph, by their
# dotted spelling: ``compile`` alone is Python's builtin and ``re``'s, so
# the torch base is part of the name.
TRACER_CALLS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace", "jit.script",
    "jit.trace", "torch.export.export", "torch.fx.symbolic_trace",
    "fx.symbolic_trace", "torch._dynamo.optimize",
}

RANK_NAMES = {"rank", "local_rank", "cross_rank", "process_index",
              "axis_index"}

STDLIB_RANDOM_FNS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "betavariate",
    "expovariate", "lognormvariate", "vonmisesvariate", "paretovariate",
    "weibullvariate", "triangular", "getrandbits", "randbytes",
}

NP_RANDOM_SEEDABLE = {"RandomState", "default_rng", "Generator",
                      "SeedSequence", "PCG64", "Philox"}
NP_RANDOM_STATE_FNS = {"seed", "get_state", "set_state"}

# torch draws that read the global generator unless given ``generator=``.
TORCH_RANDOM_FNS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "bernoulli", "multinomial", "normal", "poisson",
}

CLOCK_FNS = {"time", "time_ns", "perf_counter", "perf_counter_ns",
             "monotonic", "monotonic_ns", "process_time",
             "process_time_ns", "clock_gettime"}
DATETIME_FNS = {"now", "utcnow", "today"}

# Closed-over-container mutators.  ``.update`` is deliberately absent: it
# collides with ``optimizer.step``-style state updates; ``.add`` is absent
# because ``Tensor.add`` is the out-of-place sum.
MUTATOR_METHODS = {"append", "extend", "insert", "setdefault", "clear",
                   "remove", "pop", "popitem", "write",
                   "writelines", "discard"}

HOST_EFFECT_BARE = {"print", "open", "input", "breakpoint"}
HOST_EFFECT_DOTTED = {"system", "popen", "run", "call",
                      "check_output", "check_call", "Popen"}
HOST_EFFECT_DOTTED_ROOTS = {"os", "subprocess"}

# Device→host syncs: methods on a tensor (or a stream / event) and the
# module-level ``torch.cuda.synchronize``.
SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}

# KV-transport verbs (runner/http_server.KVStoreClient and the native
# server's API): control-plane calls whose failures must surface — a
# silently-swallowed transport fault is how a preemption watcher dies
# unnoticed (HVD009).  Generic method names (get/put/scan/delete) only
# count when some earlier segment of the call chain looks like a KV
# client ("kv" in the name, or a *client attribute/variable).
KV_TRANSPORT_FNS = {"put", "get", "scan", "put_wait", "put_batch",
                    "delete", "delete_scope", "scan_scope"}


# -- small AST helpers ------------------------------------------------------

def _dotted(func: ast.AST) -> str:
    """'jax.lax.psum' for Attribute chains, 'psum' for bare Names, ''
    when the base is dynamic (call result, subscript)."""
    parts: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        parts.append("?")
    return ".".join(reversed(parts))


def _string_consts(node: ast.AST) -> List[str]:
    return [n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def _root_name(node: ast.AST) -> Optional[str]:
    """Root Name of an attribute/subscript chain ('cache' for
    cache['k'].stats)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _is_tracer(dotted: str) -> bool:
    return dotted in TRACER_CALLS


def _is_collective_call(call: ast.Call) -> Optional[str]:
    dotted = _dotted(call.func)
    if not dotted:
        return None
    parts = dotted.split(".")
    last = parts[-1]
    if last in DIST_COLLECTIVES and len(parts) > 1 and \
            parts[-2] in DIST_BASES:
        return last
    if last not in COLLECTIVES:
        return None
    if last in AMBIGUOUS_COLLECTIVES and len(parts) > 1 and \
            parts[-2] not in HVD_BASES:
        return None
    return last


def _is_rank_source(node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        dotted = _dotted(node.func)
        return bool(dotted) and dotted.split(".")[-1] in RANK_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in {"rank", "local_rank", "cross_rank",
                             "process_index"}
    if isinstance(node, ast.Name):
        return node.id in {"rank", "local_rank"}
    return False


# -- the analyzer -----------------------------------------------------------

class _Module:
    """One parsed module plus the derived maps every rule shares."""

    def __init__(self, tree: ast.Module, path: str):
        self.tree = tree
        self.path = path
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.funcs_by_name: Dict[str, List[ast.AST]] = {}
        self.traced: Set[ast.AST] = set()
        self.declared_axes: Set[str] = set()
        self._index()
        self._mark_traced_roots()
        self._propagate_traced()

    # -- indexing ----------------------------------------------------------

    def _index(self) -> None:
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs_by_name.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Lambda):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.funcs_by_name.setdefault(
                            tgt.id, []).append(node.value)
            elif isinstance(node, ast.Call):
                self._collect_axis_decls(node)

    def _collect_axis_decls(self, call: ast.Call) -> None:
        dotted = _dotted(call.func)
        last = dotted.split(".")[-1] if dotted else ""
        if last == "Mesh":
            for arg in call.args[1:2]:
                self.declared_axes.update(_string_consts(arg))
            for kw in call.keywords:
                if kw.arg == "axis_names":
                    self.declared_axes.update(_string_consts(kw.value))
        elif last == "make_mesh":
            for arg in call.args[:1]:
                if isinstance(arg, ast.Dict):
                    for key in arg.keys:
                        if isinstance(key, ast.Constant) and \
                                isinstance(key.value, str):
                            self.declared_axes.add(key.value)
        elif last in {"P", "PartitionSpec"}:
            for arg in list(call.args) + [kw.value for kw in call.keywords]:
                self.declared_axes.update(_string_consts(arg))
        elif last in {"pmap", "shard_step", "xmap"}:
            for kw in call.keywords:
                if kw.arg == "axis_name":
                    self.declared_axes.update(_string_consts(kw.value))

    # -- traced-function marking -------------------------------------------

    def _decorator_traces(self, dec: ast.AST) -> bool:
        if isinstance(dec, ast.Call):
            dotted = _dotted(dec.func)
            last = dotted.split(".")[-1] if dotted else ""
            if _is_tracer(dotted):
                return True
            if last == "partial":  # @partial(torch.compile, ...)
                return any(self._decorator_traces(a) for a in dec.args)
            return False
        return _is_tracer(_dotted(dec))

    def _mark_traced_roots(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(self._decorator_traces(d)
                       for d in node.decorator_list):
                    self.traced.add(node)
            elif isinstance(node, ast.Call):
                if not _is_tracer(_dotted(node.func)):
                    continue
                cands = list(node.args) + [kw.value for kw in node.keywords]
                for arg in cands:
                    if isinstance(arg, ast.Lambda):
                        self.traced.add(arg)
                    elif isinstance(arg, ast.Name):
                        for fn in self.funcs_by_name.get(arg.id, ()):
                            self.traced.add(fn)

    def _own_body(self, fn: ast.AST) -> Iterable[ast.AST]:
        """Nodes of fn's body, not descending into nested function bodies
        (those have their own scope; containment handles their tracing)."""
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        stack = list(body)
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _FUNC_NODES):
                    yield child  # the def itself, not its body
                else:
                    stack.append(child)

    def _propagate_traced(self) -> None:
        """Close tracing over same-module calls-by-name from traced code."""
        changed = True
        while changed:
            changed = False
            for fn in list(self.traced):
                for node in ast.walk(fn if not isinstance(fn, ast.Lambda)
                                     else fn.body):
                    if isinstance(node, ast.Call) and \
                            isinstance(node.func, ast.Name):
                        for callee in self.funcs_by_name.get(
                                node.func.id, ()):
                            if callee not in self.traced:
                                self.traced.add(callee)
                                changed = True

    # -- context queries ----------------------------------------------------

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        chain = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, _FUNC_NODES):
                chain.append(cur)
            cur = self.parents.get(cur)
        return chain  # innermost first

    def in_traced(self, node: ast.AST) -> bool:
        if isinstance(node, _FUNC_NODES) and node in self.traced:
            return True
        return any(fn in self.traced
                   for fn in self.enclosing_functions(node))

    def fn_locals(self, fn: ast.AST) -> Set[str]:
        names: Set[str] = set()
        args = fn.args
        for a in list(args.posonlyargs) + list(args.args) + \
                list(args.kwonlyargs):
            names.add(a.arg)
        if args.vararg:
            names.add(args.vararg.arg)
        if args.kwarg:
            names.add(args.kwarg.arg)
        if isinstance(fn, ast.Lambda):
            return names
        for node in self._own_body(fn):
            if isinstance(node, ast.Name) and \
                    isinstance(node.ctx, (ast.Store, ast.Del)):
                names.add(node.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    names.add((alias.asname or alias.name).split(".")[0])
        return names

    def is_closed_over(self, node: ast.AST, root: str) -> bool:
        """True when ``root`` is not local to any function between ``node``
        and the outermost traced function enclosing it — i.e. mutation of
        it from traced code reaches state that outlives the trace."""
        chain = self.enclosing_functions(node)
        seen_traced = False
        for fn in chain:
            if seen_traced and fn not in self.traced:
                break  # left the traced region: everything further out is
                       # state that survives the trace
            if root in self.fn_locals(fn):
                return False
            if fn in self.traced:
                seen_traced = True
        return True


def analyze(tree: ast.Module, path: str) -> List[Finding]:
    mod = _Module(tree, path)
    findings: List[Finding] = []

    def emit(rule: str, node: ast.AST, message: str) -> None:
        findings.append(Finding(
            rule=rule, path=path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0) + 1,
            message=message))

    _rule_rank_guarded_collective(mod, emit)       # HVD001
    _rule_swallowed_collective(mod, emit)          # HVD002
    _rule_traced_body_calls(mod, emit)             # HVD003/4/5/8 + HVD006
    _rule_closed_over_mutation(mod, emit)          # HVD007
    _rule_swallowed_fault(mod, emit)               # HVD009
    _rule_serve_prng(mod, emit)                    # HVD010 (serve/ only)
    _rule_lock_held_sync(mod, emit)                # HVD011 (serve/ only)

    # Dedup (nested rank-guards can flag one call twice) + stable order.
    seen, out = set(), []
    for f in sorted(findings, key=lambda f: (f.line, f.col, f.rule)):
        key = (f.rule, f.line, f.col)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


# -- HVD001: collective under rank-dependent control flow -------------------

def _branch_collectives(branch) -> List[ast.Call]:
    calls = []
    for stmt in branch:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call) and _is_collective_call(sub):
                calls.append(sub)
    return calls


def _rule_rank_guarded_collective(mod: _Module, emit) -> None:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.If):
            continue
        if not any(_is_rank_source(n) for n in ast.walk(node.test)):
            continue
        body_calls = _branch_collectives(node.body)
        else_calls = _branch_collectives(node.orelse)
        # Symmetric branches — both sides issue the same ordered collective
        # sequence (e.g. broadcast-as-root vs broadcast-as-receiver) — mean
        # every rank posts a matching collective: not a deadlock.
        if body_calls and else_calls and \
                [_is_collective_call(c) for c in body_calls] == \
                [_is_collective_call(c) for c in else_calls]:
            continue
        for sub in body_calls + else_calls:
            name = _is_collective_call(sub)
            emit("HVD001", sub,
                 f"collective '{name}' is only reached by ranks "
                 f"satisfying the rank-dependent condition on line "
                 f"{node.lineno}; the other ranks never post it and the "
                 f"job deadlocks")


# -- HVD002: collective inside exception-swallowing try ---------------------

def _handler_swallows(handler: ast.ExceptHandler) -> bool:
    return not any(isinstance(n, ast.Raise) for n in ast.walk(handler))


def _rule_swallowed_collective(mod: _Module, emit) -> None:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Try):
            continue
        swallowing = [h for h in node.handlers if _handler_swallows(h)]
        if not swallowing:
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    name = _is_collective_call(sub)
                    if name:
                        emit("HVD002", sub,
                             f"collective '{name}' runs inside a try whose "
                             f"except (line {swallowing[0].lineno}) swallows "
                             f"exceptions; a rank that raises skips the "
                             f"collective while the others block in it")


# -- HVD003/004/005/006/008: per-call checks --------------------------------

def _unseeded_random(call: ast.Call, dotted: str) -> Optional[str]:
    parts = dotted.split(".")
    last = parts[-1]
    if parts[0] == "random" and len(parts) == 2 and \
            last in STDLIB_RANDOM_FNS:
        return f"stdlib random.{last}() draws from hidden global state"
    if len(parts) >= 3 and parts[-2] == "random" and \
            parts[0] in {"np", "numpy"}:
        if last in NP_RANDOM_SEEDABLE:
            if not call.args and not call.keywords:
                return (f"np.random.{last}() without a seed differs per "
                        f"rank")
            return None
        if last in NP_RANDOM_STATE_FNS:
            return None
        return f"np.random.{last}() draws from the unseeded global RNG"
    if parts[0] == "torch" and last in TORCH_RANDOM_FNS and \
            not any(kw.arg == "generator" for kw in call.keywords):
        return f"{dotted}() draws from the global torch generator"
    return None


def _host_effect(call: ast.Call, dotted: str) -> Optional[str]:
    parts = dotted.split(".")
    last = parts[-1]
    if len(parts) == 1 and last in HOST_EFFECT_BARE:
        return (f"'{last}' breaks the compiled graph (or runs at trace "
                f"time only)")
    if last in HOST_EFFECT_DOTTED and \
            parts[0] in HOST_EFFECT_DOTTED_ROOTS:
        return f"'{dotted}' is a host side effect inside traced code"
    return None


def _clock_call(dotted: str) -> Optional[str]:
    parts = dotted.split(".")
    last = parts[-1]
    if parts[0] == "time" and len(parts) == 2 and last in CLOCK_FNS:
        return f"'{dotted}()' is baked in as a trace-time constant"
    if len(parts) == 1 and last in CLOCK_FNS:
        return f"'{last}()' is baked in as a trace-time constant"
    if last in DATETIME_FNS and "datetime" in parts[:-1]:
        return f"'{dotted}()' is baked in as a trace-time constant"
    return None


#: Keywords through which the port's collectives name their mesh axes
#: (ring / Ulysses attention, the pipeline, the tensor-parallel MLP, the
#: MoE layer, ``DistributedOptimizer``, ``sync_batch_stats``).
AXIS_KEYWORDS = {"axis_name", "axis_names", "reduce_axes", "expert_axis"}


def _axis_use(call: ast.Call, last: str) -> List[str]:
    """String axis names this collective call references."""
    exprs: List[ast.AST] = []
    if last in LAX_COLLECTIVES and len(call.args) >= 2:
        exprs.append(call.args[1])
    for kw in call.keywords:
        if kw.arg in AXIS_KEYWORDS:
            exprs.append(kw.value)
    names: List[str] = []
    for e in exprs:
        names.extend(_string_consts(e))
    return names


def _rule_traced_body_calls(mod: _Module, emit) -> None:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if not dotted:
            continue
        last = dotted.split(".")[-1]
        traced = mod.in_traced(node)

        # HVD006 applies wherever the call sits: axis literals are
        # checkable even outside traced code, but only when the file
        # declares axes at all (otherwise there is nothing to check
        # against).  Besides the lax names, any call naming an axis by
        # keyword is one of the port's collectives over that axis.
        if mod.declared_axes and (
                last in LAX_COLLECTIVES or
                any(kw.arg in AXIS_KEYWORDS for kw in node.keywords)):
            for axis in _axis_use(node, last):
                if axis not in mod.declared_axes:
                    emit("HVD006", node,
                         f"collective '{last}' names axis '{axis}' but "
                         f"this file only declares "
                         f"{sorted(mod.declared_axes)}")

        if not traced:
            continue
        msg = _unseeded_random(node, dotted)
        if msg:
            emit("HVD003", node, msg + " inside a traced function")
        msg = _host_effect(node, dotted)
        if msg:
            emit("HVD004", node, msg)
        if _sync_call_kind(node) is not None:
            emit("HVD005", node,
                 f"'{last}' forces a device sync inside the traced step")
        msg = _clock_call(dotted)
        if msg:
            emit("HVD008", node, msg)


# -- HVD009: bare/silent except around collective or KV-transport calls ----

def _is_kv_transport_call(call: ast.Call) -> Optional[str]:
    dotted = _dotted(call.func)
    if not dotted:
        return None
    parts = dotted.split(".")
    if len(parts) < 2 or parts[-1] not in KV_TRANSPORT_FNS:
        return None
    base = [p.lower() for p in parts[:-1]]
    if any("kv" in p or "client" in p for p in base):
        return dotted
    return None


def _silent_handler(handler: ast.ExceptHandler) -> Optional[str]:
    """Why this handler counts as fault-swallowing for HVD009, or None.

    Two shapes (narrower than HVD002's any-non-raising handler):

    * ``except:`` with no re-raise — catches EVERYTHING including
      KeyboardInterrupt/SystemExit, whatever its body does;
    * ``except Exception:`` (or BaseException) whose body is ONLY
      ``pass``/``...``/``continue`` — the fault vanishes without a log
      line, a metric, or a backoff.
    """
    def body_is_silent() -> bool:
        for stmt in handler.body:
            if isinstance(stmt, (ast.Pass, ast.Continue)):
                continue
            if isinstance(stmt, ast.Expr) and \
                    isinstance(stmt.value, ast.Constant) and \
                    stmt.value.value is Ellipsis:
                continue
            return False
        return True

    if handler.type is None:
        if not any(isinstance(n, ast.Raise) for n in ast.walk(handler)):
            return "bare 'except:'"
        return None
    names = _string_like_exc_names(handler.type)
    if names & {"Exception", "BaseException"} and body_is_silent():
        return f"'except {sorted(names)[0]}: pass'"
    return None


def _string_like_exc_names(node: ast.AST) -> Set[str]:
    names: Set[str] = set()
    nodes = node.elts if isinstance(node, ast.Tuple) else [node]
    for n in nodes:
        dotted = _dotted(n)
        if dotted:
            names.add(dotted.split(".")[-1])
    return names


def _rule_swallowed_fault(mod: _Module, emit) -> None:
    """HVD009: a collective or KV-transport call inside a try whose
    handler swallows faults SILENTLY (``_silent_handler``).  The
    distributed consequence differs by call class — a swallowed
    collective desynchronizes ranks (HVD002's concern, sharpened here to
    the silent shapes), a swallowed KV-transport fault blinds the
    control plane (a preemption watcher that eats its scan error polls a
    ghost forever) — but the fix is the same: count the error into
    metrics, log it, back off, and keep going, or re-raise."""
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Try):
            continue
        silent = next((why for why in map(_silent_handler, node.handlers)
                       if why), None)
        if silent is None:
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                name = _is_kv_transport_call(sub)
                kind = "KV-transport"
                if name is None:
                    name = _is_collective_call(sub)
                    kind = "collective"
                if name is None:
                    continue
                emit("HVD009", sub,
                     f"{kind} call '{name}' inside a try whose {silent} "
                     f"swallows the fault silently; count it into "
                     f"metrics, back off and retry, or re-raise — a "
                     f"dropped fault here is invisible until the job "
                     f"wedges")


# -- HVD010: reused-or-ambient PRNG in serving code -------------------------

#: Module bases whose ``manual_seed`` / ``seed`` set a process-global
#: generator (every request of every replica shares it).
_GLOBAL_RNG_BASES = {"torch", "torch.cuda", "torch.random", "cuda"}


def _in_serve_tree(path: str) -> bool:
    norm = path.replace("\\", "/")
    return "/serve/" in norm or norm.startswith("serve/")


def _clock_derived(node: ast.AST) -> Optional[str]:
    """The dotted clock/date call feeding ``node``, if any — a generator
    seeded from the wall clock differs per replica and per replay."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        dotted = _dotted(sub.func)
        if not dotted:
            continue
        if _clock_call(dotted) is not None:
            return dotted
        last = dotted.split(".")[-1]
        if last in DATETIME_FNS and "datetime" in dotted.split(".")[:-1]:
            return dotted
    return None


def _rule_serve_prng(mod: _Module, emit) -> None:
    """HVD010: serve-aware PRNG provenance (the serving sharpening of
    HVD003's unseeded-randomness concern).  Inside ``serve/``:

    * ``<generator>.manual_seed(seed)`` whose seed derives from the wall
      clock (replay/failover divergence) or is a literal constant (every
      request shares the stream);
    * the global ``torch.manual_seed`` / ``torch.cuda.manual_seed[_all]``
      / ``torch.seed`` — one ambient stream for every request;
    * a ``torch.rand*`` / ``multinomial`` draw with no ``generator=`` —
      a draw from that ambient stream.

    Draws must chain from the request seed so batched == single given the
    same seed survives requeue, failover and fork."""
    if not _in_serve_tree(mod.path):
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        parts = dotted.split(".") if dotted else []
        last = parts[-1] if parts else ""
        base = ".".join(parts[:-1])
        if last in ("manual_seed", "manual_seed_all", "seed") and \
                base in _GLOBAL_RNG_BASES:
            emit("HVD010", node,
                 f"'{dotted}' seeds the process-global torch generator in "
                 f"serving code: every request draws from one ambient "
                 f"stream, so a draw depends on what ran before it")
            continue
        if parts[:1] == ["torch"] and len(parts) == 2 and \
                last in TORCH_RANDOM_FNS and \
                not any(kw.arg == "generator" for kw in node.keywords):
            emit("HVD010", node,
                 f"'{dotted}' draws from the global torch generator in "
                 f"serving code; pass a generator derived from the "
                 f"request seed")
            continue
        if last != "manual_seed" or not node.args or len(parts) < 2:
            continue
        clock = _clock_derived(node)
        if clock is not None:
            emit("HVD010", node,
                 f"'{last}' seeds serving randomness from the wall clock "
                 f"('{clock}'): a resubmitted/replayed request draws "
                 f"different tokens on every replica")
            continue
        if isinstance(node.args[0], ast.Constant):
            emit("HVD010", node,
                 f"'{last}' seeds a serving generator from a constant — "
                 f"every request (and every rank) draws the same stream; "
                 f"derive it from the request seed")


# -- HVD011: blocking device sync inside a lock region in serve/ ------------

def _is_lock_ctx(expr: ast.AST) -> bool:
    """``with self._lock:`` / ``with self._kv_lock:`` — an attribute
    whose name mentions "lock" (the repo-wide naming convention the
    hvdrace lockgraph keys on), optionally through ``.acquire()`` or a
    bare Name like ``with lock:``."""
    if isinstance(expr, ast.Call):
        expr = expr.func
        if isinstance(expr, ast.Attribute) and expr.attr == "acquire":
            expr = expr.value
    if isinstance(expr, ast.Attribute):
        return "lock" in expr.attr.lower()
    if isinstance(expr, ast.Name):
        return "lock" in expr.id.lower()
    return False


def _sync_call_kind(node: ast.Call) -> Optional[str]:
    """The blocking-sync shape of a call, if any: ``<x>.item()``,
    ``.cpu()``, ``.tolist()``, ``.numpy()`` (each waits for the value's
    producer on the card, then copies it to the host) or
    ``.synchronize()`` (``torch.cuda.synchronize()``, a stream's or an
    event's), which waits out the queue itself."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
        return f".{f.attr}()"
    return None


def _rule_lock_held_sync(mod: _Module, emit) -> None:
    """HVD011: a blocking device→host sync inside a ``with self._lock``
    region in serve/ — the static sibling of hvdrace's HVD201 (blocking
    call under a lock): the sync waits for the card to finish the whole
    queued work while every other request thread piles up on the lock.
    Nested function bodies are skipped (they run when called, not
    necessarily under the lock)."""
    if not _in_serve_tree(mod.path):
        return
    lock_withs = [
        node for node in ast.walk(mod.tree)
        if isinstance(node, ast.With) and
        any(_is_lock_ctx(item.context_expr) for item in node.items)]

    def _body_nodes(root_stmts):
        stack = list(root_stmts)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue  # runs when called, not necessarily under lock
            stack.extend(ast.iter_child_nodes(node))

    seen: Set[int] = set()
    for w in lock_withs:
        for node in _body_nodes(w.body):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            kind = _sync_call_kind(node)
            if kind is None:
                continue
            seen.add(id(node))
            emit("HVD011", node,
                 f"blocking device sync '{kind}' runs while holding "
                 f"the lock taken on line {w.lineno} — the sync waits "
                 f"out the card's whole queued work and every "
                 f"other request thread stalls on the lock for that "
                 f"long; snapshot under the lock, release, then fetch")


# -- HVD007: mutation of closed-over state in traced code -------------------

def _rule_closed_over_mutation(mod: _Module, emit) -> None:
    for fn in mod.traced:
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for node in ast.walk(stmt):
                _check_mutation(mod, node, emit)


def _check_mutation(mod: _Module, node: ast.AST, emit) -> None:
    if isinstance(node, (ast.Global, ast.Nonlocal)):
        emit("HVD007", node,
             f"'{'global' if isinstance(node, ast.Global) else 'nonlocal'} "
             f"{', '.join(node.names)}' rebinds outer state from traced "
             f"code; the write happens once at trace time, not per step")
        return
    targets: List[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    elif isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) and \
            node.func.attr in MUTATOR_METHODS:
        root = _root_name(node.func.value)
        if root and mod.is_closed_over(node, root):
            emit("HVD007", node,
                 f"'{root}.{node.func.attr}(...)' mutates closed-over "
                 f"'{root}' from traced code (trace-time effect, not a "
                 f"per-step one)")
        return
    for tgt in targets:
        if isinstance(tgt, (ast.Subscript, ast.Attribute)):
            root = _root_name(tgt)
            if root and mod.is_closed_over(node, root):
                emit("HVD007", tgt,
                     f"assignment into closed-over '{root}' from traced "
                     f"code happens at trace time, not per step, and "
                     f"diverges across independently-tracing ranks")
