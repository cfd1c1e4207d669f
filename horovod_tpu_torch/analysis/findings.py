"""Finding / Rule data model shared by the port's analyzers.

Copied from ``horovod_tpu/analysis/findings.py``.  The catalogue keeps
the rules the port can fire: the AST rules HVD000-HVD011 (the traced-code
and serving rules reworded for ``torch.compile``, ``.item()`` /
``.cpu()`` syncs and ``torch.Generator`` seeds), the trace-time rules
HVD100-HVD102 over a ``make_fx`` graph, the lock-order rules
HVD200-HVD203, the witness rules HVD210 / HVD211, the memory rules
HVD300 (read as "not updated in place") and HVD302-HVD304, and the
communication rules HVD401-HVD404 (HVD403 without its mixed-fabric arm).
HVD301 and HVD400 have no torch construct (ROADMAP.md, "Left out").

The reference catches the classic SPMD failure — ranks submitting
different collective sequences — at RUNTIME, in the coordinator's
negotiation phase (controller.cc ComputeResponseList: "Mismatched
allreduce" stall warnings).  hvdlint reports the same class of bug
STATICALLY, so every finding carries the shape the negotiation error
would have had: what diverges, where, and how to fix it before the job
wedges.  The ``# hvdlint: disable=`` suppression syntax is the JAX
package's, so one comment silences both linters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One lint rule: stable ID, severity, rationale, and a fix hint that is
    attached verbatim to every finding it produces."""

    id: str
    severity: str
    summary: str
    fix_hint: str


# ---------------------------------------------------------------------------
# Rule catalogue.  HVD0xx = source-level (AST) rules; HVD000 is the
# analyzer's own loud-but-graceful degradation channel (syntax errors,
# unreadable files).
# ---------------------------------------------------------------------------

RULES: Dict[str, Rule] = {r.id: r for r in [
    Rule("HVD000", ERROR,
         "analysis failure: the file could not be parsed (syntax error or "
         "unreadable); reported as a finding instead of crashing the linter",
         "fix the syntax error, or exclude the file from the lint paths"),
    Rule("HVD001", ERROR,
         "collective call guarded by rank-dependent control flow — only a "
         "subset of ranks reaches the collective, the rest wait forever "
         "(the deadlock Horovod's negotiation phase detects at runtime)",
         "move the collective outside the `if rank() == ...` block; every "
         "rank must execute the same collective sequence"),
    Rule("HVD002", ERROR,
         "collective inside a try/except whose handler swallows the "
         "exception — a rank that raises skips the collective while the "
         "others block in it",
         "re-raise inside the handler (or raise HorovodInternalError) so "
         "either every rank completes the collective or the job tears down"),
    Rule("HVD003", ERROR,
         "unseeded global-state randomness (`random`, `np.random`, or a "
         "`torch.rand*` draw with no `generator=`) inside a "
         "torch.compile'd or traced function — each rank draws from its "
         "own unshared state, so replicas diverge",
         "draw from a torch.Generator seeded from a seed every rank "
         "shares, or a seeded np.random.RandomState(seed)/default_rng(seed)"),
    Rule("HVD004", WARNING,
         "host side effect (print/open/os.system/subprocess) inside a "
         "torch.compile'd or traced step function — a graph break under "
         "torch.compile (fullgraph=True fails to compile) and a "
         "trace-time-only effect under torch.jit.trace / torch.export",
         "move host I/O outside the compiled step function"),
    Rule("HVD005", WARNING,
         ".item()/.cpu()/.tolist()/.numpy()/torch.cuda.synchronize() "
         "inside the compiled step function — forces a device→host sync "
         "(and a graph break) on the hot path, serializing the host with "
         "the card's queue",
         "fetch results outside the step; sync once per iteration batch at "
         "most"),
    Rule("HVD006", ERROR,
         "collective names an axis that no enclosing mesh/shard_map/pmap in "
         "this file declares — fails with an unbound-axis NameError at "
         "trace time (or silently reduces over the wrong group)",
         "use the declared mesh axis name (hvd.mesh_axis(), default 'hvd') "
         "or add the axis to the mesh"),
    Rule("HVD007", WARNING,
         "mutation of closed-over Python state inside a torch.compile'd or "
         "traced function — under torch.jit.trace / torch.export it "
         "happens once at trace time, not per step; under torch.compile "
         "it is a side effect Dynamo must replay after every call, and it "
         "diverges across ranks that trace independently",
         "thread state through function arguments/returns instead of "
         "mutating captured objects"),
    Rule("HVD008", ERROR,
         "wall-clock call (time.time/perf_counter/datetime.now) inside a "
         "torch.compile'd or traced function — baked in as a trace-time "
         "constant under torch.jit.trace / torch.export, a graph break "
         "under torch.compile, and a different value per rank",
         "pass timestamps in as arguments, or measure outside the compiled "
         "step"),
    Rule("HVD009", ERROR,
         "collective or KV-transport call inside a bare `except:` or an "
         "`except Exception: pass` — the swallowed-fault antipattern: a "
         "dropped control-plane error is invisible (a preemption watcher "
         "that eats its scan error polls a ghost forever; a swallowed "
         "collective desynchronizes ranks)",
         "count the error into metrics, log it, back off and retry "
         "(serve/replica.watch_preemption is the model), or re-raise"),
    Rule("HVD010", ERROR,
         "reused-or-ambient PRNG in serving code: inside serve/, a "
         "torch.Generator seeded from the wall clock or from constants "
         "only, the global torch.manual_seed / torch.cuda.manual_seed, or "
         "a torch.rand*/multinomial draw with no `generator=` — clock "
         "seeds break the replay/failover exactness contract (the same "
         "request resampled elsewhere draws different tokens), constant "
         "and global seeds hand every request the same or a shared "
         "stream (batch-position correlations the "
         "batched==single-given-the-same-seed contract forbids)",
         "derive every serving draw from the request's seed (the "
         "sampler's counter hash keys on (seed, sample_index, position)) "
         "so draws are reproducible and request-independent"),
    Rule("HVD011", WARNING,
         "blocking device sync (.item() / .cpu() / .tolist() / .numpy() / "
         ".synchronize()) inside a `with self._lock` region in serve/ — "
         "the static sibling of hvdrace's HVD201: every other request "
         "thread needing that lock stalls for the full device "
         "round-trip, and a wedged device wedges the whole control plane",
         "snapshot what the sync needs under the lock, release it, then "
         "pull the value to host (the engine's decode loop fetches "
         "outside its critical sections — that is the model)"),
    # -- lock-order / thread-lifecycle (hvdrace static) rules ---------------
    Rule("HVD200", ERROR,
         "lock-order cycle: two code paths acquire the same pair of locks "
         "in opposite orders (the AB/BA deadlock shape the serve batcher/"
         "metrics pair shipped with once) — if the paths ever run "
         "concurrently the threads deadlock holding each other's lock",
         "pick ONE global order for the pair and restructure the inner "
         "acquisition out of the outer critical section (sample state "
         "under one lock, act on it after release); declare the intended "
         "order with '# hvdrace: order=A<B' so inversions keep firing"),
    Rule("HVD201", WARNING,
         "blocking call (KV/HTTP request, subprocess, time.sleep, "
         "Thread.join, torch.compile'd step) while holding a lock — every "
         "other thread needing that lock stalls for the call's full "
         "latency, and a hung transport wedges the whole control plane",
         "move the blocking call outside the critical section: snapshot "
         "what it needs under the lock, release, then block"),
    Rule("HVD202", ERROR,
         "callback/user-hook invoked while holding a lock — the callee is "
         "arbitrary code that may take its own lock (the exact shape of "
         "the batcher on_shed → metrics-lock half of the AB/BA "
         "deadlock) or re-enter the calling object",
         "collect the callbacks to fire under the lock, release it, then "
         "invoke them (batcher.get_admission's expired-list finally "
         "block is the model)"),
    Rule("HVD203", ERROR,
         "non-daemon thread spawned with no join() on any stop/close "
         "path — interpreter exit blocks on it forever, and an exception "
         "between spawn and a sole in-line join leaks it",
         "pass daemon=True (loop threads that poll a stop Event), or "
         "store the handle and join it from every stop()/close() path"),
    # -- lock-witness (hvdrace runtime, HVD_SANITIZE=1) rules ---------------
    Rule("HVD210", ERROR,
         "runtime lock-order inversion: the witness observed lock B "
         "acquired while holding A after an earlier A-while-holding-B "
         "acquisition — a live demonstration of an HVD200 cycle",
         "fix the acquisition order (see HVD200); the finding carries "
         "both acquisition sites"),
    Rule("HVD211", ERROR,
         "Condition.wait()/Event.wait() with no timeout while holding a "
         "second lock — the wait releases only its own lock, so the "
         "other lock is held until a wakeup that may never come",
         "wait with a bounded timeout and re-check, or release the "
         "second lock before waiting"),
    # -- hvdmem liveness / in-place / budget rules ---------------------------
    Rule("HVD300", WARNING,
         "not-updated-in-place: a step input of at least 1 MiB that the "
         "graph never writes sits next to a freshly allocated output of "
         "its shape and dtype — the step holds both the old and the new "
         "tensor live, doubling that value's footprint (updating the KV "
         "pool in place halves decode memory)",
         "write the result into the input (an in-place op, index_put_, "
         "copy_ or out=) instead of returning a new tensor"),
    Rule("HVD302", ERROR,
         "peak-exceeds-budget: the estimated peak live footprint of a "
         "step (or the serve pool's bytes_per_block * num_blocks plus "
         "the resident weight bytes) exceeds HVD_MEM_BUDGET_BYTES / the "
         "card's memory — the step runs out of device memory, discovered "
         "only when it runs",
         "shrink the pool (HVD_SERVE_NUM_BLOCKS), quantize KV blocks "
         "(HVD_SERVE_KV_DTYPE=int8), update inputs in place, or raise "
         "the budget if it undershoots the card's real memory"),
    Rule("HVD303", WARNING,
         "silent-upcast blowup: bf16/f16 values flow through casts that "
         "promote them to f32, widening the live set 2x — the "
         "f32-serving-island footprint made visible (intentional f32 "
         "islands under HVD_SERVE_DTYPE/documented knobs should be "
         "small; a whole param/activation set widening is a leak)",
         "keep the wide island minimal (layernorm-style), or store/"
         "compute in the narrow dtype and cast per-tile inside the "
         "kernel"),
    Rule("HVD304", WARNING,
         "fusion-buffer overshoot: a fused flat-buffer bucket exceeds "
         "the tensor-fusion threshold knob (HOROVOD_FUSION_THRESHOLD) — "
         "the bucket transiently costs its full size twice (copy-in + "
         "collective result), past what the knob budgeted",
         "lower the bucket size or raise the threshold knowingly; "
         "autotune (HOROVOD_AUTOTUNE=1) finds the sweet spot"),
    # -- hvdshard communication-plan rules -----------------------------------
    Rule("HVD401", ERROR,
         "comm-budget overshoot: a step's estimated wire bytes (payload "
         "x group size, summed over its collectives) or the replica "
         "plan's per-step bytes (the sequence-parallel ring's K/V "
         "rotation) exceed HVD_COMM_BUDGET_BYTES; the step is "
         "communication-bound before it ever runs",
         "keep traffic inside the host (NVLink axes over cross-host "
         "ones), fuse/batch collectives, or raise the budget knowingly"),
    Rule("HVD402", WARNING,
         "replicated-large-operand: a multi-MB shard_step argument under "
         "P() rides next to peers sharded over a mesh axis that divides "
         "its leading dim — every rank holds a full copy a known spec "
         "would split (the comm analogue of HVD300)",
         "shard the argument over the peer axis (P(axis) on dim 0) and "
         "gather the slices where they are needed"),
    Rule("HVD403", ERROR,
         "collective over an axis the mesh does not declare — it reduces "
         "over a process set that does not exist in this deployment "
         "(HVD102's negotiation mismatch, across meshes)",
         "declare the axis on the mesh, or fix the process set / "
         "axis_name the collective is given"),
    Rule("HVD404", WARNING,
         "declared-but-never-communicated mesh axis: an axis of size "
         "> 1 that no collective, no `reduce_axes=` and no sharding spec "
         "ever names — dead parallelism: the mesh reserves N x the cards "
         "and the program replicates the same work on all of them",
         "drop the axis from the mesh, or actually shard/reduce over "
         "it (a P(...) spec, axis_name=, reduce_axes=, mesh.group(...))"),
    # -- trace-level (make_fx graph) rules ------------------------------------
    Rule("HVD100", ERROR,
         "the step function failed to trace — the graph checker reports "
         "the exception as a finding instead of crashing the caller",
         "reproduce with make_fx(step, tracing_mode=\"fake\")(*args) and "
         "fix the trace error (a host read of a tensor's value, a write "
         "to state outside the step)"),
    Rule("HVD101", ERROR,
         "collective names a mesh axis that the step's mesh does not "
         "declare (the static form of reducing over a communicator that "
         "does not exist)",
         "declare the axis on the mesh, or fix the axis_name / process "
         "set argument"),
    Rule("HVD102", WARNING,
         "torch.cond branches carry different collective signatures "
         "(kind/axis/shape/dtype sequence) — if the predicate ever "
         "diverges across ranks, some ranks issue collectives the others "
         "never post: the static analogue of Horovod's negotiation "
         "mismatch",
         "hoist collectives out of the cond, or make both branches issue "
         "the identical collective sequence (the unused branch can reduce "
         "zeros); safe only if the predicate is provably replicated"),
]}


@dataclasses.dataclass
class Finding:
    """One analyzer finding, renderable as text or JSON."""

    rule: str
    path: str            # file path, or a logical label for plan findings
    line: int            # 1-based; 0 for whole-file / whole-program findings
    col: int
    message: str
    severity: str = ""
    fix_hint: str = ""
    suppressed: bool = False
    # "lint" | "race" | "witness" | "graph" | "mem" | "comm"
    source: str = "lint"

    def __post_init__(self):
        rule = RULES.get(self.rule)
        if rule is not None:
            if not self.severity:
                self.severity = rule.severity
            if not self.fix_hint:
                self.fix_hint = rule.fix_hint

    def format(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}" if self.line else self.path
        sup = " (suppressed)" if self.suppressed else ""
        return (f"{loc}: {self.rule} [{self.severity}]{sup} {self.message}\n"
                f"    fix: {self.fix_hint}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def unsuppressed(findings) -> list:
    return [f for f in findings if not f.suppressed]


def rule_selected(rule: str, select=(), ignore=()) -> bool:
    """Shared --select/--ignore filter for every analyzer pass.  Tokens
    match exactly OR as prefixes (``--select HVD2`` runs the whole
    HVD2xx family), uniformly across lint/race/comm; ``select`` wins
    when both are given (the usual linter contract), and applies to every
    rule including HVD000 analysis failures."""
    def hit(tokens) -> bool:
        return any(rule == tok or rule.startswith(tok) for tok in tokens)
    if select:
        return hit(select)
    return not hit(ignore)
