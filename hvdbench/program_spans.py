"""The program's own spans in a traced run: the port's timeline, read
onto the profiler's clock.

In a ``--trace 1`` run each rank also records the port's timeline
(``horovod_tpu_torch.timeline``): it starts on a file under ``TMPDIR``
when the profiler starts and stops when the profiler stops, and the file
is read as soon as the trace is, then removed.  ``install`` does that by
wrapping ``train._profiler`` and ``train._read_trace``; every reader of a
program span imports this module, which installs it, so a cell that
reports none of them records nothing.  A ``--trace 0`` run never starts
the profiler, and records nothing either.  A program without step-phase
spans (no ``timeline.ACTIVE``) is not recorded: its readers read
nothing.

Clocks: the timeline's process metadata event carries its zero on the
host's monotonic clock (``monotonic_zero_ns``), and the harness notes
its span markers on ``time.perf_counter``, the same clock on Linux
(checked).  The markers that ``traces.match_markers`` found map a host
time onto the profiler's clock (``marker_fit``: a line through them, the
first marker, which the profiler stamps early, left out); the largest
distance of a marker from the line is the mapping's slack.

Program spans: every complete (``X``) event, and every ``B``/``E`` pair
(the engine's negotiation and op states), on any thread.  A device
operation belongs to every program span that contains its launch; one
launched in none belongs to the span with the nearest bound within the
slack (a region's last launch, such as the head's f32 cast, lies
microseconds before the region's end).  A metric over several names
counts an operation once.  Where the markers
were not all matched, the clocks differ, or the timeline dropped
events, the readers read nothing and stderr says why.

stderr also gets, per rank: the ``opt`` counters a step, the device ms
a step of the harness's ``fwd`` + ``bwd`` and ``opt`` spans that no
program span covers, the ``embed`` spans' ms, and the largest idle gaps
labelled by the innermost program span at the launch that ends each gap
(the harness's label where none covers it).
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from hvdbench import traces, train

MODEL = ("embed", "attn", "mlp", "head", "loss")
OPT = ("opt.accumulate", "opt.reduce", "opt.writeback", "opt.inner")

# The last trace read and the program's spans on its clock (``Program``),
# or None where they could not be read.
LAST: Tuple[Optional[traces.Trace], Optional["Program"]] = (None, None)


def log(msg: str) -> None:
    print(f"[hvdbench] {msg}", file=sys.stderr, flush=True)


class Program:
    """The program's spans and counters of one rank's profiled stretch,
    on the trace's clock (µs)."""

    def __init__(self, spans: List[Tuple[float, float, str]],
                 counters: List[dict], residuals: Sequence[float] = ()):
        self.spans = sorted(spans)
        self.counters = counters
        # each marker's distance from the mapping's line, but the first's
        self.residuals = sorted(residuals)
        self.slack = self.residuals[-1] if self.residuals else 0.0
        self._all = traces.union((s, e) for s, e, _ in self.spans)
        self._bounds = sorted((t, n) for s, e, n in self.spans
                              for t in (s, e))
        self.reported = False

    def covered(self, names: Iterable[str]) -> List[Tuple[float, float]]:
        """The union of the spans named ``names``."""
        want = set(names)
        return traces.union((s, e) for s, e, n in self.spans if n in want)

    def nearest(self, t: Optional[float]) -> Optional[str]:
        """For a launch in no span: the span with the nearest bound within
        the slack, else None."""
        if t is None or _inside(self._all, t):
            return None
        i = bisect.bisect_left(self._bounds, (t, ""))
        near = [(abs(b - t), n) for b, n in self._bounds[max(0, i - 1):i + 1]
                if abs(b - t) <= self.slack]
        return min(near)[1] if near else None

    def owns(self, names: Iterable[str], t: Optional[float],
             merged: Sequence[Tuple[float, float]]) -> bool:
        """Whether a launch at ``t`` belongs to a span of ``names``
        (``merged``: ``covered(names)``)."""
        return _inside(merged, t) or self.nearest(t) in names

    def time_in(self, trace: traces.Trace, names: Sequence[str]) -> float:
        """Device µs of the operations that belong to spans named
        ``names``, each once."""
        merged = self.covered(names)
        return sum(o.end - o.start for o in trace.ops
                   if self.owns(names, o.launch, merged))


def _inside(merged: Sequence[Tuple[float, float]],
            t: Optional[float]) -> bool:
    if t is None or not merged:
        return False
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


class _Innermost:
    """The shortest span containing a time, by a sweep over the spans'
    bounds."""

    def __init__(self, spans: Sequence[Tuple[float, float, str]]):
        bounds = sorted({t for s, e, _ in spans for t in (s, e)})
        self.starts, self.names = [], []
        for a, b in zip(bounds, bounds[1:]):
            mid = (a + b) / 2
            inner = min(((e - s, n) for s, e, n in spans if s <= mid <= e),
                        default=None)
            self.starts.append(a)
            self.names.append(inner[1] if inner else None)
        self.end = bounds[-1] if bounds else None

    def at(self, t: Optional[float]) -> Optional[str]:
        if t is None or not self.starts or t > self.end:
            return None
        i = bisect.bisect_right(self.starts, t) - 1
        return self.names[i] if i >= 0 else None


def read_timeline(events: Sequence[dict]
                  ) -> Tuple[Optional[float], List[Tuple[float, float, str]],
                             List[dict], Optional[str]]:
    """(zero µs on the host's monotonic clock, spans and counters on the
    host's monotonic clock in µs, why not) from a timeline's events."""
    zero, dropped = None, None
    spans, counters = [], []
    opened: Dict[Tuple[str, str], List[float]] = defaultdict(list)
    for ev in events:
        ph, name, args = ev.get("ph"), ev.get("name", ""), ev.get("args") or {}
        if ph == "M" and name == "process_name":
            z = args.get("monotonic_zero_ns")
            zero = None if z is None else z / 1e3
        elif ph == "X":
            ts = float(ev["ts"])
            spans.append((ts, ts + float(ev.get("dur", 0.0)), name))
        elif ph == "B":
            opened[(str(ev.get("tid")), name)].append(float(ev["ts"]))
        elif ph == "E":
            stack = opened.get((str(ev.get("tid")), name))
            if stack:
                spans.append((stack.pop(), float(ev["ts"]), name))
        elif ph == "C" and name == "hvd_timeline_dropped_events_total":
            dropped = int(args.get("dropped", 0))
        elif ph == "C":
            counters.append(dict(args, name=name))
    if zero is None:
        return None, [], [], "the timeline carries no monotonic zero"
    if dropped is None:
        return None, [], [], "the timeline has no trailer (not closed)"
    if dropped:
        return None, [], [], f"the timeline dropped {dropped} events"
    return zero, [(s + zero, e + zero, n) for s, e, n in spans], \
        counters, None


def marker_fit(names: Sequence[str], noted: Sequence[float],
               trace: traces.Trace) -> Optional[Tuple[float, float]]:
    """(a, b): a host time t (``time.perf_counter``, µs) is a + b t on
    the trace's clock, b the least-squares slope through the matched
    markers but the first and a their median intercept; None unless
    every marker was matched."""
    pairs = _matched(names, noted, trace)
    if pairs is None:
        return None
    pts = pairs[1:] if len(pairs) > 2 else pairs
    t0 = statistics.fmean(t for _, t in pts)
    f0 = statistics.fmean(f for f, _ in pts)
    var = sum((t - t0) ** 2 for _, t in pts)
    b = sum((t - t0) * (f - f0) for f, t in pts) / var if var else 1.0
    return statistics.median(f - b * t for f, t in pts), b


def _matched(names, noted, trace) -> Optional[List[Tuple[float, float]]]:
    """(trace time, noted host time) of each marker, in order."""
    if not names or len(noted) != 2 * len(names) or \
            len(trace.spans) != len(names):
        return None
    found = []
    for (s, e, name), want in zip(trace.spans, names):
        if name != want:
            return None
        found += [s, e]
    return list(zip(found, noted))


def same_clock() -> bool:
    """Whether ``time.perf_counter`` and ``time.monotonic`` read one
    clock (both ``clock_gettime(CLOCK_MONOTONIC)`` on Linux)."""
    a = time.get_clock_info("perf_counter")
    b = time.get_clock_info("monotonic")
    return a.implementation == b.implementation


def program_on_trace(events: Sequence[dict], names: Sequence[str],
                     noted: Sequence[float], trace: traces.Trace
                     ) -> Tuple[Optional[Program], Optional[str]]:
    """The timeline's spans and counters on the trace's clock, or None
    and why not."""
    if not same_clock():
        return None, "perf_counter and monotonic are different clocks"
    zero, spans, counters, why = read_timeline(events)
    if why:
        return None, why
    fit = marker_fit(names, noted, trace)
    if fit is None:
        return None, "the harness's span markers were not all matched"
    a, b = fit
    residuals = [abs(f - a - b * t)
                 for f, t in _matched(names, noted, trace)[1:]]
    return Program([(a + b * s, a + b * e, n) for s, e, n in spans],
                   counters, residuals), None


# -- the readers' side ------------------------------------------------------

def program_of(ctx) -> Optional[Program]:
    """The program's spans of ``ctx.trace``, None where none were read;
    the first call for a trace reports them on stderr."""
    tr, prog = LAST
    if tr is None or tr is not ctx.trace or prog is None:
        return None
    if not prog.reported and tr.ops and ctx.steps_profiled:
        prog.reported = True
        report(tr, prog, ctx.steps_profiled)
    return prog


def ms_per_step(ctx, names: Sequence[str]) -> Optional[float]:
    """Device ms a step of the operations launched in the program's
    spans named ``names`` (forward and backward), or None."""
    prog = program_of(ctx)
    if prog is None or not ctx.trace.ops or not ctx.steps_profiled or \
            not any(n in names for _, _, n in prog.spans):
        return None
    return prog.time_in(ctx.trace, names) / 1e3 / ctx.steps_profiled


def bytes_per_step(ctx) -> Optional[float]:
    """Bytes handed to the collectives a step (the ``opt`` counters)."""
    prog = program_of(ctx)
    if prog is None or not ctx.steps_profiled:
        return None
    got = [c["bytes"] for c in prog.counters
           if c.get("name") == "opt" and "bytes" in c]
    if not got:
        return None
    return sum(got) / ctx.steps_profiled


# -- the report on stderr ---------------------------------------------------

def report(trace: traces.Trace, prog: Program, steps: int) -> None:
    """The counters, the uncovered remainders and the labelled gaps."""
    opt = [c for c in prog.counters if c.get("name") == "opt"]
    r = prog.residuals
    log(f"program spans: {steps} steps profiled; markers off the clocks' "
        f"line by {statistics.median(r) if r else 0:.1f} µs (median), "
        f"{prog.slack:.1f} µs (most, the slack)")
    if opt:
        keys = [k for k in opt[0] if k != "name"]
        log("program counters a step: " + ", ".join(
            f"{k} {sum(c.get(k, 0) for c in opt) / steps:.6g}"
            for k in keys) + f" ({len(opt)} reducing steps)")
    for harness, names, metric in ((("fwd", "bwd"), MODEL,
                                    "model_fwd_bwd_ms"),
                                   (("opt",), OPT, "optimizer_step_ms")):
        ops = [o for o in trace.ops if o.span in harness]
        whole = sum(o.end - o.start for o in ops)
        merged = prog.covered(names)
        loose = sum(o.end - o.start for o in ops
                    if not prog.owns(names, o.launch, merged))
        share = 100.0 * loose / whole if whole else 0.0
        by = defaultdict(float)
        for o in ops:
            if not prog.owns(names, o.launch, merged):
                by[f"{o.span} {traces._short(o.name)}"] += o.end - o.start
        most = sorted(by.items(), key=lambda kv: -kv[1])[:3]
        log(f"program spans: {metric} {whole / 1e3 / steps:.3f} ms a "
            f"step, {loose / 1e3 / steps:.3f} ms ({share:.3f}%) in no "
            f"program span of {', '.join(names)}" + "".join(
                f"; {k} {us / 1e3 / steps:.3f} ms" for k, us in most))
    embed = prog.time_in(trace, ("embed",))
    log(f"program spans: embed {embed / 1e3 / steps:.3f} ms a step")
    gaps = idle_gaps(trace, prog)
    by = defaultdict(float)
    for us, label in gaps:
        by[label] += us
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    log("program spans: idle gaps " + "; ".join(
        f"{label} {us / 1e3 / steps:.3f} ms" for label, us in top))


def idle_gaps(trace: traces.Trace, prog: Program
              ) -> List[Tuple[float, str]]:
    """``Trace.idle_gaps`` with each gap labelled by the innermost program
    span at the launch of the operation that ends it, else by the
    harness's span."""
    w0, w1 = trace.wall()
    merged = traces.union((o.start, o.end) for o in trace.ops)
    starts = sorted(trace.ops, key=lambda o: o.start)
    inner = _Innermost(prog.spans)
    gaps, t, k = [], w0, 0
    for s, e in merged:
        if s > t:
            while k < len(starts) and starts[k].start < s:
                k += 1
            nxt = starts[k] if k < len(starts) else None
            if nxt is None:
                label = traces.OUTSIDE
            else:
                where = inner.at(nxt.launch) or prog.nearest(nxt.launch) \
                    or nxt.span
                label = f"{where} before {traces._short(nxt.name)}"
            gaps.append((s - t, label))
        t = max(t, e)
    if w1 > t:
        gaps.append((w1 - t, "tail"))
    return gaps


# -- the recording ----------------------------------------------------------

class _Recording:
    """The profiler, and the port's timeline on this rank beside it."""

    def __init__(self, prof):
        self._prof = prof
        self.path: Optional[str] = None

    def __getattr__(self, name):
        return getattr(self._prof, name)

    def start(self):
        self._prof.start()
        global LAST
        LAST = (None, None)
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import core, timeline
        if not hasattr(timeline, "ACTIVE") or \
                core._state.timeline is not None:
            return  # no step-phase spans, or a timeline of the caller's
        fd, self.path = tempfile.mkstemp(prefix="hvdbench-timeline-",
                                         suffix=".json")
        os.close(fd)
        hvd.start_timeline(self.path)

    def stop(self):
        self._prof.stop()
        if self.path is not None:
            import horovod_tpu_torch as hvd
            hvd.stop_timeline()

    def take_events(self) -> Optional[list]:
        """The timeline's events, the file removed; None if none."""
        if self.path is None:
            return None
        path, self.path = self.path, None
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            log(f"program spans: the timeline was not read ({e})")
            return []
        finally:
            os.remove(path)


def _profiler(device):
    return _Recording(_ORIGINAL["_profiler"](device))


def _read_trace(prof, spans) -> traces.Trace:
    global LAST
    tr = _ORIGINAL["_read_trace"](prof, spans)
    events = prof.take_events() if isinstance(prof, _Recording) else None
    if events is None:
        return tr
    prog, why = program_on_trace(events, spans.names, spans.times, tr)
    LAST = (tr, prog)
    if prog is None:
        log(f"program spans: left out: {why}")
    else:
        log(f"program spans: {len(prog.spans)} spans, "
            f"{len(prog.counters)} counters")
    return tr


_ORIGINAL: Dict[str, object] = {}


def install() -> None:
    """Wrap the harness's profiler and trace reader, once a process."""
    if _ORIGINAL:
        return
    _ORIGINAL["_profiler"] = train._profiler
    _ORIGINAL["_read_trace"] = train._read_trace
    train._profiler = _profiler
    train._read_trace = _read_trace


install()
