"""A profiler trace reduced to what the per-layer metrics read.

Input: the events of ``torch.profiler``'s Chrome trace (its
``traceEvents``).  Read from it:

* device operations: kernels, copies and sets (``cat`` ``kernel``,
  ``gpu_memcpy``, ``gpu_memset``), each with its interval in µs and the
  ``correlation`` id of the host call that launched it;
* launches: host runtime and driver calls (``cuda_runtime``,
  ``cuda_driver``) by correlation id, whose start is the launch time;
* spans: the harness's span boundaries (``fwd``, ``bwd``, ``opt``,
  ``data``).  The harness profiles the device alone (CUDA activity: the
  host's operator events would cost a quarter of a GPT-2 step), and marks
  each span's entry and exit with a ``cudaStreamQuery`` on its main
  thread and notes the host clock (``time.perf_counter``) of each; the
  markers are found by their count on a thread, or else by time
  (``match_markers``).  A trace with host activity carries the spans as
  ``user_annotation`` events instead.  Where the markers are not all
  found, the trace holds no span, and a reader of spans reads nothing
  (``has_spans``), rather than 0.

A device operation belongs to the span its launch falls in, on any host
thread (the backward launches from autograd's thread while the main
thread sits in the ``bwd`` span).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SPANS = ("data", "fwd", "bwd", "opt")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside"
MARKER = "cudaStreamQuery"


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    start: float   # µs
    end: float
    launch: Optional[float]   # µs, None when no launch record matched
    span: str


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """The intervals merged: sorted, disjoint."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(merged: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in merged)


class _SpanIndex:
    def __init__(self, spans: Sequence[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: Optional[float]) -> str:
        if t is None:
            return OUTSIDE
        i = bisect.bisect_right(self.starts, t) - 1
        # spans of one thread do not overlap; check a few back for nesting
        for j in range(i, max(-1, i - 4), -1):
            s, e, name = self.spans[j]
            if s <= t <= e:
                return name
        return OUTSIDE


@dataclasses.dataclass
class Trace:
    ops: List[Op]
    spans: List[Tuple[float, float, str]]

    @classmethod
    def from_events(cls, events: Iterable[dict],
                    marker_names: Sequence[str] = (),
                    marker_times: Sequence[float] = ()) -> "Trace":
        """The harness's ``MARKER`` calls at host times ``marker_times``
        (µs, entry and exit of each of ``marker_names``) bound its spans
        (``match_markers``); where the times do not all find their
        calls, no span is read from them."""
        launches: Dict[int, float] = {}
        device, spans = [], []
        marks: Dict[str, List[float]] = defaultdict(list)
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            args = ev.get("args") or {}
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            if cat in DEVICE_CATS:
                device.append((ev.get("name", ""), cat, ts, ts + dur,
                               args.get("correlation")))
            elif cat in LAUNCH_CATS:
                if ev.get("name") == MARKER and marker_names:
                    marks[str(ev.get("tid"))].append(ts)
                elif "correlation" in args:
                    launches[int(args["correlation"])] = ts
            elif cat == "user_annotation" and ev.get("name") in SPANS:
                spans.append((ts, ts + dur, ev["name"]))
        found = match_markers(marks, list(marker_times))
        if marker_names and found is not None \
                and len(found) == 2 * len(marker_names):
            spans += [(found[2 * i], found[2 * i + 1], name)
                      for i, name in enumerate(marker_names)]
        index = _SpanIndex(spans)
        ops = []
        for name, cat, s, e, corr in device:
            t = launches.get(int(corr)) if corr is not None else None
            ops.append(Op(name, cat, s, e, t, index.at(t)))
        ops.sort(key=lambda o: o.start)
        return cls(ops=ops, spans=sorted(spans))

    @classmethod
    def from_file(cls, path: str, marker_names: Sequence[str] = (),
                  marker_times: Sequence[float] = ()) -> "Trace":
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        return cls.from_events(events, marker_names, marker_times)

    # -- what the readers use ------------------------------------------

    def kernels(self) -> List[Op]:
        return [o for o in self.ops if o.cat == "kernel"]

    def wall(self) -> Tuple[float, float]:
        """From the first span's or operation's start to the last
        span's or operation's end, µs."""
        starts = [s for s, _, _ in self.spans] + [o.start for o in self.ops]
        ends = [e for _, e, _ in self.spans] + [o.end for o in self.ops]
        if not starts:
            return 0.0, 0.0
        return min(starts), max(ends)

    def busy(self) -> float:
        """µs in which any device operation ran, on any stream."""
        return length(union((o.start, o.end) for o in self.ops))

    def has_spans(self, names: Sequence[str]) -> bool:
        """Whether every one of ``names`` bounds some span of the trace."""
        have = {name for _, _, name in self.spans}
        return all(n in have for n in names)

    def time_in(self, spans: Sequence[str]) -> float:
        """Device µs of the operations launched in ``spans``."""
        return sum(o.end - o.start for o in self.ops if o.span in spans)

    def exposed(self, is_comm) -> float:
        """µs in which a communication operation runs and no other
        operation does."""
        every = union((o.start, o.end) for o in self.ops)
        rest = union((o.start, o.end) for o in self.ops if not is_comm(o))
        return length(every) - length(rest)

    def idle_gaps(self) -> List[Tuple[float, str]]:
        """Each stretch of the wall span with no device operation, in
        µs, labelled by the span the host was in when it launched the
        operation that ends the gap (``outside`` between spans), and
        that operation's name; a gap at the end is labelled ``tail``."""
        w0, w1 = self.wall()
        merged = union((o.start, o.end) for o in self.ops)
        starts = sorted(self.ops, key=lambda o: o.start)
        gaps, t, k = [], w0, 0
        for s, e in merged:
            if s > t:
                while k < len(starts) and starts[k].start < s:
                    k += 1
                nxt = starts[k] if k < len(starts) else None
                label = f"{nxt.span} before {_short(nxt.name)}" if nxt \
                    else OUTSIDE
                gaps.append((s - t, label))
            t = max(t, e)
        if w1 > t:
            gaps.append((w1 - t, "tail"))
        return gaps

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` device operations that took most time in all, by
        name, µs."""
        by = defaultdict(float)
        for o in self.ops:
            by[_short(o.name, 100)] += o.end - o.start
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """Idle µs summed by label, the ``n`` largest."""
        by = defaultdict(float)
        for us, label in self.idle_gaps():
            by[label] += us
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def match_markers(calls_by_thread: Dict[str, List[float]],
                  noted: Sequence[float], tol: float = 150.0
                  ) -> Optional[List[float]]:
    """The trace times of the harness's marker calls, one per noted host
    time, in order; None when they cannot be told apart.

    A thread whose calls are as many as the noted times made them all
    (the trace names threads by its own ids, not the system's).  Else,
    on the thread with most calls, the offset between the clocks that
    lets every noted time find, in order, a call within ``tol`` µs (the
    first within 2 ms: the first call after the profiler starts is
    stamped early), the offset with the least residue where several
    do."""
    if not noted:
        return None
    groups = sorted(calls_by_thread.values(), key=len, reverse=True)
    for calls in groups:
        if len(calls) == len(noted):
            return sorted(calls)
    if not groups or len(groups[0]) < len(noted):
        return None
    calls = sorted(groups[0])
    mid = noted[len(noted) // 2]
    best, best_err = None, None
    for c in calls:
        offset = c - mid
        got = _in_order(calls, noted, offset, tol)
        if got is not None:
            err = sum(abs(g - t - offset) for g, t in zip(got[1:], noted[1:]))
            if best_err is None or err < best_err:
                best, best_err = got, err
    return best


def _in_order(calls, noted, offset, tol):
    """Each noted time's nearest call within its room, in order."""
    out, j = [], 0
    for i, t in enumerate(noted):
        want, room = t + offset, (2000.0 if i == 0 else tol)
        while j < len(calls) and calls[j] < want - room:
            j += 1
        k = j
        while k + 1 < len(calls) and calls[k + 1] <= want + room and \
                abs(calls[k + 1] - want) < abs(calls[k] - want):
            k += 1
        if k == len(calls) or abs(calls[k] - want) > room:
            return None
        out.append(calls[k])
        j = k + 1
    return out


def _short(name: str, width: int = 60) -> str:
    """A kernel's demangled name cut to ``width``: without ``void`` and
    with ``(anonymous namespace)`` as ``anon``, so the template arguments
    that name the functor stay in what is kept."""
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


def is_nccl(op: Op) -> bool:
    return "nccl" in op.name.lower()
