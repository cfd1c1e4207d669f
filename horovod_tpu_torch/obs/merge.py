"""Fleet-wide trace aggregation: merge per-process/per-component trace
shards into one Perfetto-openable Chrome trace + a per-request
critical-path summary.

Copied from ``horovod_tpu/obs/merge.py`` (pure Python).

Shards (obs/tracing.py) are JSONL files of span/instant/flow records in
each process's OWN monotonic clock, headed by an anchor record pairing
``time.time_ns()`` with ``time.monotonic_ns()`` at shard open.  The
merge maps every event onto one wall-clock axis:

    wall(ev) = ev.t_ns - anchor.mono_ns + anchor.wall_ns

so per-shard monotonic bases (process start times) drop out; the
residual error between HOSTS is their wall-clock skew, which the
optional rendezvous-KV anchors (tracing.publish_clock_anchor) bound by
the measured KV round-trip time — the merge records that bound per shard
in the output metadata instead of pretending alignment is exact.  After
alignment a parent/child clamp enforces the invariant a human reads the
tree by: a child span never begins before its parent (sub-RTT skew
otherwise draws causality backwards).

The critical-path summary answers the fleet's question — where did
this request's latency go? — as queue vs prefill vs decode vs retry time
per trace, with the replicas it crossed and its KV-retry count.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

#: Span names that aggregate into each critical-path stage.
STAGE_SPANS = {
    "queue": ("queue-wait",),
    "prefill": ("prefill", "prefill-chunk"),
    "decode": ("decode",),
    "retry": ("resubmission", "kv-retry"),
}


class Shard:
    """One loaded shard: its anchor + events, clock-aligned lazily."""

    def __init__(self, path: str, anchor: Optional[dict],
                 events: List[dict]):
        self.path = path
        self.anchor = anchor
        self.events = events
        self.rtt_ns: Optional[int] = None  # KV-refined skew bound

    @property
    def label(self) -> str:
        if self.anchor is not None:
            return str(self.anchor.get("label", "?"))
        return os.path.basename(self.path)

    def wall_ns(self, t_ns: int) -> int:
        """Monotonic → wall (module doc); identity with offset 0 when the
        shard carries no anchor (flagged in the merge metadata)."""
        if self.anchor is None:
            return int(t_ns)
        return int(t_ns - self.anchor["mono_ns"] + self.anchor["wall_ns"])


def load_shards(trace_dir: str) -> List[Shard]:
    """Every ``trace-*.jsonl`` under ``trace_dir``, anchors split out."""
    shards = []
    for path in sorted(glob.glob(os.path.join(trace_dir,
                                              "trace-*.jsonl"))):
        anchor, events = None, []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail write (killed process)
                if rec.get("type") == "anchor":
                    if anchor is None:
                        anchor = rec
                else:
                    events.append(rec)
        shards.append(Shard(path, anchor, events))
    return shards


def _anchor_proc(a: dict):
    """Host-qualified process identity of an anchor (``proc``; older
    anchors fall back to the bare pid — unique only single-host)."""
    return a.get("proc", a.get("pid"))


def kv_anchors(kv_client) -> Dict[object, dict]:
    """Clock anchors published through the rendezvous KV
    (tracing.publish_clock_anchor), keyed by host-qualified process
    tag — the RTT-bounded refinement source for shards whose processes
    published one.  A bare pid key would collide across hosts
    (containerized replicas are routinely all pid 1)."""
    from .tracing import CLOCK_SCOPE
    out: Dict[object, dict] = {}
    for _, raw in kv_client.scan(CLOCK_SCOPE).items():
        try:
            a = json.loads(raw)
            out[_anchor_proc(a)] = a
        except (ValueError, KeyError, TypeError):
            continue
    return out


def apply_kv_anchors(shards: List[Shard],
                     anchors: Dict[object, dict]) -> None:
    """Attach the KV skew bound (and backfill missing anchors) from the
    rendezvous-KV exchange, matched on host-qualified process tags."""
    for s in shards:
        proc = (_anchor_proc(s.anchor) if s.anchor is not None
                else None)
        a = anchors.get(proc) if proc is not None else None
        if a is None and s.anchor is None and len(anchors) == 1:
            a = next(iter(anchors.values()))
        if a is not None:
            if s.anchor is None:
                s.anchor = a
            s.rtt_ns = a.get("rtt_ns")


def spans_by_trace(shards: List[Shard]) -> Dict[str, List[dict]]:
    """All events grouped by trace id, each stamped with aligned wall
    times (``wall0_ns``/``wall1_ns`` for spans, ``wall_ns`` for points)
    and its shard label."""
    traces: Dict[str, List[dict]] = {}
    for s in shards:
        for ev in s.events:
            ev = dict(ev, shard=s.label)
            if ev["type"] == "span":
                ev["wall0_ns"] = s.wall_ns(ev["t0_ns"])
                ev["wall1_ns"] = s.wall_ns(ev["t1_ns"])
            else:
                ev["wall_ns"] = s.wall_ns(ev["t_ns"])
            traces.setdefault(ev["trace"], []).append(ev)
    return traces


def build_tree(spans: List[dict]) -> List[dict]:
    """Span list → forest of {span, children} nodes.  Parent ids that
    resolve nowhere (upstream hop not captured locally) root their
    subtree.  When aligned wall times exist, children are clamped to
    start no earlier than their parent (module doc)."""
    nodes = {s["span"]: dict(s, children=[]) for s in spans}
    roots = []
    for sid, node in nodes.items():
        parent = nodes.get(node.get("parent"))
        if parent is None:
            roots.append(node)
        else:
            parent["children"].append(node)

    def clamp(node, floor_ns):
        if "wall0_ns" in node and floor_ns is not None:
            if node["wall0_ns"] < floor_ns:
                shift = floor_ns - node["wall0_ns"]
                node["wall0_ns"] += shift
                node["wall1_ns"] += shift
                node["clock_clamped_ns"] = shift
        here = node.get("wall0_ns", floor_ns)
        for c in node["children"]:
            clamp(c, here)

    for r in roots:
        clamp(r, None)
        _sort_children(r)
    roots.sort(key=_node_ts)
    return roots


def _node_ts(n: dict) -> int:
    # Aligned wall time when the merge stamped it; raw monotonic stamp
    # for single-process trees (the /trace endpoint's recent buffer).
    return n.get("wall0_ns",
                 n.get("wall_ns", n.get("t0_ns", n.get("t_ns", 0))))


def _sort_children(node: dict) -> None:
    node["children"].sort(key=_node_ts)
    for c in node["children"]:
        _sort_children(c)


def local_roots(spans: List[dict]) -> List[dict]:
    """Spans whose parent resolves to no LOCAL span — the tree roots.
    A trace continued from an upstream hop (inbound ``X-Parent-Span``)
    has a root whose parent id names a span the upstream service holds:
    still a root here (the same rule ``build_tree`` applies)."""
    ids = {s["span"] for s in spans}
    return [s for s in spans
            if s.get("parent") is None or s["parent"] not in ids]


def critical_path(events: List[dict]) -> dict:
    """One trace's latency decomposition (module doc): per-stage
    milliseconds from its spans, total from the root span, plus the
    replicas the request crossed and its retry/resubmission counts."""
    spans = [e for e in events if e["type"] == "span"]
    roots = local_roots(spans)
    # Prefer the designated request root over orphaned children (a
    # child can arrive in a shard whose root went to another shard).
    roots.sort(key=lambda s: (s["name"] not in ("http-handle",
                                                "request"),
                              s["t0_ns"]))
    root = roots[0] if roots else None
    by_stage = {k: 0.0 for k in STAGE_SPANS}
    counts = {"kv_retries": 0, "resubmissions": 0, "prefill_chunks": 0}
    replicas = set()
    for s in spans:
        dur_ms = (s["t1_ns"] - s["t0_ns"]) / 1e6
        for stage, names in STAGE_SPANS.items():
            if s["name"] in names:
                by_stage[stage] += dur_ms
        if s["name"] == "kv-retry":
            counts["kv_retries"] += 1
        elif s["name"] == "resubmission":
            counts["resubmissions"] += 1
        elif s["name"] == "prefill-chunk":
            counts["prefill_chunks"] += 1
        proc = s.get("proc", "")
        if proc not in ("server", "kv-client") and proc:
            replicas.add(proc)
    if root is not None and root["name"] in ("http-handle", "request"):
        total_ms = (root["t1_ns"] - root["t0_ns"]) / 1e6
    elif spans:
        # No designated request root captured (partial shard set):
        # total = the spans' overall envelope, not a lossy stage sum —
        # on the ALIGNED axis when the merge stamped one (raw monotonic
        # stamps from different processes do not share a zero).
        total_ms = (max(s.get("wall1_ns", s["t1_ns"]) for s in spans)
                    - min(s.get("wall0_ns", s["t0_ns"])
                          for s in spans)) / 1e6
    else:
        total_ms = sum(by_stage.values())
    return {
        "total_ms": round(total_ms, 3),
        "stages_ms": {k: round(v, 3) for k, v in by_stage.items()},
        "replicas": sorted(replicas),
        "root": root["name"] if root is not None else None,
        **counts,
    }


def merge_chrome(shards: List[Shard]) -> Tuple[List[dict], dict]:
    """Shards → (Chrome-trace event array, merge metadata).

    Spans render as async begin/end pairs keyed by trace id, flows as
    s/t/f, instants as i — the same rendering the in-process Timeline
    uses, so a merged fleet trace reads identically to a single-process
    one.  Events are globally time-sorted: the output's ``ts`` axis is
    monotonic by construction.
    """
    labels = sorted({s.label for s in shards})
    pid_of = {label: i for i, label in enumerate(labels)}
    base_ns = None
    for s in shards:
        for ev in s.events:
            t = s.wall_ns(ev.get("t0_ns", ev.get("t_ns", 0)))
            base_ns = t if base_ns is None else min(base_ns, t)
    base_ns = base_ns or 0

    def us(wall_ns: int) -> float:
        return (wall_ns - base_ns) / 1e3

    out: List[dict] = []
    for label in labels:
        out.append({"name": "process_name", "ph": "M",
                    "pid": pid_of[label], "args": {"name": label}})
    timed: List[dict] = []
    for s in shards:
        pid = pid_of[s.label]
        for ev in s.events:
            if ev["type"] == "span":
                base = {"cat": "hvdtrace", "id": ev["trace"],
                        "name": ev["name"], "pid": pid,
                        "tid": ev["trace"][:8]}
                args = dict(ev.get("args", {}), span=ev["span"],
                            parent=ev.get("parent"), shard=s.label)
                timed.append(dict(base, ph="b",
                                  ts=us(s.wall_ns(ev["t0_ns"])),
                                  args=args))
                timed.append(dict(base, ph="e",
                                  ts=us(s.wall_ns(ev["t1_ns"]))))
            elif ev["type"] == "flow":
                rec = {"cat": "hvdtrace-flow", "id": ev["trace"],
                       "name": ev["name"], "ph": ev["phase"],
                       "ts": us(s.wall_ns(ev["t_ns"])), "pid": pid,
                       "tid": ev["trace"][:8]}
                if ev["phase"] == "f":
                    rec["bp"] = "e"
                timed.append(rec)
            else:  # instant
                timed.append({
                    "name": f"hvdtrace/{ev['name']}", "ph": "i", "s": "p",
                    "ts": us(s.wall_ns(ev["t_ns"])), "pid": pid,
                    "tid": ev["trace"][:8],
                    "args": dict(ev.get("args", {}),
                                 trace_id=ev["trace"])})
    timed.sort(key=lambda e: (e["ts"], 0 if e.get("ph") != "e" else 1))
    meta = {
        "shards": [{
            "label": s.label, "path": os.path.basename(s.path),
            "events": len(s.events), "anchored": s.anchor is not None,
            "skew_bound_ns": s.rtt_ns,
        } for s in shards],
        "traces": len({e["trace"] for s in shards for e in s.events}),
    }
    return out + timed, meta


def load_timeline_events(path: str) -> List[dict]:
    """In-process ``Timeline`` chrome-trace array (timeline.py) → event
    list.  Tolerates an unterminated array (killed process: the writer
    thread never wrote the closing bracket) by falling back to
    line-wise parsing — the same torn-tail discipline ``load_shards``
    applies to JSONL shards."""
    with open(path) as fh:
        text = fh.read()
    try:
        evs = json.loads(text)
    except ValueError:
        evs = []
        for line in text.splitlines():
            line = line.strip().rstrip(",")
            if not line or line in ("[", "]"):
                continue
            try:
                evs.append(json.loads(line))
            except ValueError:
                continue  # torn tail write
    return [e for e in evs if isinstance(e, dict)]


def append_timelines(events: List[dict], meta: dict,
                     paths: List[str]) -> Tuple[List[dict], dict]:
    """Fold in-process Timeline files (COLLECTIVE/MEMORY/COMM_CENSUS
    counters, ELASTIC instants, op lifecycle) into a merged fleet trace
    under their own pids.  Timelines carry no wall-clock anchor (their
    ``ts`` axis is µs since Timeline open), so events keep their own
    time base — counters and instants read fine in Perfetto per
    process, and the metadata says which pids are unaligned rather than
    pretending they share the request-span axis."""
    used = {e.get("pid") for e in events if isinstance(e.get("pid"), int)}
    next_pid = (max(used) + 1) if used else 0
    meta = dict(meta, timelines=[])
    for path in paths:
        tl_events = load_timeline_events(path)
        label = f"timeline:{os.path.basename(path)}"
        events.append({"name": "process_name", "ph": "M",
                       "pid": next_pid, "args": {"name": label}})
        for ev in tl_events:
            if ev.get("ph") == "M":
                continue  # one process_name per file, assigned above
            events.append(dict(ev, pid=next_pid))
        meta["timelines"].append({
            "label": label, "path": os.path.basename(path),
            "events": len(tl_events), "pid": next_pid,
            "aligned": False,
        })
        next_pid += 1
    return events, meta


def summarize(shards: List[Shard]) -> Dict[str, dict]:
    """Per-trace critical-path summaries keyed by trace id."""
    return {tid: critical_path(evs)
            for tid, evs in spans_by_trace(shards).items()}
