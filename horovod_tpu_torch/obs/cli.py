"""``hvdtrace`` — merge fleet trace shards and print the per-request
critical-path summary.  Copied from ``horovod_tpu/obs/cli.py``.

::

    hvdtrace --dir /tmp/hvdtrace -o fleet-trace.json
    python -m horovod_tpu_torch.obs --dir /tmp/hvdtrace --kv host:port

Exit contract: 0 merged, 1 no shards found / unreadable dir, 2 usage
(argparse).  The merged file is a Chrome-trace JSON array openable in
Perfetto / chrome://tracing; the summary prints one line per request
(queue / prefill / decode / spec / retry milliseconds, replicas
crossed, retry counts) — the latency decomposition the fleet controller
consumes in histogram form from ``/metrics``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional


def _fmt_summary(trace_id: str, cp: dict) -> str:
    st = cp["stages_ms"]
    extras = []
    if cp["resubmissions"]:
        extras.append(f"resubmits={cp['resubmissions']}")
    if cp["kv_retries"]:
        extras.append(f"kv_retries={cp['kv_retries']}")
    return (f"{trace_id}  total={cp['total_ms']:9.2f}ms  "
            f"queue={st['queue']:8.2f}  prefill={st['prefill']:8.2f}  "
            f"decode={st['decode']:8.2f}  retry={st['retry']:8.2f}  "
            f"replicas={','.join(cp['replicas']) or '-'}"
            + ("  " + " ".join(extras) if extras else ""))


def run_commandline(argv: Optional[list] = None) -> int:
    from . import merge as _merge

    parser = argparse.ArgumentParser(
        prog="hvdtrace",
        description="Merge hvdtrace shards (HVD_TRACE_DIR) from every "
                    "rank/replica into one Perfetto-openable Chrome "
                    "trace with clock-offset alignment, and print the "
                    "per-request critical-path summary")
    parser.add_argument("--dir", "-d", default=os.environ.get(
        "HVD_TRACE_DIR", "."), help="shard directory (default: "
        "HVD_TRACE_DIR or the current directory)")
    parser.add_argument("--out", "-o", default=None,
                        help="merged Chrome-trace JSON output path "
                             "(omit to only print the summary)")
    parser.add_argument("--kv", default=None, metavar="ADDR:PORT",
                        help="rendezvous KV to read clock anchors from "
                             "(tracing.publish_clock_anchor) — refines "
                             "shard alignment and records the RTT skew "
                             "bound")
    parser.add_argument("--json", action="store_true",
                        help="print the summary as JSON instead of text")
    parser.add_argument("--timeline", action="append", default=[],
                        metavar="FILE",
                        help="also fold an in-process Timeline chrome "
                             "trace (horovod_tpu_torch.timeline) into the "
                             "merged output — COLLECTIVE/MEMORY/"
                             "COMM_CENSUS counters and ELASTIC instants "
                             "land next to the request spans under "
                             "their own pid (repeatable; no cross-clock "
                             "alignment: timelines carry no wall anchor)")
    args = parser.parse_args(argv)

    if not os.path.isdir(args.dir):
        print(f"hvdtrace: no such directory: {args.dir}", file=sys.stderr)
        return 1
    shards = _merge.load_shards(args.dir)
    if not shards:
        print(f"hvdtrace: no trace-*.jsonl shards under {args.dir} "
              f"(set HVD_TRACE_DIR on the serving processes)",
              file=sys.stderr)
        return 1
    if args.kv:
        try:
            addr, port = args.kv.rsplit(":", 1)
            from ..runner.http_server import KVStoreClient
            _merge.apply_kv_anchors(
                shards, _merge.kv_anchors(KVStoreClient(addr, int(port))))
        except Exception as e:
            print(f"hvdtrace: KV anchor read failed ({e}); falling back "
                  f"to shard anchors", file=sys.stderr)

    events, meta = _merge.merge_chrome(shards)
    for path in args.timeline:
        if not os.path.isfile(path):
            print(f"hvdtrace: no such timeline file: {path}",
                  file=sys.stderr)
            return 1
    if args.timeline:
        events, meta = _merge.append_timelines(events, meta,
                                               args.timeline)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(events, fh)
        print(f"hvdtrace: wrote {len(events)} events from "
              f"{len(shards)} shard(s) ({meta['traces']} trace(s)) to "
              f"{args.out}")
    summary = _merge.summarize(shards)
    if args.json:
        print(json.dumps({"meta": meta, "traces": summary}, indent=2))
    else:
        for tid in sorted(summary,
                          key=lambda t: -summary[t]["total_ms"]):
            print(_fmt_summary(tid, summary[tid]))
        skews = [s["skew_bound_ns"] for s in meta["shards"]
                 if s["skew_bound_ns"] is not None]
        if skews:
            print(f"# clock skew bound (KV RTT): "
                  f"{max(skews) / 1e6:.3f} ms across "
                  f"{len(skews)} anchored shard(s)")
    return 0
