"""horovod_tpu_torch.obs — end-to-end distributed request tracing and
fleet-wide trace aggregation (``hvdtrace``).

The Horovod Timeline (timeline.py) answers "what was each rank doing";
this subsystem answers "where did THIS request's latency go" across the
serving fleet — http-handle → route → queue-wait → prefill
chunk(s) → per-iteration decode flow → KV retries → failover
resubmission — in the Dapper/OpenTelemetry mold, rendered into the same
Chrome-trace machinery so request spans, training-op lifecycles,
FAULTLINE instants, and SERVE counters share one Perfetto view.

Copied from ``horovod_tpu/obs/__init__.py``.  Layers:

* :mod:`tracing` — TraceContext + contextvar propagation, the sampled
  process-global :class:`~tracing.Tracer` (``HVD_TRACE_SAMPLE``, zero
  hot-path cost when off), per-component JSONL trace shards
  (``HVD_TRACE_DIR``), wire propagation via ``X-Trace-Id`` /
  ``X-Parent-Span``;
* :mod:`merge` — shard loading, wall-clock alignment with rendezvous-KV
  RTT skew bounds, span-tree building, per-request critical paths;
* :mod:`cli`  — the ``hvdtrace`` console entry
  (``python -m horovod_tpu_torch.obs``).

Quickstart::

    HVD_TRACE_SAMPLE=0.05 HVD_TRACE_DIR=/tmp/hvdtrace hvdserve ...
    hvdtrace --dir /tmp/hvdtrace -o fleet.json   # open in Perfetto
"""

# NOTE: the live tracer global is ``tracing.TRACER`` — deliberately NOT
# re-exported here: ``from .tracing import TRACER`` would bind an
# import-time snapshot (None) that install() never rebinds, silently
# disabling any consumer that guarded on it.  Check ``tracing.TRACER``
# (or call ``active_tracer()``) instead.
from .tracing import (  # noqa: F401
    CLOCK_SCOPE, TraceContext, Tracer, active_tracer, clock_anchor,
    current, current_trace_id, install, maybe_install_from_env, pop,
    publish_clock_anchor, push, scope, uninstall,
)
from .merge import (  # noqa: F401
    Shard, build_tree, critical_path, kv_anchors, load_shards,
    merge_chrome, spans_by_trace, summarize,
)
from .cli import run_commandline  # noqa: F401
