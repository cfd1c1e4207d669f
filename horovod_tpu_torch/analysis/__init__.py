"""hvdlint — distributed-correctness analysis for horovod_tpu_torch.

Port of ``horovod_tpu/analysis/`` (the package imports no torch at
module level; the trace-time passes import it when they run):

* **AST linter** (rules.py / linter.py): HVD001-HVD011 over source
  files — rank-guarded collectives, exception-swallowed collectives,
  unseeded randomness / host side effects / syncs / wall clocks /
  closed-over mutation inside ``torch.compile``'d functions, undeclared
  axis literals, swallowed faults, serving PRNG provenance and device
  syncs under a serve lock.
* **graph checker** (graph_check.py): a step traced by ``make_fx`` on
  fake tensors — the collective census, HVD100 (trace failure), HVD101
  (undeclared axis), HVD102 (``torch.cond`` branches with different
  collective signatures).
* **hvdrace static half** (lockgraph.py): the global lock-order graph
  and thread lifecycles — HVD200-HVD203.  CLI: ``--race``.
* **hvdrace runtime half** (witness.py): the ``HVD_SANITIZE=1`` lock
  witness — HVD210 (observed inversion) / HVD211 (timeout-less wait
  holding a second lock).  The serve package installs it at import.
* **hvdmem** (memplan.py): the liveness walk of the same graph (peak
  live bytes, allocation by aten op; HVD300 / HVD302 / HVD303 / HVD304)
  and the serve pool plus weights against ``HVD_MEM_BUDGET_BYTES`` / the
  card's memory (HVD302).
* **hvdshard** (shardplan.py): the communication walk of the same graph
  (wire bytes by collective and axis; HVD401-HVD404), the replica
  plan's go/no-go (HVD302 + HVD401 on the per-step comm bytes) and the
  ``--comm`` AST pass's dead mesh axis (HVD404).
* **the ``HVD_ANALYZE=1`` hook** (hook.py): the three walks on the first
  call of a ``shard_step``, of a ``DistributedOptimizer``'s reduction
  and of each serve program, published to ``hvd.analysis_reports()``
  and the timeline.

CLI: ``python -m horovod_tpu_torch.analysis [--race|--comm|--all]
<paths>``; exit 0 clean, 1 findings, 2 internal error.
"""

from .findings import ERROR, WARNING, Finding, Rule, RULES, \
    rule_selected, unsuppressed  # noqa: F401
from .linter import lint_file, lint_paths, lint_source, iter_python_files  # noqa: F401
from .lockgraph import (analyze_paths as race_paths,  # noqa: F401
                        analyze_source as race_source,
                        analyze_sources as race_sources)
from .graph_check import (GraphReport, check_graph,  # noqa: F401
                          check_step_fn)
from .memplan import (MemReport, check_pool_budget,  # noqa: F401
                      device_budget_bytes, measure_graph, measure_step_fn,
                      params_bytes)
from .shardplan import (CommReport, PlanVerdict,  # noqa: F401
                        check_replica_plan, comm_budget_bytes,
                        measure_graph_comm, measure_step_fn_comm,
                        analyze_paths as comm_paths,
                        analyze_source as comm_source)
from .cli import main  # noqa: F401
from . import hook, witness  # noqa: F401
