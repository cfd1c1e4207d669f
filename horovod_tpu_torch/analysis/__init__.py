"""hvdlint — distributed-correctness analysis for horovod_tpu_torch.

The host-side half of ``horovod_tpu/analysis/`` (stdlib only, no torch
at import):

* **AST linter** (rules.py / linter.py): HVD001-HVD011 over source
  files — rank-guarded collectives, exception-swallowed collectives,
  unseeded randomness / host side effects / syncs / wall clocks /
  closed-over mutation inside ``torch.compile``'d functions, undeclared
  axis literals, swallowed faults, serving PRNG provenance and device
  syncs under a serve lock.
* **hvdrace static half** (lockgraph.py): the global lock-order graph
  and thread lifecycles — HVD200-HVD203.  CLI: ``--race``.
* **hvdrace runtime half** (witness.py): the ``HVD_SANITIZE=1`` lock
  witness — HVD210 (observed inversion) / HVD211 (timeout-less wait
  holding a second lock).  The serve package installs it at import.
* **hvdmem budget** (memplan.py): the serve pool plus weights against
  ``HVD_MEM_BUDGET_BYTES`` / the card's memory — HVD302.
* **hvdshard plan** (shardplan.py): the replica plan's go/no-go
  (HVD302 + HVD401 on the per-step comm bytes) and the ``--comm`` AST
  pass's dead mesh axis (HVD404).

CLI: ``python -m horovod_tpu_torch.analysis [--race|--comm|--all]
<paths>``; exit 0 clean, 1 findings, 2 internal error.  The trace-time
passes (the JAX package's ``jaxpr_check.py``, the liveness and sharding
walks, ``hook.py`` with ``HVD_ANALYZE=1``) need a torch graph source and
are not ported yet.
"""

from .findings import ERROR, WARNING, Finding, Rule, RULES, \
    rule_selected, unsuppressed  # noqa: F401
from .linter import lint_file, lint_paths, lint_source, iter_python_files  # noqa: F401
from .lockgraph import (analyze_paths as race_paths,  # noqa: F401
                        analyze_source as race_source,
                        analyze_sources as race_sources)
from .memplan import (MemReport, check_pool_budget,  # noqa: F401
                      device_budget_bytes, params_bytes)
from .shardplan import (CommReport, PlanVerdict,  # noqa: F401
                        check_replica_plan, comm_budget_bytes,
                        analyze_paths as comm_paths,
                        analyze_source as comm_source)
from .cli import main  # noqa: F401
from . import witness  # noqa: F401
