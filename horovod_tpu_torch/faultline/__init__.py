"""Deterministic fault injection for the serving and control planes.

Copied from ``horovod_tpu/faultline/__init__.py`` (pure Python; the port
keeps its own copy and never imports the JAX package).

The recovery paths this repo grew (poisoned-batch recovery, preemption
failover, KV put_wait retry) were each proved by a hand-built test;
faultline makes failure a first-class, *seeded* input instead: a
:class:`FaultPlan` schedules named faults (``plan.KINDS``) at
reproducible step indices of named injection points (``plan.POINTS``)
threaded through ``serve/engine`` (step boundary), ``serve/replica``
(routing), the runner KV client (request boundary), and the elastic
preemption sentinel (marker publication).  Identical
``HVD_FAULTLINE_SEED`` → identical schedule → identical firing log,
which is what lets the chaos soak assert *convergence* ("back to
``healthz: ok``, zero lost or incorrect responses") rather than merely
"nothing crashed this time".

Off by default, zero hot-path cost (runtime.py module doc).

The port fires three of ``plan.POINTS``: ``engine.step`` (the serve
engine's step boundary: ``slow-decode``, ``pool-corrupt-block``,
``poison-step``), ``registry.roll`` (``swap-abort``) and ``stream.emit``
(``stream-disconnect``, ``slow-client``).  The others are parsed and
scheduled, and fire once the modules that own them are ported.

Quickstart::

    from horovod_tpu_torch import faultline
    plan = faultline.FaultPlan([
        faultline.FaultSpec("kill-rank", target="host-3", repeat=4),
        faultline.FaultSpec("drop-kv-response", repeat=2),
        faultline.FaultSpec("poison-step", target="replica-1"),
    ], seed=7)
    faultline.install(plan)
    ...  # run load; plan.log / plan.firing_sequence() say what fired
    faultline.uninstall()

or, with no code changes::

    HVD_FAULTLINE_SEED=7 \\
    HVD_FAULTLINE_PLAN='kill-rank:host-3*4,drop-kv-response*2' hvdserve ...
"""

from .plan import (  # noqa: F401
    DEFAULT_POINT, HORIZON, KINDS, POINTS, FaultInjected, FaultPlan,
    FaultSpec, diurnal_load, parse_plan, parse_spec,
)
from .runtime import (  # noqa: F401
    active_plan, fire, install, maybe_install_from_env, uninstall,
)
