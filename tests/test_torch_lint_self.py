"""Self-gate: the port stays clean under its own analyzers.

The port's counterpart of ``tests/test_lint_self.py`` and
``tests/test_race_self.py``: the linter, ``--race`` and ``--comm`` over
``horovod_tpu_torch/`` (``examples/`` included) give zero unsuppressed
findings, each suppression carries its reason on the line above, and
the walks cover the serve, obs, elastic, faultline and analysis
modules.  The JAX package's passes over the same tree agree where they
read the same constructs: both linters report nothing unsuppressed and
both lock graphs nothing; JAX's ``--comm`` flags ``dp`` as a dead axis
of the three ``make_mesh`` calls in ``entry.py``, because its HVD404
does not know ``DistributedOptimizer(reduce_axes=("dp", ...))`` as a
reduction over the axis, where the port's does.
"""

import ast
import functools
import io
import os
import threading
import time
import tokenize

from horovod_tpu.analysis import comm_paths as jax_comm_paths
from horovod_tpu.analysis import lint_paths as jax_lint_paths
from horovod_tpu.analysis import race_paths as jax_race_paths
from horovod_tpu_torch.analysis import (comm_paths, iter_python_files,
                                        lint_paths, race_paths,
                                        unsuppressed)
from horovod_tpu_torch.analysis.cli import main as cli_main
from horovod_tpu_torch.analysis.lockgraph import _Analyzer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "horovod_tpu_torch")


def _rel(path):
    return os.path.relpath(path, PORT).replace(os.sep, "/")


def _show(findings):
    return "\n".join(f.format() for f in findings)


@functools.lru_cache(maxsize=None)
def _port_pass(name):
    """One pass of the port's analyzers over the port, run once."""
    return tuple({"lint": lint_paths, "race": race_paths,
                  "comm": comm_paths}[name]([PORT]))


def test_port_is_hvdlint_clean():
    active = unsuppressed(_port_pass("lint"))
    assert not active, (
        "hvdlint found distributed-correctness antipatterns in the port "
        "— fix them or suppress each with a reasoned '# hvdlint: "
        "disable=...' comment:\n" + _show(active))


def test_port_is_hvdrace_clean():
    active = unsuppressed(_port_pass("race"))
    assert not active, (
        "hvdrace found lock-order / thread-lifecycle antipatterns in the "
        "port:\n" + _show(active))


def test_port_is_comm_clean():
    active = unsuppressed(_port_pass("comm"))
    assert not active, _show(active)


def test_suppressions_are_the_audited_ones():
    """Every suppressed finding still surfaces (suppressed=True), and the
    port's only suppression is the mismatch drill's: the join bench
    means to have the coordinator reject a mismatched allreduce."""
    suppressed = [(f.rule, _rel(f.path))
                  for name in ("lint", "race", "comm")
                  for f in _port_pass(name) if f.suppressed]
    assert suppressed == [("HVD002", "examples/join_bench.py")]


def test_every_pragma_gives_its_reason():
    """A ``# hvdlint: disable=`` comment follows a comment line that
    says why."""
    pragmas = 0
    for path in iter_python_files([PORT]):
        with open(path) as f:
            src = f.read()
        lines = src.splitlines()
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT and "hvdlint: disable" in \
                    tok.string:
                pragmas += 1
                above = lines[tok.start[0] - 2].strip()
                assert above.startswith("#") and len(above) > 20, \
                    f"{_rel(path)}:{tok.start[0]} gives no reason"
    assert pragmas == 1


def test_walks_cover_the_threaded_tree():
    files = [_rel(f) for f in iter_python_files([PORT])]
    assert len(files) > 90
    assert not any("__pycache__" in f or "_build" in f for f in files)
    for mod in ("serve/engine.py", "serve/batcher.py", "serve/blocks.py",
                "serve/replica.py", "serve/server.py", "serve/metrics.py",
                "serve/paged_attention.py", "serve/sampling.py",
                "serve/controller.py", "serve/tenancy.py",
                "serve/registry.py", "serve/tiering.py", "serve/router.py",
                "serve/router_server.py", "serve/seqpar.py",
                "serve/streaming.py", "obs/tracing.py", "obs/merge.py",
                "obs/cli.py", "elastic/__init__.py", "elastic/driver.py",
                "elastic/preemption.py", "elastic/state.py",
                "faultline/plan.py", "faultline/runtime.py",
                "analysis/rules.py", "analysis/lockgraph.py",
                "analysis/witness.py", "analysis/memplan.py",
                "analysis/shardplan.py", "ops/negotiation.py",
                "examples/join_bench.py", "entry.py"):
        assert mod in files, f"{mod} not analyzed"


def test_race_walk_indexes_the_control_plane_locks():
    """Zero findings mean something only if the walk sees the locks:
    the serve, elastic, negotiation and tracing locks are indexed under
    their class identities, the batcher's condition is its lock, and the
    engine's and router's locks take part in ordering edges."""
    analyzer = _Analyzer()
    for path in iter_python_files([PORT]):
        with open(path) as f:
            src = f.read()
        analyzer.add_module(ast.parse(src, filename=path), path, src)
    analyzer.run()
    for label in ("DynamicBatcher._lock", "ServeMetrics._lock",
                  "InferenceEngine._lock", "ReplicaScheduler._lock",
                  "BlockManager._lock", "HostTier._lock",
                  "ElasticDriver._lock", "WorldWatch._lock",
                  "Negotiator._buf_lock", "Negotiator._flush_lock",
                  "Tracer._lock", "FleetController._lock",
                  "ModelRegistry._lock", "Router._lock",
                  "RouterMetrics._lock"):
        assert label in analyzer.lock_sites, label
    assert "DynamicBatcher._cond" not in analyzer.lock_sites
    assert ("InferenceEngine._lock", "ServeMetrics._lock") in analyzer.graph
    assert ("Router._lock", "RouterMetrics._lock") in analyzer.graph


def test_jax_passes_over_the_port_agree():
    jax_lint = jax_lint_paths([PORT])
    assert not unsuppressed(jax_lint)
    assert [(f.rule, _rel(f.path), f.suppressed) for f in jax_lint] == \
        [("HVD002", "examples/join_bench.py", True)]
    assert not unsuppressed(jax_race_paths([PORT]))
    # JAX's HVD404 misreads reduce_axes=("dp", ...) as no use of "dp";
    # the port's HVD404 reads it.
    misread = [(f.rule, _rel(f.path)) for f in
               unsuppressed(jax_comm_paths([PORT]))]
    assert misread == [("HVD404", "entry.py")] * 3
    assert not unsuppressed(comm_paths([os.path.join(PORT, "entry.py")]))


def test_cli_dogfood_command_exits_zero(capsys):
    """``python -m horovod_tpu_torch.analysis --all horovod_tpu_torch``
    (lint, --race and --comm over one walk), in process."""
    assert cli_main(["--all", PORT]) == 0
    out = capsys.readouterr().out
    for name in ("lint", "race", "comm"):
        assert f"hvdlint [{name}]: 0 finding(s)" in out


def test_world_watch_reads_the_rendezvous_off_its_lock():
    """``WorldWatch.moved`` claims its period under the lock and does the
    KV GET outside it: while one thread waits on a slow GET, another
    takes the lock at once and reads the old verdict; the GET's answer
    then lands."""
    from horovod_tpu_torch.elastic import WorldWatch

    entered, release = threading.Event(), threading.Event()

    class SlowClient:
        def get(self, scope, key):
            entered.set()
            release.wait(10)
            return b'{"version": 3}'

    watch = WorldWatch.__new__(WorldWatch)
    watch.version, watch.period = 1, 0.0
    watch._client, watch._last, watch._moved = SlowClient(), 0.0, False
    watch._lock = threading.Lock()
    answers = []
    t = threading.Thread(target=lambda: answers.append(watch.moved()),
                         daemon=True)
    t.start()
    assert entered.wait(10)
    t0 = time.monotonic()
    assert watch._lock.acquire(timeout=1.0)
    watch._lock.release()
    assert time.monotonic() - t0 < 1.0
    release.set()
    t.join(10)
    assert answers == [True] and watch.moved()
