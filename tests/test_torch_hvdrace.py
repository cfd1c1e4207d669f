"""The port's hvdrace (lock graph and lock witness) against the JAX
package's.

* Every source string of ``tests/test_hvdrace.py`` (read from that
  file) goes through both lock graphs and gives identical findings,
  message for message (HVD202's names its shape by the component where
  JAX's names it by a change number); the one jax-spelled source (a ``jax.jit`` step
  called under a lock) is rewritten with ``torch.compile`` and fires on
  the same line.
* A seeded lock-order inversion and a timeout-less wait holding a second
  lock, driven once under each witness, give the same rules, sites and
  lock-label pairs.  Witnesses are installed and removed in nested order
  and ``threading``'s factories are checked to be back as found (a
  session may already run under the JAX witness with HVD_SANITIZE=1).
* The port's witness publishes to ``hvd.analysis_reports()`` and the
  timeline, and a two-replica TINY GPT-2 fleet on the CPU under the
  port's witness survives the JAX stress test's chaos (submit storm,
  expiring requests, scrapes, mark_dead / mark_alive flaps) with zero
  findings.
"""

import contextlib
import re
import threading
import time

import pytest
import torch

from horovod_tpu.analysis import witness as jax_witness
from horovod_tpu.analysis.lockgraph import analyze_source as jax_race
from horovod_tpu_torch.analysis import witness
from horovod_tpu_torch.analysis.lockgraph import analyze_source as race

from test_torch_hvdlint import corpus_sources, to_torch

RACE_CORPUS = corpus_sources("test_hvdrace.py")
JITTED = ("test_hvd201_jitted_call_under_lock", "src")


# HVD202's message names its shape in a parenthesis: the JAX package by
# the change that shipped the bug, the port by the component.
_SHAPE = re.compile(r"\(the [^()]*on_shed deadlock shape\)")


def _full(findings):
    return [(f.rule, f.path, f.line, f.col, _SHAPE.sub("(shape)", f.message),
             f.suppressed, f.source) for f in findings]


def test_race_corpus_is_read():
    assert ("<module>", "AB_BA_CORPUS") in RACE_CORPUS
    assert JITTED in RACE_CORPUS
    assert len(RACE_CORPUS) >= 25


@pytest.mark.parametrize(
    "key", sorted(k for k in RACE_CORPUS if k != JITTED), ids="/".join)
def test_lock_graphs_agree_on_the_jax_corpus(key):
    src = RACE_CORPUS[key]
    assert _full(race(src, path="corpus.py")) == \
        _full(jax_race(src, path="corpus.py"))


def test_compiled_step_under_a_lock_fires_where_jitted_fires():
    src = RACE_CORPUS[JITTED]
    torch_src = to_torch(src)
    assert "jax" not in torch_src
    got = race(torch_src, path="corpus.py")
    want = jax_race(src, path="corpus.py")
    assert [(f.rule, f.line) for f in got] == \
        [(f.rule, f.line) for f in want] == [("HVD201", 14)]
    assert "torch.compile'd" in got[0].message


# -- the witnesses ---------------------------------------------------------------

@contextlib.contextmanager
def witnesses(*mods):
    """Install ``mods`` in order (each reset), remove them in reverse,
    and check that ``threading``'s factories are back as found."""
    found = (threading.Lock, threading.RLock, threading.Condition)
    done = []
    try:
        for m in mods:
            was = m.installed()
            m.install(raise_on_violation=False)
            m.reset()
            done.append((m, was))
            if not was:
                assert threading.Lock is m.make_lock
        yield
    finally:
        for m, was in reversed(done):
            m.reset()
            if not was:
                m.uninstall()
        assert (threading.Lock, threading.RLock,
                threading.Condition) == found


def _drive_inversion():
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return {a._witness_label, b._witness_label}


def _drive_naked_wait(mod):
    other = threading.Lock()
    cond = threading.Condition()

    def waiter():
        with other:
            with cond:
                cond.wait()

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while not mod.findings() and time.monotonic() < deadline:
        time.sleep(0.01)
    with cond:
        cond.notify_all()
    t.join(5)
    return {other._witness_label, cond._witness_label}


def _seen(mod, labels):
    """The findings, and the order edges between the drive's own locks
    (a finding's log line takes the logging handler's lock too)."""
    return ([(f.rule, f.path, f.line) for f in mod.findings()],
            sorted(k for k in mod.order_graph()
                   if k[0] != k[1] and set(k) <= labels))


@pytest.mark.parametrize("drive", ["inversion", "naked_wait"])
def test_both_witnesses_see_the_same_violation(drive):
    results = []
    for mod in (witness, jax_witness):
        with witnesses(mod):
            if drive == "inversion":
                labels = _drive_inversion()
            else:
                labels = _drive_naked_wait(mod)
            results.append(_seen(mod, labels))
    (port, port_graph), (jax, jax_graph) = results
    assert port == jax
    assert [r for r, _, _ in port] == (
        ["HVD210"] if drive == "inversion" else ["HVD211"])
    assert port_graph == jax_graph and port_graph


def test_nested_witnesses_restore_threading_and_stay_clean():
    """The port's witness over the JAX one (and the reverse) restores
    the factories each found, and a consistent order is clean in
    both."""
    for order in ((jax_witness, witness), (witness, jax_witness)):
        with witnesses(*order):
            a = threading.Lock()
            b = threading.Lock()
            with a:
                with b:
                    pass
            ev = threading.Event()
            ev.set()
            assert ev.wait(0.1)
            assert witness.findings() == jax_witness.findings() == []


def test_port_witness_publishes_reports_and_timeline(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import core

    events = []

    class _Timeline:
        def witness_event(self, rule, path, line, thread):
            events.append((rule, line, thread))

    monkeypatch.setattr(core._state, "timeline", _Timeline())
    monkeypatch.setattr(core._state, "analysis_reports", [])
    with witnesses(witness):
        _drive_inversion()
        reports = [r for r in hvd.analysis_reports()
                   if isinstance(r, witness.WitnessReport)]
        assert len(reports) == 1 and not reports[0].ok()
        assert [f.rule for f in reports[0].findings] == ["HVD210"]
        assert [e[0] for e in events] == ["HVD210"]
        assert events[0][2] == threading.current_thread().name


# -- the fleet under the port's witness ------------------------------------------

VOCAB = 61


def _tiny_fleet(metrics):
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.serve import (DynamicBatcher, InferenceEngine,
                                         Replica, ReplicaScheduler,
                                         TransformerAdapter)
    cfg = TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                            d_model=32, d_ff=64, max_len=64,
                            dtype=torch.float32)
    replicas = []
    for i in range(2):
        torch.manual_seed(i + 1)
        model = Transformer(cfg, device="cpu")
        ad = TransformerAdapter(cfg, model, block_tokens=8, device="cpu")
        rid = f"replica-{i}"
        eng = InferenceEngine(ad, batcher=DynamicBatcher(max_queue=64),
                              metrics=metrics, max_batch=4,
                              prefill_chunk=8, replica_id=rid)
        replicas.append(Replica(rid, None, eng))
    return ReplicaScheduler(replicas, metrics=metrics)


def test_serve_fleet_stress_zero_witness_findings(monkeypatch):
    """The port's counterpart of the JAX package's
    ``test_serve_fleet_stress_zero_witness_findings``: two TINY GPT-2
    replicas built after the witness is installed, then two seconds of
    chaos; every fleet lock holds one order (zero HVD210 / HVD211)."""
    from horovod_tpu_torch.serve import QueueFullError, Request, ServeMetrics

    torch.set_num_threads(2)
    monkeypatch.setenv("HVD_SANITIZE", "1")
    scheduler = None
    with witnesses(witness):
        try:
            metrics = ServeMetrics()
            scheduler = _tiny_fleet(metrics)
            assert isinstance(scheduler._lock, witness.SanitizedLock)
            scheduler.start()
            stop = threading.Event()
            errors, done = [], []

            def storm():
                i = 0
                while not stop.is_set():
                    i += 1
                    r = Request([1 + i % (VOCAB - 2), 2, 3],
                                max_new_tokens=2)
                    try:
                        scheduler.submit(r)
                    except QueueFullError:
                        time.sleep(0.002)
                        continue
                    except Exception as e:
                        errors.append(e)
                        return
                    done.append(r)
                    time.sleep(0.002)

            def expiry_storm():
                while not stop.is_set():
                    r = Request([1], max_new_tokens=2, timeout_s=0.004)
                    try:
                        scheduler.submit(r)
                    except Exception:
                        pass
                    time.sleep(0.002)

            def scrape():
                while not stop.is_set():
                    metrics.render()
                    metrics.snapshot()
                    scheduler.healthz()
                    time.sleep(0.002)

            def flapper():
                while not stop.is_set():
                    scheduler.mark_dead("replica-0", reason="stress flap")
                    time.sleep(0.05)
                    scheduler.mark_alive("replica-0", reason="stress flap")
                    time.sleep(0.05)

            threads = [threading.Thread(target=fn, daemon=True)
                       for fn in (storm, expiry_storm, scrape, flapper)]
            for t in threads:
                t.start()
            time.sleep(2.0)
            stop.set()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
            assert not errors, errors
            finished = [r for r in done if r._done.wait(30)]
            assert len(finished) > 10
            snap = metrics.snapshot()
            assert snap["requests"].get("expired", 0) > 0
            assert snap["replica_events"]["mark_dead"] >= 1
            assert snap["replica_events"]["mark_alive"] >= 1
            findings = witness.findings()
            assert not findings, "\n".join(f.format() for f in findings)
        finally:
            if scheduler is not None:
                scheduler.stop()
