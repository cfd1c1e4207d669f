"""The port's coordinator negotiation (``ops/negotiation.py``) against the
JAX package's, and its timeline against JAX's.

Two port ``Negotiator``s in threads over one in-process c10d store stand
beside two JAX ``Negotiator``s over the JAX package's ``KVStoreServer``
(as ``tests/test_negotiation_unit.py`` sets them up), on the same
signature sequences: matched signatures pass, shape / op / ps_id
mismatches are rejected on both ranks with the same verdict, a shape
change renegotiates with a cross-rank invalidation, and a cache hit
publishes a record of the replayable dispatch stream.  The port's
``Timeline`` copy writes what JAX's writes for the same calls, ``ts``
aside; ``start_timeline`` / ``stop_timeline`` and the ``HOROVOD_TIMELINE``
autostart are checked after ``tests/test_review_regressions.py:31``,
``:46``, in a world of one on the CPU.
"""

import dataclasses
import json
import threading
import time

import pytest
import torch
import torch.distributed as dist

from horovod_tpu_torch import config as tconfig
from horovod_tpu_torch.exceptions import CollectiveRejectedError
from horovod_tpu_torch.ops import negotiation as tneg


@pytest.fixture()
def kv_env(monkeypatch):
    from horovod_tpu.runner.http_server import KVStoreServer
    srv = KVStoreServer()
    port = srv.start()
    monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_PORT", str(port))
    monkeypatch.setenv("HOROVOD_GLOO_TIMEOUT_SECONDS", "20")
    yield srv
    while _JAX_NEGOTIATORS:  # their flushers stop before the server
        _JAX_NEGOTIATORS.pop().close()
    srv.stop()


_JAX_NEGOTIATORS = []


def _jax_pair():
    from horovod_tpu.config import Config
    from horovod_tpu.ops.negotiation import Negotiator
    cfg = Config.from_env()
    pair = Negotiator(0, 2, cfg), Negotiator(1, 2, cfg)
    _JAX_NEGOTIATORS.extend(pair)
    return pair


def _port_pair(store=None):
    cfg = dataclasses.replace(tconfig.Config.from_env(),
                              gloo_timeout_seconds=20.0)
    store = store or dist.HashStore()
    return (tneg.Negotiator(0, 2, cfg, store),
            tneg.Negotiator(1, 2, cfg, store), store)


def _both(n0, n1, sig0, sig1):
    """Negotiate on both ranks at once; each rank's exception or None."""
    errs = [None, None]

    def go(i, n, sig):
        try:
            n.negotiate(*sig)
        except Exception as e:  # noqa: BLE001 - the verdict is the result
            errs[i] = e

    ts = [threading.Thread(target=go, args=(i, n, s))
          for i, (n, s) in enumerate(((n0, sig0), (n1, sig1)))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    return errs


SEQUENCES = {
    "matched": [(("t", "allreduce", "float32", (4,), 1),) * 2],
    "shape": [(("u", "allreduce", "float32", (4,), 1),
               ("u", "allreduce", "float32", (5,), 1))],
    "dtype": [(("d", "allreduce", "float32", (4,), 1),
               ("d", "allreduce", "float16", (4,), 1))],
    "op": [(("v", "allreduce", "float32", (4,), 1),
            ("v", "allreduce", "float32", (4,), 0))],
    "ps_id": [(("x", "allreduce", "float32", (4,), 1, 1.0, 1.0, 1),
               ("x", "allreduce", "float32", (4,), 1, 1.0, 1.0, 2))],
    "ragged": [(("g", "allgather", "float32", (2, -1, 7), 0),
                ("g", "allgather", "float32", (2, -1, 8), 0))],
    "renegotiate": [(("w", "allreduce", "float32", (4,), 1),) * 2,
                    (("w", "allreduce", "float32", (8,), 1),) * 2,
                    (("w", "allreduce", "float32", (4,), 1),) * 2],
}


def _verdicts(n0, n1, seq):
    out = []
    for sig0, sig1 in seq:
        errs = _both(n0, n1, sig0, sig1)
        out.append([None if e is None else (type(e).__name__, str(e))
                    for e in errs])
    return out


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_verdicts_match_jax_on_both_ranks(kv_env, case):
    n0, n1, _ = _port_pair()
    got = _verdicts(n0, n1, SEQUENCES[case])
    want = _verdicts(*_jax_pair(), SEQUENCES[case])
    assert got == want
    for errs in got:
        if case in ("matched", "renegotiate"):
            assert errs == [None, None]
        else:  # rejected on both ranks, with one verdict
            assert errs[0] is not None and errs[0] == errs[1]
            assert errs[0][0] == "CollectiveRejectedError"
            assert "Mismatched" in errs[0][1]


def test_cache_hit_publishes_a_dispatch_record_as_jax(kv_env):
    port = _port_pair()
    jax = _jax_pair()
    sig = ("h", "allreduce", "float32", (4,), 1)
    for n0, n1 in (port[:2], jax):
        assert _both(n0, n1, sig, sig) == [None, None]
        before = (n0.negotiated, n0.cached) if n0 in port else None
        n0.negotiate(*sig)  # a HIT: no round-trip, one more record
        assert n0.dispatch_seq == 2
        n0.flush_dispatches()
        if before is not None:
            assert (n0.negotiated, n0.cached) == (before[0], before[1] + 1)
    store = port[2]
    got = [json.loads(store.get(f"hvd/disp/0/0/{s}")) for s in (1, 2)]
    want = [json.loads(kv_env.get("disp@0", f"0/{s}")) for s in (1, 2)]
    assert got == want
    assert [r["epoch"] for r in got] == [0, 1] and got[1]["seq"] == 2
    for n in port[:2]:
        n.close()


def test_shape_change_invalidates_the_other_ranks_cache():
    n0, n1, store = _port_pair()
    a = ("w", "allreduce", "float32", (4,), 1)
    b = ("w", "allreduce", "float32", (8,), 1)
    assert _both(n0, n1, a, a) == [None, None]
    # Rank 1 moves to a new shape and renegotiates; rank 0 still holds the
    # old verdict until it absorbs rank 1's invalidation.
    t = threading.Thread(target=lambda: pytest.raises(
        CollectiveRejectedError, n1.negotiate, *b))
    t.start()
    for _ in range(2000):  # until rank 1's invalidation is in the store
        if store.add("hvd/inval/0/ver", 0):
            break
        time.sleep(0.005)
    n0._inval_check_ts = 0.0
    with pytest.raises(CollectiveRejectedError, match="Mismatched shapes"):
        n0.negotiate(*a)  # absorbed: a MISS, renegotiated, rejected
    t.join(30)
    assert store.add("hvd/inval/0/ver", 0) == 1


def test_late_invalidation_keeps_a_newer_verdict(kv_env):
    """Both ranks change shape and renegotiate; each absorbs the other's
    invalidation only afterwards.  The port keeps the verdict it
    negotiated past that epoch, so both ranks hit the cache next.  The
    JAX package drops it: in a run, a rank would then renegotiate alone
    while its peers dispatched from the cache (ROADMAP Queue C)."""
    a = ("w", "allreduce", "float32", (4,), 1)
    b = ("w", "allreduce", "float32", (8,), 1)
    for pair, want in ((_port_pair()[:2], "HIT"), (_jax_pair(), "MISS")):
        for sig in (a, b):
            for n in pair:
                n._inval_check_ts = 1e18  # absorb nothing yet
            assert _both(*pair, sig, sig) == [None, None]
        for n in pair:
            n._inval_check_ts = 0.0
            n._absorb_remote_invalidations()
            status = n.cache.lookup("w", "float32", (8,), 1)
            assert status == (n._HIT if want == "HIT" else 0), want


def test_invalidation_from_a_rank_ahead_waits_for_its_dispatch():
    """Rank 1 runs ahead: its second dispatch of ``a`` hits the cache, its
    third, at a new shape, renegotiates and invalidates.  Rank 0, one
    dispatch behind, absorbs that invalidation before its own second
    dispatch of ``a``, which must still hit the cache (the peer already
    made it), and renegotiates at the third, with rank 1."""
    n0, n1, _ = _port_pair()
    a = ("a", "allreduce", "float32", (4,), 1)
    b = ("a", "allreduce", "float32", (8,), 1)
    assert _both(n0, n1, a, a) == [None, None]
    n1.negotiate(*a)  # a HIT: no round-trip
    errs = []
    t = threading.Thread(target=lambda: errs.append(
        n1.negotiate(*b)))  # INVALID: renegotiates, waits for rank 0
    t.start()
    for _ in range(2000):
        if n0.store.add("hvd/inval/0/ver", 0):
            break
        time.sleep(0.005)
    n0._inval_check_ts = 0.0
    cached = n0.cached
    n0.negotiate(*a)  # absorbs rank 1's invalidation, still a HIT
    assert n0.cached == cached + 1
    n0.negotiate(*b)  # the dispatch rank 1 renegotiates
    t.join(30)
    assert errs == [None] and n0.negotiated == n1.negotiated == 2


def test_port_timeline_writes_what_jax_writes(tmp_path):
    from horovod_tpu.timeline import Timeline as JTimeline
    from horovod_tpu_torch.timeline import Timeline as TTimeline

    def events(cls, path):
        tl = cls(str(path), mark_cycles=True, rank=0)
        tl.mark_cycle()
        tl.negotiate_start("g", "ALLREDUCE")
        tl.negotiate_rank_ready("g", 1)
        tl.negotiate_end("g", "ALLREDUCE")
        tl.start("g", "ALLREDUCE")
        with tl.activity("g", "QUEUE"):
            pass
        tl.end("g", "ALLREDUCE")
        tl.serve_counter("engine", {"tokens": 3, "occ": 0.5})
        tl.close()
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in json.load(open(path))]

    got = events(TTimeline, tmp_path / "port.json")
    assert got == events(JTimeline, tmp_path / "jax.json")
    assert got[-1]["args"] == {"dropped": 0}


def _world_of_one():
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    hvd.init(device="cpu")
    return hvd


def test_start_stop_timeline_events_match_jax_at_world_size_one(
        tmp_path, monkeypatch):
    hvd = _world_of_one()
    path = tmp_path / "timeline.json"
    try:
        hvd.start_timeline(str(path), mark_cycles=True)
        hvd.allreduce(torch.ones(4), name="allreduce.grad0")
        hvd.allreduce(torch.ones(4))
        hvd.stop_timeline()
    finally:
        hvd.shutdown()
    got = [(e["name"], e["ph"], e.get("tid")) for e in json.load(open(path))]
    import horovod_tpu as jhvd
    jhvd.shutdown()
    monkeypatch.setenv("HVD_TPU_EMULATE_RANKS", "1")
    jhvd.init()
    try:
        import jax.numpy as jnp
        jpath = tmp_path / "jax.json"
        jhvd.start_timeline(str(jpath), mark_cycles=True)
        jhvd.allreduce(jnp.ones(4), name="allreduce.grad0")
        jhvd.allreduce(jnp.ones(4))
        jhvd.stop_timeline()
    finally:
        jhvd.shutdown()
    want = [(e["name"], e["ph"], e.get("tid"))
            for e in json.load(open(jpath))]
    assert got == want
    names = {n for n, _, _ in got}
    assert {"NEGOTIATE_ALLREDUCE", "ALLREDUCE", "CYCLE"} <= names
    assert ("ALLREDUCE", "B", "allreduce.noname.float32x4") in got


def test_timeline_env_knob_autostarts(tmp_path, monkeypatch):
    path = tmp_path / "auto_timeline.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    hvd = _world_of_one()
    try:
        hvd.allreduce(torch.ones(2), name="t")
        assert hvd.join() == 0
    finally:
        hvd.shutdown()
    events = json.load(open(path))
    assert any(e["name"] == "ALLREDUCE" for e in events)
    assert events[-1]["name"] == "hvd_timeline_dropped_events_total"


def test_duplicate_name_and_dispatch_count_in_a_world_of_one():
    from horovod_tpu_torch.exceptions import DuplicateNameError
    hvd = _world_of_one()
    try:
        eng = hvd.core._state.engine
        n = eng.dispatches
        eng.claim_name("dup")
        with pytest.raises(DuplicateNameError):
            hvd.allreduce(torch.ones(2), name="dup")
        eng.release_name("dup")
        hvd.allreduce(torch.ones(2), name="dup")  # released: fine again
        hvd.barrier()  # a world of one: no dispatch, as in JAX
        assert eng.dispatches == n + 2
        x = torch.arange(6.0)
        assert torch.equal(hvd.hierarchical_allreduce(x, local_size=1),
                           hvd.allreduce(x, op=hvd.Sum))
    finally:
        hvd.shutdown()
