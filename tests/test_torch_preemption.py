"""The port's preemption handling (``elastic/preemption.py``, the
serving fleet's ``watch_preemption``) against the JAX package's.

Over a mock metadata server and the port's KV server, the port's and the
JAX package's sentinels publish and clear the same ``preempt`` markers
step for step, and ``PreemptionAwareDiscovery`` filters the same hosts.
The port's elastic driver drains a preempt-marked host's worker (it
commits the step it was on and leaves without counting as a failure)
where a host lost without notice is terminated.  ``watch_preemption``
over a port scheduler of TINY GPT-2 replicas turns a marked host's
replica dead (its requests fail over and answer as a single engine
does) and back alive and warm when the marker clears, and survives a
failing KV scan.  ``kv.request`` faults hit the port's KV client as the
JAX package's tests pin them.  A worker's notification manager starts
the sentinel only when a maintenance endpoint is named.
"""

import json
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.elastic import preemption as jpre
from horovod_tpu.models import transformer as jt
from horovod_tpu_torch import elastic as E
from horovod_tpu_torch import faultline as fl
from horovod_tpu_torch.elastic.preemption import (PREEMPT_SCOPE,
                                                  PreemptionAwareDiscovery,
                                                  PreemptionSentinel)
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      params_from_jax)
from horovod_tpu_torch.runner.http_server import (KVStoreClient,
                                                  KVStoreServer,
                                                  RendezvousServer)

torch.set_num_threads(2)


class _FakeMetadataServer:
    """Mock of the GCP metadata maintenance-event endpoint."""

    def __init__(self):
        self.event = "NONE"
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                assert self.headers.get("Metadata-Flavor") == "Google"
                body = outer.event.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.httpd.server_address[1]}/"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def kv():
    servers = []

    def make():
        srv = KVStoreServer()
        port = srv.start(0)
        servers.append(srv)
        return srv, KVStoreClient("127.0.0.1", port)

    yield make
    for srv in servers:
        srv.stop()


# -- sentinels and discovery ---------------------------------------------------

def test_sentinels_write_and_clear_the_same_markers(kv):
    meta = _FakeMetadataServer()
    (psrv, pclient), (jsrv, jclient) = kv(), kv()
    try:
        sentinels = [
            (psrv, PreemptionSentinel(pclient, hostname="vm-3",
                                      url=meta.url, poll_interval_s=60)),
            (jsrv, jpre.PreemptionSentinel(jclient, hostname="vm-3",
                                           url=meta.url,
                                           poll_interval_s=60))]
        seen = []
        # A stale marker left by a previous incarnation: the startup
        # reconcile clears it at the first NONE.
        for srv, _ in sentinels:
            srv.put(PREEMPT_SCOPE, "vm-3", b"STALE")
        for event in ("NONE", "TERMINATE_ON_HOST_MAINTENANCE",
                      "TERMINATE_ON_HOST_MAINTENANCE", "NONE", "MIGRATE",
                      "NONE"):
            meta.event = event
            markers = []
            for srv, s in sentinels:
                s.step()
                markers.append(srv.scan_scope(PREEMPT_SCOPE))
            assert markers[0] == markers[1], event
            seen.append(markers[0])
        assert seen[0] == {} and seen[1] == {
            "vm-3": b"TERMINATE_ON_HOST_MAINTENANCE"}
        assert seen[3] == {} and seen[4] == {"vm-3": b"MIGRATE"}
    finally:
        meta.stop()


def test_sentinel_fault_point_and_unreachable_endpoint_match_jax(kv):
    """``preempt.poll`` kill-rank publishes a marker through the real
    state machine; an unreachable endpoint is quiet, unless the plan
    exercises the point (then it reads as NONE and clears)."""
    from horovod_tpu import faultline as jfl
    out = {}
    for name, mod, flmod in (("port", None, fl), ("jax", jpre, jfl)):
        srv, client = kv()
        cls = PreemptionSentinel if mod is None else mod.PreemptionSentinel
        s = cls(client, hostname="h", url="http://127.0.0.1:1/none",
                poll_interval_s=60)
        s.step()
        quiet = srv.scan_scope(PREEMPT_SCOPE)
        flmod.install(flmod.parse_plan("kill-rank:h@0*1/preempt.poll"))
        try:
            s.step()
            marked = srv.scan_scope(PREEMPT_SCOPE)
            s.step()
            cleared = srv.scan_scope(PREEMPT_SCOPE)
        finally:
            flmod.uninstall()
        out[name] = (quiet, marked, cleared)
    assert out["port"] == out["jax"] == (
        {}, {"h": b"FAULTLINE_PREEMPT"}, {})


def test_discovery_filters_the_same_hosts_as_jax():
    from horovod_tpu import elastic as JE
    marked = set()
    hosts = {"a": 2, "b": 2, "c": 1}
    p = PreemptionAwareDiscovery(E.FixedHostDiscovery(dict(hosts)),
                                 lambda: marked)
    j = jpre.PreemptionAwareDiscovery(JE.FixedHostDiscovery(dict(hosts)),
                                      lambda: marked)
    for step in (set(), {"b"}, {"a", "c", "zz"}, set()):
        marked.clear()
        marked.update(step)
        assert p.find_available_hosts_and_slots() == \
            j.find_available_hosts_and_slots()
    broken = PreemptionAwareDiscovery(
        E.FixedHostDiscovery(dict(hosts)),
        lambda: (_ for _ in ()).throw(OSError("kv down")))
    assert broken.find_available_hosts_and_slots() == hosts


class _LedgerWorkers:
    """Thread workers of a training loop with commits: a discovery bump
    (the HostsUpdatedInterrupt trigger) makes the worker commit and
    exit; ``terminate_event`` exits without committing."""

    def __init__(self, rdv):
        self.rdv = rdv
        self.commits, self.steps = {}, {}
        self.lock = threading.Lock()

    def fn(self, slot, terminate_event, version):
        host = slot.hostname
        raw = self.rdv.get("discovery", "update")
        baseline = json.loads(raw)["version"] if raw else 0
        step = 0
        while step < 500:
            step += 1
            with self.lock:
                self.steps[host] = step
            time.sleep(0.02)
            raw = self.rdv.get("discovery", "update")
            if raw is not None and json.loads(raw)["version"] > baseline:
                with self.lock:
                    self.commits[host] = step
                return 0
            if terminate_event.is_set():
                return 1
        return 0


def test_driver_drains_a_preempt_marked_host():
    """The marker takes hB out of the discoverable world while it is
    alive: the world reshapes without it, its worker commits the step
    it was on, and it is not blacklisted."""
    rdv = RendezvousServer()
    rdv.start()
    driver = E.ElasticDriver(rdv, E.FixedHostDiscovery({"hA": 1, "hB": 1}),
                             1, 2, cooldown_range=None, timeout=30)
    workers = _LedgerWorkers(rdv)
    try:
        driver.start(workers.fn)
        time.sleep(0.3)
        v1 = driver.world_version
        rdv.put(PREEMPT_SCOPE, "hB", b"TERMINATE_ON_HOST_MAINTENANCE")
        deadline = time.time() + 10
        while driver.world_version == v1 and time.time() < deadline:
            time.sleep(0.05)
        assert driver.world_version > v1, "no reshape after the notice"
        assert all(s.hostname != "hB" for s in driver.current_assignments())
        deadline = time.time() + 5
        while "hB" not in workers.commits and time.time() < deadline:
            time.sleep(0.05)
        assert workers.commits.get("hB") == workers.steps["hB"]
        assert not driver.host_manager.blacklist.is_blacklisted("hB")
    finally:
        driver.stop()
        rdv.stop()


def test_notification_manager_starts_the_sentinel_only_when_named(
        monkeypatch, kv):
    from horovod_tpu_torch import config as cfg
    from horovod_tpu_torch.elastic import WorkerNotificationManager
    meta = _FakeMetadataServer()
    srv, _ = kv()
    monkeypatch.setenv(cfg.HOROVOD_RENDEZVOUS_ADDR, "127.0.0.1")
    monkeypatch.setenv(cfg.HOROVOD_RENDEZVOUS_PORT, str(srv.port))
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    monkeypatch.setattr(E, "_elastic", lambda: True)
    monkeypatch.setenv("HOROVOD_HOSTNAME", "vm-9")
    monkeypatch.setenv("HVD_TPU_MAINTENANCE_POLL_S", "0.05")
    try:
        monkeypatch.delenv("HVD_TPU_MAINTENANCE_URL", raising=False)
        monkeypatch.delenv("HVD_TPU_PREEMPTION_SENTINEL", raising=False)
        quiet = WorkerNotificationManager()
        quiet.init()
        assert quiet._sentinel is None
        quiet._stop.set()
        monkeypatch.setenv("HVD_TPU_MAINTENANCE_URL", meta.url)
        meta.event = "TERMINATE_ON_HOST_MAINTENANCE"
        mgr = WorkerNotificationManager()
        mgr.init()
        try:
            assert mgr._sentinel is not None
            deadline = time.monotonic() + 10
            while not srv.scan_scope(PREEMPT_SCOPE) and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            assert srv.scan_scope(PREEMPT_SCOPE) == {
                "vm-9": b"TERMINATE_ON_HOST_MAINTENANCE"}
        finally:
            mgr._sentinel.stop()
            mgr._stop.set()
    finally:
        meta.stop()


# -- watch_preemption over a port fleet ---------------------------------------

BT = 8
VOCAB = 61
_JTINY = jt.TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, max_len=64, causal=True,
                              dtype=jnp.float32, scan_layers=False)
_TTINY = TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                           d_model=32, d_ff=64, max_len=64,
                           dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    tree = jt.Transformer(_JTINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(0)
    std = {"scale": 0.1, "bias": 0.1, "embedding": 0.5, "kernel": 0.2}
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(
            std[path[-1].key] * rng.randn(*x.shape)
            + (path[-1].key == "scale"), np.float32),
        jax.device_get(tree))
    m = Transformer(_TTINY, device="cpu")
    m.load_state_dict(params_from_jax(params))
    return m


def _fleet(model, n=2):
    from horovod_tpu_torch.serve import (InferenceEngine, Replica,
                                         ReplicaScheduler,
                                         TransformerAdapter)
    reps = [Replica(f"replica-{i}", types.SimpleNamespace(ranks=[i]),
                    InferenceEngine(TransformerAdapter(
                        _TTINY, model, block_tokens=BT, device="cpu"),
                        max_batch=2, prefill_chunk=5,
                        replica_id=f"replica-{i}", warmup=True))
            for i in range(n)]
    return ReplicaScheduler(reps), reps


def test_watch_preemption_fails_over_and_readmits(model, kv):
    from horovod_tpu_torch.serve import InferenceEngine, Request
    from horovod_tpu_torch.serve import TransformerAdapter
    srv, client = kv()
    sched, reps = _fleet(model)
    sched.start()
    sched.watch_preemption(client, {"h0": [0], "h1": [1]}, poll_s=0.02)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, VOCAB, (int(rng.randint(4, 14)),)).tolist()
               for _ in range(12)]
    try:
        reqs = [Request(p, max_new_tokens=8) for p in prompts]
        for r in reqs:
            sched.submit(r)
        srv.put(PREEMPT_SCOPE, "h1", b"TERMINATE_ON_HOST_MAINTENANCE")
        deadline = time.monotonic() + 10
        while reps[1].state != "dead" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert reps[1].state == "dead"
        outs = [r.result(timeout=60) for r in reqs]
        warm = reps[1].engine.warmup_runs
        client.delete(PREEMPT_SCOPE, "h1")
        # mark_alive flips the state, then restarts the engine, which
        # warms up before its loop runs.
        deadline = time.monotonic() + 10
        while reps[1].engine.warmup_runs == warm and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert reps[1].state == "healthy"
        assert reps[1].engine.warmup_runs == warm + 1
        assert sched.healthz()["status"] == "ok"
        r = Request(prompts[0], max_new_tokens=8)
        assert sched.submit(r).replica_id in ("replica-0", "replica-1")
        assert r.result(timeout=60) == outs[0]
    finally:
        sched.stop()
    ref = InferenceEngine(TransformerAdapter(_TTINY, model, block_tokens=BT,
                                             device="cpu"),
                          max_batch=2, prefill_chunk=5, replica_id="ref")
    ref.start()
    try:
        assert outs == [ref.generate(p, max_new_tokens=8) for p in prompts]
    finally:
        ref.stop()
    events = sched.metrics.snapshot()["replica_events"]
    assert events["mark_dead"] == 1 and events["mark_alive"] == 1


def test_watch_preemption_survives_a_failing_scan(model):
    sched, reps = _fleet(model)
    calls = {"n": 0}

    class _FlakyKV:
        def scan(self, scope):
            calls["n"] += 1
            assert scope == PREEMPT_SCOPE
            if calls["n"] <= 2:
                raise ConnectionError("KV down")
            return {"h0": b"x"} if calls["n"] <= 4 else {}

    sched.watch_preemption(_FlakyKV(), {"h0": [0]}, poll_s=0.005)
    try:
        deadline = time.monotonic() + 10
        while calls["n"] < 6 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        sched.stop()
    assert calls["n"] >= 6, "the watcher died"
    snap = sched.metrics.snapshot()
    assert snap["preempt_poll_errors"] == 2
    assert snap["replica_events"] == {"mark_dead": 1, "mark_alive": 1}
    assert "hvd_serve_preempt_poll_errors_total 2" in sched.metrics.render()


def test_rank_reports_route_fault_and_add_replica(model):
    """``report_rank_lost`` / ``report_rank_recovered`` map slot ranks to
    replicas; a ``kill-rank`` at ``replica.route`` kills at routing time;
    ``add_replica`` registers a new replica's metrics and starts it."""
    from horovod_tpu_torch.serve import (InferenceEngine, Replica, Request,
                                         TransformerAdapter)
    sched, reps = _fleet(model, n=2)
    sched.start()
    try:
        assert sched.report_rank_lost(7) is None
        assert sched.report_rank_lost(1) == "replica-1"
        assert sched.report_rank_recovered(1) == "replica-1"
        assert sched.report_rank_recovered(1) is None
        fl.install(fl.parse_plan("kill-rank:0@0*1/replica.route"))
        try:
            r = Request([1, 2, 3], max_new_tokens=2)
            assert sched.submit(r).replica_id == "replica-1"
            r.result(timeout=60)
        finally:
            fl.uninstall()
        assert reps[0].state == "dead"
        new = Replica("replica-2", types.SimpleNamespace(ranks=[2]),
                      InferenceEngine(TransformerAdapter(
                          _TTINY, model, block_tokens=BT, device="cpu"),
                          max_batch=2, replica_id="replica-2"))
        sched.add_replica(new)
        with pytest.raises(ValueError, match="already registered"):
            sched.add_replica(new)
        assert new.engine._thread is not None
        assert "replica-2" in sched.metrics.snapshot()["queue_depth"]
        assert sched.healthz()["total"] == 3
    finally:
        sched.stop()


@pytest.mark.parametrize("spec,want_retries", [
    ("drop-kv-response@0*2", 2), ("delay-kv@0*1~0.05", 0)])
def test_kv_request_faults_hit_the_client(kv, spec, want_retries):
    """``kv.request`` is consulted once per attempt: a drop train of n
    costs n retries and the write still lands; delay-kv stalls."""
    srv, client = kv()
    target = f"127.0.0.1:{srv.port}"
    kind, rest = spec.split("@")
    plan = fl.install(fl.parse_plan(f"{kind}:{target}@{rest}/kv.request",
                                    seed=0))
    retries = []
    real = client._retry_backoff_s
    client._retry_backoff_s = lambda a: retries.append(a) or real(a)
    try:
        t0 = time.monotonic()
        client.put("scope", "k", b"v")
        dt = time.monotonic() - t0
    finally:
        fl.uninstall()
    assert srv.get("scope", "k") == b"v"
    assert len(retries) == want_retries
    assert [e["kind"] for e in plan.log] == [kind] * max(want_retries, 1)
    if kind == "delay-kv":
        assert dt >= 0.05
