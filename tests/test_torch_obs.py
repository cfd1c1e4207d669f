"""The port's request tracing (``obs/``) against the JAX package's.

On the same shard files the port's ``build_tree``, ``critical_path``,
``merge_chrome``, ``summarize`` and the ``python -m
horovod_tpu_torch.obs`` CLI give the JAX package's output.  A
``/generate`` carrying ``X-Trace-Id`` through the port's server and
through the JAX server (same TINY GPT-2 weights, same request) leaves
span trees of the same shape (names, components, parent links; times and
span ids left out), and ``/trace`` serves them.  Untraced requests echo
a well-formed inbound id, a malformed id is dropped, the front end's
sampling decision is never rolled again, and the stage partition sums
to the end-to-end latency.  A fault fired inside a traced scope records
the trace id; the KV client sends trace headers only under a scope.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.obs import cli as jcli
from horovod_tpu.obs import merge as jmg
from horovod_tpu.obs import tracing as jtr
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      params_from_jax)
from horovod_tpu_torch.obs import cli as pcli
from horovod_tpu_torch.obs import merge as mg
from horovod_tpu_torch.obs import tracing as tr

torch.set_num_threads(2)

BT = 8
VOCAB = 61
_JTINY = jt.TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, max_len=64, causal=True,
                              dtype=jnp.float32, scan_layers=False)
_TTINY = TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                           d_model=32, d_ff=64, max_len=64,
                           dtype=torch.float32)


@pytest.fixture(autouse=True)
def _clean_tracers():
    for mod in (tr, jtr):
        mod.uninstall()
        mod._env_checked = False
    yield
    for mod in (tr, jtr):
        mod.uninstall()
        mod._env_checked = False


# -- merge and CLI on the same shards ------------------------------------------

def _write_shard(path, label, wall_ns, mono_ns, events):
    with open(path, "w") as fh:
        fh.write(json.dumps({"type": "anchor", "label": label, "pid": 1234,
                             "rank": 0, "wall_ns": wall_ns,
                             "mono_ns": mono_ns}) + "\n")
        for ev in events:
            fh.write(json.dumps(ev) + "\n")


def _span(tid, span, parent, name, proc, t0, t1, **args):
    return {"type": "span", "trace": tid, "span": span, "parent": parent,
            "name": name, "proc": proc, "t0_ns": t0, "t1_ns": t1,
            "args": args}


def _shards_skewed(d):
    """Two processes whose monotonic epochs differ by 5 s, a failover
    resubmission, a kv retry, prefill chunks, flows and instants, and a
    second trace rooted at a scheduler-sampled ``request``."""
    a, b = "ab" * 8, "cd" * 8
    _write_shard(d / "trace-h-1-server.jsonl", "server", 1_000_000_000, 0, [
        _span(a, "aaaaaaaa", "99999999", "http-handle", "server",
              100_000_000, 400_000_000, status=200),
        _span(a, "a1a1a1a1", "aaaaaaaa", "route", "server", 101_000_000,
              102_000_000, replica="replica-0"),
        _span(a, "a2a2a2a2", "aaaaaaaa", "kv-retry", "kv-client",
              103_000_000, 104_000_000, attempt=1)])
    _write_shard(d / "trace-h-2-replica-0.jsonl", "replica-0",
                 1_000_000_000, 5_000_000_000, [
                     _span(a, "bbbbbbbb", "aaaaaaaa", "queue-wait",
                           "replica-0", 5_095_000_000, 5_140_000_000),
                     _span(a, "b1b1b1b1", "aaaaaaaa", "prefill-chunk",
                           "replica-0", 5_141_000_000, 5_150_000_000,
                           tokens=5),
                     {"type": "instant", "trace": a, "parent": "aaaaaaaa",
                      "name": "resubmit", "proc": "replica-0",
                      "t_ns": 5_160_000_000, "args": {"from": "replica-0"}},
                     {"type": "flow", "trace": a, "name": "token-stream",
                      "proc": "replica-0", "phase": "s",
                      "t_ns": 5_151_000_000},
                     _span(b, "dddddddd", None, "request", "replica-0",
                           5_200_000_000, 5_300_000_000),
                     _span(b, "d1d1d1d1", "dddddddd", "decode", "replica-0",
                           5_210_000_000, 5_290_000_000, tokens=3)])
    _write_shard(d / "trace-h-3-replica-1.jsonl", "replica-1",
                 1_000_000_000, 2_000_000_000, [
                     _span(a, "cccccccc", "aaaaaaaa", "resubmission",
                           "replica-1", 2_160_000_000, 2_170_000_000),
                     _span(a, "c1c1c1c1", "aaaaaaaa", "decode", "replica-1",
                           2_171_000_000, 2_390_000_000, tokens=4),
                     {"type": "flow", "trace": a, "name": "token-stream",
                      "proc": "replica-1", "phase": "f",
                      "t_ns": 2_390_000_000}])


def _shards_clamped(d):
    tid = "ef" * 8
    _write_shard(d / "trace-h-1-server.jsonl", "server", 0, 0, [
        _span(tid, "aaaaaaaa", None, "http-handle", "server", 100_000_000,
              200_000_000)])
    _write_shard(d / "trace-h-1-replica-0.jsonl", "replica-0", 0, 0, [
        _span(tid, "bbbbbbbb", "aaaaaaaa", "queue-wait", "replica-0",
              97_000_000, 110_000_000)])
    # A torn tail (a killed writer) and a shard with no anchor.
    with open(d / "trace-h-1-replica-0.jsonl", "a") as fh:
        fh.write('{"type": "span", "trace"')
    with open(d / "trace-h-9-orphan.jsonl", "w") as fh:
        fh.write(json.dumps(_span(tid, "eeeeeeee", "bbbbbbbb", "decode",
                                  "replica-0", 150_000_000,
                                  190_000_000)) + "\n")


def _merge_outputs(mod, d):
    shards = mod.load_shards(str(d))
    traces = mod.spans_by_trace(shards)
    events, meta = mod.merge_chrome(shards)
    for m in meta["shards"]:
        m.pop("path")
    return {
        "labels": [s.label for s in shards],
        "trees": {t: mod.build_tree([e for e in evs if e["type"] == "span"])
                  for t, evs in traces.items()},
        "critical": {t: mod.critical_path(evs) for t, evs in traces.items()},
        "summary": mod.summarize(shards),
        "chrome": events, "meta": meta,
    }


@pytest.mark.parametrize("make", [_shards_skewed, _shards_clamped],
                         ids=["skewed", "clamped"])
def test_merge_matches_jax_on_the_same_shards(tmp_path, make):
    make(tmp_path)
    got = _merge_outputs(mg, tmp_path)
    assert got == _merge_outputs(jmg, tmp_path)
    assert got["chrome"] and all(
        a["ts"] <= b["ts"] for a, b in zip(
            [e for e in got["chrome"] if "ts" in e][:-1],
            [e for e in got["chrome"] if "ts" in e][1:]))


def test_cli_matches_jax(tmp_path, capsys):
    from horovod_tpu_torch.timeline import Timeline
    _shards_skewed(tmp_path)
    tl = tmp_path / "rank0_timeline.json"
    t = Timeline(str(tl), rank=0)
    t.elastic_event("reset", 3, "refresh-world")
    t.brownout_event("up", 1, rung="brownout_up")
    t.close()
    outs = {}
    for name, cli in (("port", pcli), ("jax", jcli)):
        res = []
        for argv in ([], ["--json"],
                     ["-o", str(tmp_path / f"{name}.json"), "--timeline",
                      str(tl)],
                     ["--timeline", str(tmp_path / "nope.json")]):
            rc = cli.run_commandline(["--dir", str(tmp_path)] + argv)
            out, err = capsys.readouterr()
            res.append((rc, out.replace(f"{name}.json", "X"), err))
        assert cli.run_commandline(["--dir", str(tmp_path / "nope")]) == 1
        capsys.readouterr()
        with open(tmp_path / f"{name}.json") as fh:
            res.append(json.load(fh))
        outs[name] = res
    assert outs["port"] == outs["jax"]
    assert [r[0] for r in outs["port"][:4]] == [0, 0, 0, 1]


def test_python_dash_m_obs(tmp_path):
    import subprocess
    import sys
    _shards_clamped(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.obs", "--dir",
         str(tmp_path), "--json"], cwd=repo, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=repo), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ef" * 8 in json.loads(out.stdout)["traces"]


def test_tracer_records_match_jax_tracer():
    """The same emissions through both tracers: the recent buffer's
    trees equal once ids and times are left out, flows and instants
    included in the event counts; the buffer stays bounded."""
    def drive(mod):
        t = mod.Tracer(sample=1.0, recent=3)
        ctx = t.new_context(trace_id="12" * 8, parent="ffffffff")
        t.emit_span(ctx, "http-handle", 1.0, 2.0, "server", root=True,
                    args={"status": 200})
        t.emit_span(ctx, "queue-wait", 1.1, 1.2, "replica-0")
        t.instant(ctx, "admission", "replica-0", t=1.2)
        t.flow(ctx, "token-stream", "replica-0")
        t.flow(ctx, "token-stream", "replica-0", end=True)
        for _ in range(4):
            other = t.new_context()
            t.emit_span(other, "request", 0.0, 0.001, "server", root=True)
        return [(x["complete"], x["events"], _shape(x["tree"]))
                for x in t.recent_traces(limit=10)]
    got = drive(tr)
    assert got == drive(jtr)
    assert len(got) == 3


def test_env_bootstrap_matches_jax(monkeypatch, tmp_path):
    for val in ("0", "not-a-float", "0.25"):
        for mod in (tr, jtr):
            mod.uninstall()
            mod._env_checked = False
        monkeypatch.setenv("HVD_TRACE_SAMPLE", val)
        monkeypatch.setenv("HVD_TRACE_DIR", str(tmp_path))
        got, want = tr.maybe_install_from_env(), jtr.maybe_install_from_env()
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.sample, got.shard_dir) == (want.sample,
                                                   want.shard_dir)
            assert tr.maybe_install_from_env() is got


def test_shards_and_timeline_sinks(tmp_path):
    """A tracer with a shard directory writes per-component JSONL shards
    (anchor first) from its own thread, and an installed tracer renders
    spans, flows and instants into the port's timeline."""
    from horovod_tpu_torch import core
    from horovod_tpu_torch.timeline import Timeline
    tl_path = tmp_path / "tl.json"
    tl = Timeline(str(tl_path))
    core._state.timeline = tl
    try:
        t = tr.install(tr.Tracer(sample=1.0, shard_dir=str(tmp_path / "s")))
        assert t._timeline is tl
        ctx = t.new_context()
        t.emit_span(ctx, "decode", time.monotonic(), time.monotonic(),
                    "replica-0")
        t.flow(ctx, "token-stream", "replica-0")
        t.instant(ctx, "resubmit", "replica-0")
        tr.uninstall()
    finally:
        core._state.timeline = None
        tl.close()
    shards = mg.load_shards(str(tmp_path / "s"))
    assert len(shards) == 1 and shards[0].anchor["label"] == "replica-0"
    assert [e["type"] for e in shards[0].events] == ["span", "flow",
                                                     "instant"]
    events = json.load(open(tl_path))
    assert {e.get("cat") for e in events} >= {"hvdtrace", "hvdtrace-flow"}
    assert any(e["name"] == "hvdtrace/resubmit" for e in events)


# -- traced requests through both servers --------------------------------------

def _flax_params(seed=0):
    tree = jt.Transformer(_JTINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(seed)
    std = {"scale": 0.1, "bias": 0.1, "embedding": 0.5, "kernel": 0.2}
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(
            std[path[-1].key] * rng.randn(*x.shape)
            + (path[-1].key == "scale"), np.float32),
        jax.device_get(tree))


@pytest.fixture(scope="module")
def weights():
    params = _flax_params()
    model = Transformer(_TTINY, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return params, model


def _port_server(model, replicas=1, max_batch=4):
    from horovod_tpu_torch.serve import (ServeServer, TransformerAdapter,
                                         build_replicas)
    sched = build_replicas(
        lambda: TransformerAdapter(_TTINY, model, block_tokens=BT,
                                   device="cpu"),
        num_replicas=replicas, max_batch=max_batch, prefill_chunk=5)
    srv = ServeServer(sched)
    return srv, srv.start(port=0, host="127.0.0.1")


def _jax_server(params):
    from horovod_tpu.serve import InferenceEngine as JaxEngine
    from horovod_tpu.serve import Replica, ReplicaScheduler, ServeServer
    from horovod_tpu.serve import TransformerAdapter as JaxAdapter
    eng = JaxEngine(JaxAdapter(_JTINY, params, block_tokens=BT,
                               attn_impl="gather"),
                    kv_mode="paged", max_batch=4, prefill_chunk=5,
                    replica_id="replica-0")
    srv = ServeServer(ReplicaScheduler([Replica("replica-0", None, eng)]))
    return srv, srv.start(port=0, host="127.0.0.1")


def _post(port, body, headers=()):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers=dict({"Content-Type": "application/json"}, **dict(headers)))
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), e.headers


def _get_trace(port, tid, want=("http-handle", "decode")):
    """The trace's tree from ``/trace``, once the engine's deferred
    emissions (decode, after the response) have landed."""
    deadline = time.monotonic() + 30
    while True:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/trace",
                                    timeout=30) as resp:
            payload = json.loads(resp.read())
        trees = [t for t in payload["traces"] if t["trace_id"] == tid]
        names = set()

        def walk(n):
            names.add(n["name"])
            for c in n["children"]:
                walk(c)
        for t in trees:
            for n in t["tree"]:
                walk(n)
        if set(want) <= names or time.monotonic() > deadline:
            return payload, trees[0]["tree"] if trees else []
        time.sleep(0.05)


def _shape(tree):
    """Names, components and parent links of a span forest, sorted:
    times and ids left out."""
    return sorted((n["name"], n["proc"], _shape(n["children"]))
                  for n in tree)


def test_traced_generate_trees_match_jax_server(weights):
    params, model = weights
    tr.install(tr.Tracer(sample=1.0))
    jtr.install(jtr.Tracer(sample=1.0))
    psrv, pport = _port_server(model)
    jsrv, jport = _jax_server(params)
    try:
        prompt = np.random.RandomState(4).randint(0, VOCAB, (13,)).tolist()
        shapes = {}
        for name, port in (("port", pport), ("jax", jport)):
            tid = f"{name}0{'cafe' * 3}"[:16]
            status, out, hdrs = _post(port, {"tokens": prompt,
                                             "max_new_tokens": 4},
                                      [("X-Trace-Id", tid),
                                       ("X-Parent-Span", "12345678")])
            assert status == 200 and hdrs.get("X-Trace-Id") == tid
            assert hdrs.get("X-Span-Id")
            payload, tree = _get_trace(port, tid)
            assert payload["enabled"] and payload["sample"] == 1.0
            (root,) = tree
            assert root["name"] == "http-handle"
            assert root["parent"] == "12345678"
            assert all(c["parent"] == root["span"]
                       for c in root["children"])
            shapes[name] = (_shape(tree), out["tokens"])
        assert shapes["port"] == shapes["jax"]
        names = {n for n, _, _ in shapes["port"][0][0][2]}
        assert {"route", "queue-wait", "prefill-chunk", "decode"} <= names
    finally:
        psrv.stop()
        jsrv.stop()


def test_scheduler_sampled_request_trees_match_jax(weights):
    """Without an HTTP front end the scheduler samples and the engine
    emits the ``request`` root, in both packages."""
    from horovod_tpu.serve import InferenceEngine as JaxEngine
    from horovod_tpu.serve import Replica as JaxReplica
    from horovod_tpu.serve import ReplicaScheduler as JaxScheduler
    from horovod_tpu.serve import Request as JaxRequest
    from horovod_tpu.serve import TransformerAdapter as JaxAdapter
    from horovod_tpu_torch.serve import (InferenceEngine, Replica,
                                         ReplicaScheduler, Request,
                                         TransformerAdapter)
    params, model = weights
    pt, jt_ = (tr.install(tr.Tracer(sample=1.0)),
               jtr.install(jtr.Tracer(sample=1.0)))
    psched = ReplicaScheduler([Replica("replica-0", None, InferenceEngine(
        TransformerAdapter(_TTINY, model, block_tokens=BT, device="cpu"),
        max_batch=4, prefill_chunk=5, replica_id="replica-0"))]).start()
    jsched = JaxScheduler([JaxReplica("replica-0", None, JaxEngine(
        JaxAdapter(_JTINY, params, block_tokens=BT, attn_impl="gather"),
        kv_mode="paged", max_batch=4, prefill_chunk=5,
        replica_id="replica-0"))]).start()
    try:
        shapes = []
        for sched, Req, tracer in ((psched, Request, pt),
                                   (jsched, JaxRequest, jt_)):
            r = Req([1, 2, 3, 4, 5, 6, 7], max_new_tokens=3)
            sched.submit(r)
            r.result(timeout=60)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                recent = [x for x in tracer.recent_traces()
                          if x["trace_id"] == r.trace.trace_id]
                if recent and recent[0]["complete"]:
                    break
                time.sleep(0.02)
            shapes.append(_shape(recent[0]["tree"]))
        assert shapes[0] == shapes[1]
        assert shapes[0][0][0] == "request"
    finally:
        psched.stop()
        jsched.stop()


def test_untraced_echo_and_malformed_ids(weights):
    from horovod_tpu.serve.server import _ServeHandler as JaxHandler
    from horovod_tpu_torch.serve.server import _ServeHandler
    for value in (None, "", "feedface-01.x_Y", "evil\r\nX-Injected: 1",
                  "id with spaces", "ünïcode", "x" * 128, "x" * 129):
        assert _ServeHandler._safe_id(value) == JaxHandler._safe_id(value)
    _, model = weights
    assert tr.TRACER is None
    srv, port = _port_server(model)
    try:
        status, _, hdrs = _post(port, {"tokens": [5], "max_new_tokens": 2},
                                [("X-Trace-Id", "cafecafecafecafe")])
        assert status == 200 and hdrs.get("X-Trace-Id") == \
            "cafecafecafecafe" and hdrs.get("X-Span-Id") is None
        status, _, hdrs = _post(port, {"tokens": [3], "max_new_tokens": 2})
        assert status == 200 and hdrs.get("X-Trace-Id") is None
        status, _, hdrs = _post(port, {"tokens": [2], "max_new_tokens": 2},
                                [("X-Trace-Id", "bad id with spaces")])
        assert status == 200 and hdrs.get("X-Trace-Id") is None
        # A 400 echoes too.
        status, _, hdrs = _post(port, {"tokens": []},
                                [("X-Trace-Id", "cafecafecafecafe")])
        assert status == 400 and hdrs.get("X-Trace-Id") == \
            "cafecafecafecafe"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/trace",
                                    timeout=30) as resp:
            assert json.loads(resp.read()) == {"enabled": False,
                                               "sample": 0.0, "traces": []}
    finally:
        srv.stop()


def test_front_end_sampling_decision_is_never_rerolled(weights):
    from horovod_tpu_torch.serve import Request
    _, model = weights
    t = tr.install(tr.Tracer(sample=0.5))
    rolls = {"n": 0}

    def always_lose():
        rolls["n"] += 1
        return False

    t.should_sample = always_lose
    srv, port = _port_server(model)
    try:
        status, _, hdrs = _post(port, {"tokens": [1], "max_new_tokens": 2})
        assert status == 200 and hdrs.get("X-Trace-Id") is None
        assert rolls["n"] == 1  # the front end rolled; the scheduler did not
        r = Request([2], max_new_tokens=2)
        srv.scheduler.submit(r)
        r.result(timeout=60)
        assert rolls["n"] == 2 and r.trace is None
    finally:
        srv.stop()


def test_stage_partition_sums_to_e2e_latency(weights):
    from horovod_tpu_torch.serve import Request
    _, model = weights
    srv, _ = _port_server(model)
    try:
        r = Request([1, 2, 3, 4, 5, 6, 7, 8, 9], max_new_tokens=6)
        srv.scheduler.submit(r)
        r.result(timeout=60)
        e2e_ms = (time.monotonic() - r.submitted_at) * 1e3
        total = sum(r.stage_ms.values())
        assert 0 < total <= e2e_ms + 1e-6
        assert total >= e2e_ms - 50  # result() wakeup slack only
        snap = srv.metrics.snapshot()
        assert snap["stage"]["queue"]["count"] == 1
        assert snap["stage"]["retry"]["count"] == 0
        assert 'hvd_serve_stage_ms_count{stage="decode"} 1' in \
            srv.metrics.render()
    finally:
        srv.stop()


# -- KV client propagation and fault correlation -------------------------------

def _capture_server():
    captured = []
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)

    def loop():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            with conn:
                captured.append(conn.recv(65536))
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n")

    threading.Thread(target=loop, daemon=True).start()
    return srv, srv.getsockname()[1], captured


def test_kv_client_sends_trace_headers_only_under_a_scope():
    from horovod_tpu_torch.runner.http_server import KVStoreClient
    srv, port, captured = _capture_server()
    try:
        t = tr.install(tr.Tracer(sample=1.0))
        client = KVStoreClient("127.0.0.1", port)
        ctx = t.new_context()
        with tr.scope(ctx):
            client.put("s", "k", b"v")
        assert f"X-Trace-Id: {ctx.trace_id}".encode() in captured[-1]
        assert f"X-Parent-Span: {ctx.span_id}".encode() in captured[-1]
        KVStoreClient("127.0.0.1", port).put("s", "k2", b"v")
        assert b"X-Trace-Id" not in captured[-1]
    finally:
        srv.close()


def test_fault_in_a_traced_scope_records_the_trace_id():
    """A drop-kv-response train inside a traced scope: each retry is a
    kv-retry span of the request's trace, and the firing log carries its
    trace id (None outside a scope), as JAX's ``tests/test_obs.py``
    pins it."""
    from horovod_tpu_torch import faultline as fl
    from horovod_tpu_torch.runner.http_server import (KVStoreClient,
                                                      KVStoreServer)
    srv = KVStoreServer()
    port = srv.start(0)
    t = tr.install(tr.Tracer(sample=1.0))
    plan = fl.install(fl.FaultPlan([
        fl.FaultSpec("drop-kv-response", step=0, repeat=2,
                     target=f"127.0.0.1:{port}")], seed=7))
    try:
        client = KVStoreClient("127.0.0.1", port)
        ctx = t.new_context()
        with tr.scope(ctx):
            client.put("scope", "key", b"value")
        assert srv.get("scope", "key") == b"value"
        (item,) = [x for x in t.recent_traces()
                   if x["trace_id"] == ctx.trace_id]
        retries = [n for n in item["tree"] if n["name"] == "kv-retry"]
        assert [s["args"]["attempt"] for s in retries] == [1, 2]
        assert all(s["proc"] == "kv-client" for s in retries)
        assert [e["trace_id"] for e in plan.log] == [ctx.trace_id] * 2
        plan2 = fl.install(fl.FaultPlan([fl.FaultSpec("slow-decode",
                                                      step=0)], seed=1))
        plan2.fire("engine.step", "replica-0")
        assert plan2.log[-1]["trace_id"] is None
    finally:
        fl.uninstall()
        srv.stop()


def test_metrics_timeline_sinks(tmp_path):
    """``set_brownout_level`` moves the gauge and writes a BROWNOUT
    instant; ``maybe_emit_timeline`` writes SERVE counters every
    ``HVD_SERVE_TIMELINE_EVERY`` decode steps; the controller and
    watcher counters render as JAX names them."""
    from horovod_tpu_torch.serve import ServeMetrics
    from horovod_tpu_torch.timeline import Timeline
    path = tmp_path / "tl.json"
    tl = Timeline(str(path))
    m = ServeMetrics()
    m.set_timeline(tl)
    m.set_brownout_level(2, reason="brownout_up")
    m.count_ctl_event("brownout_up")
    m.count_preempt_poll_error()
    for _ in range(m._timeline_every):
        m.observe_decode_step(1.0, 2, 2)
    m.maybe_emit_timeline(kv_stats=lambda: {"used": 3, "free": 5,
                                            "retained": 1,
                                            "prefix_hit_rate": 0.5})
    m.maybe_emit_timeline()  # rate-limited: nothing due
    tl.close()
    events = json.load(open(path))
    assert [e["args"]["level"] for e in events
            if e["name"].startswith("BROWNOUT/")] == [2]
    serve = [e for e in events if e["name"] == "SERVE/engine"]
    assert len(serve) == 1 and serve[0]["args"]["kv_blocks_used"] == 3
    text = m.render()
    for line in ("hvd_serve_brownout_level 2",
                 'hvd_serve_ctl_events_total{event="brownout_up"} 1',
                 "hvd_serve_preempt_poll_errors_total 1"):
        assert line in text
    snap = m.snapshot()
    assert (snap["brownout_level"], snap["preempt_poll_errors"]) == (2, 1)
