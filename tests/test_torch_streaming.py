"""The port's token streaming (``serve/streaming.py``, SSE over chunked
transfer) and its fault injection (``faultline/``) against the JAX
package's behaviour list (``tests/test_streaming.py``, its wire, stream,
HTTP and faultline cases).

The engines serve the MLP Markov chain of ``serve.MLPAdapter``: the port's
weights are the JAX MLP's, converted by ``mlp_params_from_jax``, so the
port's greedy chains are held to the JAX adapter's.  Streamed answers are
held to the buffered answer of the same request (concatenated token
events == buffered tokens, the done event == the buffered outcome
fields), under a slow client, a hangup, a mid-stream deadline and the
``stream.emit`` faults.  The fault plan parser and its firing schedule
are held to JAX's under one seed, and the ``engine.step`` faults to the
JAX engine's recovery.
"""

import http.client
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import faultline as jfl
from horovod_tpu.models import create_mlp as jax_create_mlp
from horovod_tpu.serve import InferenceEngine as JaxEngine
from horovod_tpu.serve import MLPAdapter as JaxMLPAdapter
from horovod_tpu.serve import Request as JaxRequest
from horovod_tpu_torch import faultline as fl
from horovod_tpu_torch.models import create_mlp, mlp_params_from_jax
from horovod_tpu_torch.serve import (DeadlineExceededError, InferenceEngine,
                                     MLPAdapter, NoHealthyReplicaError,
                                     QueueFullError, Replica,
                                     ReplicaScheduler, Request, ServeMetrics,
                                     ServeServer)
from horovod_tpu_torch.serve.streaming import (CHUNK_TERMINATOR, TokenStream,
                                               chunk_frame, encode_sse,
                                               error_status_for, parse_sse,
                                               wants_stream)

torch.set_num_threads(2)

VOCAB = 31


@pytest.fixture(autouse=True)
def _clean_plan():
    """No fault plan leaks across tests."""
    fl.uninstall()
    jfl.uninstall()
    yield
    fl.uninstall()
    jfl.uninstall()


# -- shared harness ------------------------------------------------------------

def _mlp_pair(seed=3, vocab=VOCAB, max_len=512, cls=MLPAdapter):
    """The JAX MLP adapter and the port's on the same (converted)
    weights."""
    jmlp = jax_create_mlp(features=(16, vocab))
    params = jmlp.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, vocab)))["params"]
    mlp = create_mlp((16, vocab), in_features=vocab, device="cpu",
                     seed=None)
    mlp.load_state_dict(mlp_params_from_jax(jax.device_get(params)))
    return (cls(mlp, vocab_size=vocab, max_len=max_len),
            JaxMLPAdapter(jmlp, params, vocab_size=vocab, max_len=max_len))


def _mlp_adapter(seed=3):
    return _mlp_pair(seed)[0]


def _mlp_chain(adapter, prompt, n):
    """Ground truth of the MLP Markov chain (greedy)."""
    seq, tok = [], prompt[-1]
    for _ in range(n):
        tok = int(adapter._next([tok])[0])
        seq.append(tok)
    return seq


class _SlowMLP(MLPAdapter):
    """A visible decode-step cost, so a stream stays open long enough to
    fault (deadline expiry, disconnect) deterministically."""

    delay_s = 0.02

    def decode_paged(self, cache, tokens, positions, tables):
        time.sleep(self.delay_s)
        return MLPAdapter.decode(self, cache, tokens, positions)


def _slow_adapter():
    return _mlp_pair(cls=_SlowMLP)[0]


def _fleet_server(adapter_fn=_mlp_adapter, n=1, request_timeout_s=60,
                  **engine_kw):
    engine_kw.setdefault("max_batch", 4)
    replicas = [Replica(f"replica-{i}", None,
                        InferenceEngine(adapter_fn(), kv_mode="paged",
                                        metrics=ServeMetrics(),
                                        replica_id=f"replica-{i}",
                                        **engine_kw))
                for i in range(n)]
    sched = ReplicaScheduler(replicas, metrics=replicas[0].engine.metrics)
    server = ServeServer(sched, request_timeout_s=request_timeout_s)
    port = server.start(port=0, host="127.0.0.1")
    return server, sched, port


def _post(port, payload, headers=(), path="/generate", timeout=30):
    body = json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST",
        headers=dict({"Content-Type": "application/json"},
                     **dict(headers)))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _stream_post(port, payload, headers=(), hangup_after=None, timeout=30):
    """POST /generate and read the SSE stream as it arrives.  Returns
    ``(status, headers, buffered_body_or_None, events)``; a non-stream
    answer comes back buffered with ``events`` None.  ``hangup_after=k``
    closes the connection after the k-th token event."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/generate", body=json.dumps(payload).encode(),
                     headers=dict({"Content-Type": "application/json"},
                                  **dict(headers)))
        resp = conn.getresponse()
        ctype = resp.getheader("Content-Type") or ""
        if resp.status != 200 or "text/event-stream" not in ctype:
            return (resp.status, dict(resp.getheaders()),
                    json.loads(resp.read() or b"{}"), None)
        raw, events = b"", []
        while True:
            try:
                chunk = resp.read1(8192)
            except (http.client.HTTPException, OSError):
                break  # the server hung up mid-stream
            if not chunk:
                break
            raw += chunk
            # Parse only complete events: read1 may cut inside one.
            cut = raw.rfind(b"\n\n")
            events = parse_sse(raw[:cut + 2]) if cut >= 0 else []
            ntok = sum(1 for e in events if e[0] == "token")
            if hangup_after is not None and ntok >= hangup_after:
                resp.close()
                return resp.status, dict(resp.getheaders()), None, events
            if events and events[-1][0] in ("done", "error"):
                break
        return resp.status, dict(resp.getheaders()), None, events
    finally:
        conn.close()


def _stream_tokens(events):
    return [t for e in events if e[0] == "token" for t in e[1]["tokens"]]


def _wait_reaped(eng, timeout=15):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if (eng.active_count == 0 and eng.metrics.snapshot()
                ["requests"].get("client_gone", 0) >= 1):
            return
        time.sleep(0.02)


# -- wire helpers ----------------------------------------------------------------

def test_sse_roundtrip_and_chunk_framing():
    evs = [("token", {"index": 0, "tokens": [5, 7]}),
           ("done", {"request_id": "r-1", "usage": {"total_tokens": 9}})]
    raw = b"".join(encode_sse(k, d) for k, d in evs)
    assert parse_sse(raw) == evs
    assert chunk_frame(b"hello") == b"5\r\nhello\r\n"
    assert CHUNK_TERMINATOR == b"0\r\n\r\n"
    assert chunk_frame(b"x" * 26).startswith(b"1a\r\n")  # hex length


def test_wants_stream_body_flag_and_accept_header():
    assert wants_stream({"stream": True}, {})
    assert not wants_stream({"stream": False}, {})
    assert not wants_stream({}, {})
    assert wants_stream({}, {"Accept": "text/event-stream"})
    assert not wants_stream({}, {"Accept": "application/json"})


def test_error_status_mapping_mirrors_buffered_path():
    assert error_status_for(QueueFullError("full")) == 503
    assert error_status_for(NoHealthyReplicaError("none")) == 503
    assert error_status_for(DeadlineExceededError("late")) == 504
    assert error_status_for(TimeoutError("cap")) == 504
    assert error_status_for(ValueError("bad")) == 400
    assert error_status_for(RuntimeError("boom")) == 500


# -- TokenStream -------------------------------------------------------------------

def _drain(s):
    got, events = [], []
    while True:
        ev = s.next_event(timeout=1.0)
        events.append(ev)
        if ev[0] != "token":
            return got, events
        got.extend(ev[1]["tokens"])


def test_token_stream_delivers_in_order_and_finish_flushes_tail():
    s = TokenStream(maxlen=64)
    s.publish(0, 11)
    s.publish(1, 12)
    # finish() publishes the unpublished tail (positions 2, 3) before
    # the terminal event.
    s.finish([11, 12, 13, 14])
    got, events = _drain(s)
    assert got == [11, 12, 13, 14]
    assert events[-1] == ("done", None)
    assert s.counters() == {"published": 4, "coalesced": 0,
                            "duplicates": 0}
    assert s.next_event(timeout=0.1) == ("done", None)  # sticky


def test_token_stream_dedupes_failover_replay():
    s = TokenStream(maxlen=64)
    for pos, tok in enumerate([4, 5, 6]):
        s.publish(pos, tok)
    # A failover replay decodes from position 0 again.
    for pos, tok in enumerate([4, 5, 6, 7]):
        s.publish(pos, tok)
    s.finish([4, 5, 6, 7])
    got, _ = _drain(s)
    assert got == [4, 5, 6, 7]
    assert s.counters()["duplicates"] == 3
    assert s.counters()["published"] == 4


def test_token_stream_bounded_queue_coalesces_never_drops():
    s = TokenStream(maxlen=2)
    toks = list(range(10, 20))
    for pos, tok in enumerate(toks):
        s.publish(pos, tok)
    assert s.counters()["coalesced"] == len(toks) - 2
    s.finish(toks)
    got, events = _drain(s)
    assert got == toks
    assert len(events) == 3  # two token events and the terminal


def test_token_stream_first_terminal_wins_and_abort_is_idempotent():
    s = TokenStream(maxlen=4)
    s.publish(0, 1)
    exc = DeadlineExceededError("expired mid-stream")
    s.abort(exc)
    s.abort(RuntimeError("second terminal must lose"))
    s.finish([1, 2, 3])
    assert s.next_event(timeout=1.0) == ("token", {"index": 0,
                                                  "tokens": [1]})
    kind, err = s.next_event(timeout=1.0)
    assert kind == "error" and err is exc
    s.publish(5, 9)  # dropped after the terminal
    assert s.next_event(timeout=0.1) == ("error", exc)


def test_token_stream_next_event_times_out_empty():
    s = TokenStream(maxlen=4)
    t0 = time.monotonic()
    assert s.next_event(timeout=0.05) is None
    assert time.monotonic() - t0 < 1.0


def test_token_stream_logprobs_ride_token_events():
    s = TokenStream(maxlen=64, logprobs=True)
    s.publish(0, 3, {"token": 3, "logprob": -0.5})
    s.finish([3], [{"token": 3, "logprob": -0.5}])
    kind, data = s.next_event(timeout=1.0)
    assert kind == "token"
    assert data["logprobs"] == [{"token": 3, "logprob": -0.5}]


# -- HTTP: streamed == buffered ----------------------------------------------------

def test_stream_matches_buffered_across_pow2_buckets():
    port_ad, jax_ad = _mlp_pair()
    server, sched, port = _fleet_server(lambda: port_ad)
    jeng = JaxEngine(jax_ad, kv_mode="paged", max_batch=4,
                     replica_id="jax").start()
    try:
        for plen in (3, 8, 9, 17):
            prompt = [(5 * plen + j) % VOCAB for j in range(plen)]
            payload = {"tokens": prompt, "max_new_tokens": 12}
            _, buffered = _post(port, payload)
            status, _, _, events = _stream_post(
                port, dict(payload, stream=True))
            assert status == 200
            assert events[-1][0] == "done"
            assert _stream_tokens(events) == buffered["tokens"]
            assert buffered["tokens"] == _mlp_chain(port_ad, prompt, 12)
            assert buffered["tokens"] == jeng.generate(prompt,
                                                       max_new_tokens=12)
            done = events[-1][1]
            for key in ("request_id", "finish_reason", "usage", "seed",
                        "qos", "tenant"):
                assert key in done, key
            assert done["usage"] == buffered["usage"]
            assert done["stream"]["published"] == len(buffered["tokens"])
            assert done["stream"]["duplicates"] == 0
        sampled = {"tokens": [1, 2, 3], "max_new_tokens": 10,
                   "temperature": 0.8, "seed": 123}
        _, buf = _post(port, sampled)
        _, _, _, events = _stream_post(port, dict(sampled, stream=True))
        assert _stream_tokens(events) == buf["tokens"]
        assert events[-1][1]["seed"] == buf["seed"] == 123
        assert sched.metrics.snapshot()["stream"]["published"] >= 12
    finally:
        jeng.stop()
        server.stop()


def test_accept_header_opts_into_streaming_without_body_flag():
    server, _, port = _fleet_server()
    try:
        status, hdrs, _, events = _stream_post(
            port, {"tokens": [1, 2, 3], "max_new_tokens": 4},
            headers=[("Accept", "text/event-stream")])
        assert status == 200
        assert "text/event-stream" in hdrs.get("Content-Type", "")
        assert events[-1][0] == "done"
        assert len(_stream_tokens(events)) == 4
    finally:
        server.stop()


def test_stream_pre_first_byte_error_answers_buffered_400():
    server, _, port = _fleet_server()
    try:
        # A schema without eos_id is refused before admission: the
        # client sees an ordinary buffered 400, not a broken stream.
        status, _, body, events = _stream_post(
            port, {"tokens": [1], "stream": True,
                   "schema": {"type": "boolean"}})
        assert status == 400 and events is None
        assert "eos_id" in body["error"]
        # Refused by the engine (prompt + max_new_tokens past max_len)
        # after submit, still before the first byte.
        status, _, body, events = _stream_post(
            port, {"tokens": [1], "stream": True, "max_new_tokens": 600})
        assert status == 400 and events is None
        assert "max_len" in body["error"]
    finally:
        server.stop()


def test_mid_stream_deadline_ends_with_terminal_504_error_event():
    server, sched, port = _fleet_server(_slow_adapter)
    eng = sched.replicas[0].engine
    try:
        status, _, _, events = _stream_post(
            port, {"tokens": [1, 2], "max_new_tokens": 400,
                   "timeout_s": 0.5, "stream": True}, timeout=30)
        assert status == 200  # headers went out before the expiry
        kinds = [e[0] for e in events]
        assert kinds.count("token") >= 1, events
        assert kinds[-1] == "error"
        err = events[-1][1]
        assert err["code"] == 504
        assert "expired" in err["error"] or "deadline" in err["error"]
        deadline = time.monotonic() + 10
        while eng.active_count and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.active_count == 0
    finally:
        server.stop()


def test_client_disconnect_aborts_sequence_and_counts_client_gone():
    server, sched, port = _fleet_server(_slow_adapter)
    eng = sched.replicas[0].engine
    try:
        status, _, _, events = _stream_post(
            port, {"tokens": [3, 4], "max_new_tokens": 400,
                   "stream": True}, hangup_after=1)
        assert status == 200
        assert len(_stream_tokens(events)) >= 1
        _wait_reaped(eng)
        assert eng.active_count == 0
        assert eng.metrics.snapshot()["requests"]["client_gone"] >= 1
        assert eng.kv_stats()["used"] == 0
    finally:
        server.stop()


# -- faultline -----------------------------------------------------------------------

def test_faultline_stream_kinds_parse_with_default_point():
    plan = fl.parse_plan("stream-disconnect@3,slow-client*5~0.04", seed=9)
    disc, slow = plan.specs
    assert disc.kind == "stream-disconnect"
    assert disc.point == "stream.emit" and disc.step == 3
    assert slow.kind == "slow-client" and slow.point == "stream.emit"
    assert slow.repeat == 5 and slow.param == pytest.approx(0.04)
    assert fl.parse_plan("stream-disconnect/stream.emit",
                         seed=1).specs[0].point == "stream.emit"


@pytest.mark.parametrize("text,seed", [
    ("slow-decode~0.08@2,poison-step:replica-1@6", 3),
    ("kill-rank:chaos-host@4*3,drop-kv-response*2,swap-abort,"
     "stream-disconnect,slow-client*5~0.04,pool-corrupt-block~2", 7),
    ("delay-tier-fetch*4~0.01/tier.fetch,load-spike:ctl~8,"
     "blackhole-endpoint:127.0.0.1:9*2~1.5", 11),
])
def test_fault_plan_matches_jax_specs_schedule_and_firings(text, seed):
    """The copied plan parser gives JAX's specs and step schedule under
    one seed, and the same firing sequence for one sequence of injection
    point consultations."""
    plan, jplan = fl.parse_plan(text, seed=seed), jfl.parse_plan(
        text, seed=seed)
    assert plan.schedule() == jplan.schedule()
    assert fl.KINDS == jfl.KINDS and fl.POINTS == jfl.POINTS
    assert fl.DEFAULT_POINT == jfl.DEFAULT_POINT
    rng = np.random.RandomState(seed)
    instances = [None, "replica-0", "replica-1", "chaos-host", "ctl",
                 "127.0.0.1:9"]
    for _ in range(400):
        point = fl.POINTS[rng.randint(len(fl.POINTS))]
        inst = instances[rng.randint(len(instances))]
        got = [s.kind for s in plan.fire(point, inst)]
        want = [s.kind for s in jplan.fire(point, inst)]
        assert got == want
    assert plan.firing_sequence() == jplan.firing_sequence()
    assert plan.exhausted() == jplan.exhausted()
    assert fl.diurnal_load(24, 40, 4, seed=seed) == jfl.diurnal_load(
        24, 40, 4, seed=seed)


def test_faultline_stream_disconnect_reaps_sequence():
    server, sched, port = _fleet_server(_slow_adapter)
    eng = sched.replicas[0].engine
    fl.install(fl.FaultPlan(
        [fl.FaultSpec("stream-disconnect", step=2)], seed=1))
    try:
        status, _, _, events = _stream_post(
            port, {"tokens": [5, 6], "max_new_tokens": 400,
                   "stream": True}, timeout=30)
        # The injected BrokenPipeError cuts the stream: no terminal
        # event reached the client.
        assert status == 200
        assert [e[0] for e in events].count("token") >= 1
        assert not events or events[-1][0] == "token"
        _wait_reaped(eng)
        assert eng.active_count == 0
        assert eng.metrics.snapshot()["requests"]["client_gone"] >= 1
    finally:
        server.stop()


def test_faultline_slow_client_coalesces_bounded_queue(monkeypatch):
    monkeypatch.setenv("HVD_SERVE_STREAM_QUEUE", "2")
    server, _, port = _fleet_server()
    try:
        payload = {"tokens": [7, 8], "max_new_tokens": 30}
        _, buffered = _post(port, payload)
        fl.install(fl.FaultPlan(
            [fl.FaultSpec("slow-client", step=0, repeat=1000,
                          param=0.03)], seed=1))
        _, _, _, events = _stream_post(port, dict(payload, stream=True),
                                       timeout=60)
        assert events[-1][0] == "done"
        # A stalled writer and a bounded queue: fewer, fatter events,
        # and the concatenation still equals the buffered answer.
        assert _stream_tokens(events) == buffered["tokens"]
        assert sum(1 for e in events if e[0] == "token") < 30
        assert events[-1][1]["stream"]["coalesced"] > 0
    finally:
        server.stop()


@pytest.mark.parametrize("kind", ["poison-step", "slow-decode",
                                  "pool-corrupt-block"])
def test_engine_step_faults_recover_as_jax(kind):
    """The ``engine.step`` point fires at the same iteration in both
    engines; ``poison-step`` fails the in-flight request with
    ``FaultInjected`` and the engine keeps serving, the other kinds leave
    the answer exact."""
    port_ad, jax_ad = _mlp_pair()
    outcomes = []
    for mod, req, eng in (
            (fl, Request, InferenceEngine(port_ad, kv_mode="paged",
                                          max_batch=4,
                                          metrics=ServeMetrics())),
            (jfl, JaxRequest, JaxEngine(jax_ad, kv_mode="paged",
                                        max_batch=4))):
        mod.install(mod.FaultPlan(
            [mod.FaultSpec(kind, step=1, param=0.01)], seed=1))
        # Queued before the loop starts: iteration 0 admits it, and the
        # fault fires at iteration 1 with the request mid-decode.
        r = req([1, 2, 3], max_new_tokens=6)
        eng.batcher.submit(r)
        eng.start()
        try:
            try:
                got = r.result(timeout=30)
            except mod.FaultInjected:
                got = "FaultInjected"
            after = eng.generate([4, 5], max_new_tokens=4)
            outcomes.append((got, after,
                             mod.active_plan().firing_sequence()))
        finally:
            eng.stop()
            mod.uninstall()
    assert outcomes[0] == outcomes[1]
    want = "FaultInjected" if kind == "poison-step" else _mlp_chain(
        port_ad, [1, 2, 3], 6)
    assert outcomes[0][0] == want
    assert outcomes[0][2] == [("engine.step", 1, kind)]
