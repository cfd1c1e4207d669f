"""The port's prefix-affinity router (``serve/router.py``,
``serve/router_server.py``) against the JAX package's.

The ring and the affinity key are the routing contract between router
instances: the port's ring positions, ``affinity_key`` and
``_candidates`` equal the JAX router's for the same endpoint names,
tokens and model.  The retry / backoff / 502 / 504 / 503-clamp /
hedging / ejection / half-open readmission state machine and the
``router.forward`` faults run both routers over the same fake endpoints
(the ``_transport`` seam JAX's ``tests/test_router.py`` stubs, with its
``_fast_config`` millisecond timers): the same status codes, bodies and
counters.  Then a mixed fleet over real sockets: the port's
``RouterServer`` in front of one JAX endpoint and one port endpoint
serving the same TINY GPT-2 weights on the CPU gives a single port
engine's greedy answers whichever endpoint served, a streamed request
gives the buffered tokens, and a draining endpoint of either package
(and the draining router) refuses with ``Retry-After`` clamped by the
client's ``X-Request-Timeout-S``.
"""

import http.client
import json
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import faultline as jfl
from horovod_tpu.models import transformer as jt
from horovod_tpu.serve import InferenceEngine as JaxEngine
from horovod_tpu.serve import Replica as JaxReplica
from horovod_tpu.serve import ReplicaScheduler as JaxScheduler
from horovod_tpu.serve import ServeServer as JaxServer
from horovod_tpu.serve import TransformerAdapter as JaxAdapter
from horovod_tpu.serve import router as jrouter
from horovod_tpu_torch import faultline as fl
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      params_from_jax)
from horovod_tpu_torch.serve import (InferenceEngine, Router, RouterConfig,
                                     RouterServer, ServeServer,
                                     TransformerAdapter, build_replicas)
from horovod_tpu_torch.serve import router as prouter
from horovod_tpu_torch.serve.streaming import encode_sse, parse_sse

torch.set_num_threads(2)

EP0, EP1 = "10.0.0.1:8000", "10.0.0.2:8000"
VOCAB = 31
_OK_BODY = json.dumps({"tokens": [1, 2, 3]}).encode()

PKGS = {"port": types.SimpleNamespace(mod=prouter, fl=fl),
        "jax": types.SimpleNamespace(mod=jrouter, fl=jfl)}


def _fast_config(pkg, **overrides):
    base = dict(retry_base_s=0.001, retry_cap_s=0.005, probe_s=0.05,
                eject_failures=2, block_tokens=4)
    base.update(overrides)
    return pkg.mod.RouterConfig(**base)


def _stub(router, behavior, calls=None):
    """Replace the transport seam: ``behavior[name]`` is a response
    tuple, an Exception to raise, or a callable returning either."""
    calls = [] if calls is None else calls

    def transport(host, port, method, path, body, headers, timeout_s):
        name = f"{host}:{port}"
        calls.append(name)
        out = behavior[name]
        if callable(out):
            out = out()
        if isinstance(out, Exception):
            raise out
        return out

    router._transport = transport
    return calls


def _key_for(router, target, want_second=None):
    for s in range(4096):
        p = [(7 * s + j) % VOCAB for j in range(12)]
        order = router._ring.lookup(router.affinity_key(p))
        if order[0] == target and \
                (want_second is None or order[1] == want_second):
            return p
    raise AssertionError(f"no prompt routes to {target}")


def _body(tokens, **extra):
    return json.dumps(dict({"tokens": tokens}, **extra)).encode()


_COUNTERS = ("forwards", "retries", "hedges", "hedges_won", "ejections",
             "readmissions")


def _counters(r):
    snap = r.metrics.snapshot()
    return dict({k: snap[k] for k in _COUNTERS}, requests=snap["requests"],
                affinity=snap["affinity"])


# -- ring, affinity key, candidates --------------------------------------------

def test_ring_positions_and_lookup_match_jax():
    names = [f"10.0.0.{i}:80" for i in range(5)] + ["a:1", "host-b:8000"]
    a, b = prouter._HashRing(vnodes=16), jrouter._HashRing(vnodes=16)
    for n in names:
        a.add(n)
        b.add(n)
        assert a._pos(n) == b._pos(n)
    assert a._ring == b._ring
    for key in list(range(64)) + [2 ** 63 - 1, -5, 12345678901234]:
        assert a.lookup(key) == b.lookup(key)
    a.remove(names[2])
    b.remove(names[2])
    assert [a.lookup(k) for k in range(64)] == [b.lookup(k)
                                                for k in range(64)]


@pytest.mark.parametrize("n,model", [(2, None), (4, None), (9, None),
                                     (12, None), (30, None), (12, "m1"),
                                     (30, "tuned")])
def test_affinity_key_matches_jax(n, model):
    tokens = np.random.RandomState(n).randint(0, 50257, (n,)).tolist()
    for blocks in (1, 2, 3):
        cfg = dict(affinity_blocks=blocks, block_tokens=4)
        p = Router([EP0, EP1], config=RouterConfig(**cfg))
        j = jrouter.Router([EP0, EP1], config=jrouter.RouterConfig(**cfg))
        assert p.affinity_key(tokens, model) == \
            j.affinity_key(tokens, model)


def test_candidates_match_jax_under_load_ejection_and_drain():
    names = [f"10.1.0.{i}:9000" for i in range(4)]
    routers = {k: v.mod.Router(names, config=_fast_config(v))
               for k, v in PKGS.items()}
    keys = [routers["port"].affinity_key(
        np.random.RandomState(s).randint(0, 999, (9,)).tolist())
        for s in range(24)]

    def both(fn):
        return {k: fn(r) for k, r in routers.items()}

    for setup in (lambda r: None,
                  lambda r: setattr(r._endpoints[names[0]], "inflight", 9),
                  lambda r: setattr(r._endpoints[names[1]],
                                    "brownout_level", 2),
                  lambda r: setattr(r._endpoints[names[2]], "draining",
                                    True),
                  lambda r: setattr(r._endpoints[names[3]],
                                    "health_status", "unserving")):
        both(setup)
        got = both(lambda r: [r._candidates(k) for k in keys])
        assert got["port"] == got["jax"]


# -- the state machine over fake endpoints, both routers -----------------------

def _failover_ejection_readmission(pkg):
    r = pkg.mod.Router([EP0, EP1], config=_fast_config(pkg))
    behavior = {EP0: ConnectionError("down"), EP1: (200, {}, _OK_BODY)}
    calls = _stub(r, behavior)
    body = _body(_key_for(r, EP0, want_second=EP1))
    out = [r.handle(body, {})[0] for _ in range(2)]
    ejected = not r._endpoints[EP0].admitted
    calls.clear()
    out.append(r.handle(body, {})[0])
    routed_to_ejected = EP0 in calls
    behavior[EP0] = (200, {}, _OK_BODY)
    time.sleep(r.config.probe_s + 0.01)
    out.append(r.handle(body, {})[0])
    return dict(statuses=out, ejected=ejected,
                routed_to_ejected=routed_to_ejected,
                admitted=r._endpoints[EP0].admitted, **_counters(r))


def _retry_exhaustion(pkg):
    r = pkg.mod.Router([EP0, EP1], config=_fast_config(pkg, retry_max=3))
    _stub(r, {EP0: ConnectionError("x"), EP1: ConnectionError("x")})
    status, headers, body = r.handle(_body([1, 2, 3], timeout_s=5.0), {})
    return dict(status=status, body=json.loads(body)["error"][:40],
                headers=sorted(k for k, _ in headers), **_counters(r))


def _budget_exhaustion(pkg):
    r = pkg.mod.Router([EP0, EP1], config=_fast_config(
        pkg, retry_max=1000, retry_base_s=0.02, retry_cap_s=0.02,
        eject_failures=1000))
    _stub(r, {EP0: ConnectionError("x"), EP1: ConnectionError("x")})
    t0 = time.monotonic()
    status, headers, _ = r.handle(_body([1, 2, 3]),
                                  {"X-Request-Timeout-S": "0.15"})
    return dict(status=status, bounded=time.monotonic() - t0 < 2.0,
                headers=sorted(k for k, _ in headers),
                requests=r.metrics.snapshot()["requests"])


def _backpressure_503(pkg):
    r = pkg.mod.Router([EP0, EP1], config=_fast_config(pkg, retry_max=2))
    shed = (503, {"Retry-After": "60"}, b'{"error": "shed"}')
    _stub(r, {EP0: shed, EP1: shed})
    status, headers, _ = r.handle(_body([1, 2, 3]),
                                  {"X-Request-Timeout-S": "1.0"})
    ra = dict(headers).get("Retry-After")
    return dict(status=status, retry_after_within_budget=float(ra) <= 1.0,
                **_counters(r))


def _hedge_buffered(pkg):
    r = pkg.mod.Router([EP0, EP1], config=_fast_config(pkg, hedge_s=0.02))

    def slow():
        time.sleep(0.3)
        return 200, {}, b'{"tokens": [9, 9, 9]}'

    _stub(r, {EP0: slow, EP1: (200, {}, _OK_BODY)})
    t0 = time.monotonic()
    status, _, out = r.handle(_body(_key_for(r, EP0, want_second=EP1)), {})
    return dict(status=status, body=out, fast=time.monotonic() - t0 < 0.3,
                **_counters(r))


class _FakeReader:
    """A live event-stream stand-in: ``read1`` hands out one chunk a
    call, then ``b""``."""

    def __init__(self, chunks, delay=0.0):
        self.chunks = list(chunks)
        self.delay = delay
        self.on_close = None
        self.closed = False

    def read1(self, n=8192):
        if self.delay:
            time.sleep(self.delay)
        return self.chunks.pop(0) if self.chunks else b""

    def close(self):
        self.closed = True
        if self.on_close is not None:
            self.on_close()


def _hedge_streamed(pkg):
    r = pkg.mod.Router([EP0, EP1], config=_fast_config(pkg, hedge_s=0.02))
    stream = [encode_sse("token", {"index": 0, "tokens": [4]}),
              encode_sse("done", {"tokens_total": 1})]
    readers = {}

    def transport_stream(host, port, method, path, body, headers,
                         timeout_s):
        name = f"{host}:{port}"
        if name == EP0:
            time.sleep(0.3)
        readers[name] = _FakeReader(stream)
        return (200, {"Content-Type": "text/event-stream"}, None,
                readers[name])

    r._transport_stream = transport_stream
    got = []

    def begin(status, headers):
        got.append(("head", status))
        return lambda data: got.append(data) or True

    status, headers, body = r.handle(
        _body(_key_for(r, EP0, want_second=EP1), stream=True), {},
        stream=begin)
    time.sleep(0.4)  # the slow primary lands and closes itself
    return dict(status=status, headers=headers, body=body, got=got,
                winner_closed=readers[EP1].closed,
                loser_closed=readers.get(EP0) is not None
                and readers[EP0].closed, **_counters(r))


def _probe_window_wait(pkg):
    r = pkg.mod.Router([EP0], config=_fast_config(
        pkg, eject_failures=1, retry_max=50))
    flips = {"n": 0}

    def flaky():
        flips["n"] += 1
        return (ConnectionError("first attempt dies") if flips["n"] <= 1
                else (200, {}, _OK_BODY))

    _stub(r, {EP0: flaky})
    status, _, out = r.handle(_body([1, 2, 3]), {"X-Request-Timeout-S": "5"})
    return dict(status=status, body=out, **_counters(r))


def _drop_and_slow_route(pkg):
    r = pkg.mod.Router([EP0, EP1], config=_fast_config(pkg,
                                                       eject_failures=5))
    calls = _stub(r, {EP0: (200, {}, _OK_BODY), EP1: (200, {}, _OK_BODY)})
    body = _body(_key_for(r, EP0, want_second=EP1))
    plan = pkg.fl.install(pkg.fl.parse_plan(
        f"drop-route:{EP0}@0*1/router.forward,"
        f"slow-route:{EP1}@0*1~0.1/router.forward"))
    try:
        t0 = time.monotonic()
        status, _, _ = r.handle(body, {})
        stalled = time.monotonic() - t0 >= 0.1
    finally:
        pkg.fl.uninstall()
    return dict(status=status, calls=calls, stalled=stalled,
                fired=[e["kind"] for e in plan.log], **_counters(r))


def _blackhole(pkg):
    r = pkg.mod.Router([EP0, EP1], config=_fast_config(pkg,
                                                       eject_failures=5))
    calls = _stub(r, {EP0: (200, {}, _OK_BODY), EP1: (200, {}, _OK_BODY)})
    pkg.fl.install(pkg.fl.parse_plan(
        f"blackhole-endpoint:{EP0}@0*1~0.2/router.forward"))
    try:
        status, _, _ = r.handle(_body(_key_for(r, EP0, want_second=EP1)),
                                {})
    finally:
        pkg.fl.uninstall()
    return dict(status=status, calls=calls,
                blackholed=r._endpoints[EP0].blackholed_until
                > time.monotonic() - 0.2, **_counters(r))


def _kill_rank(pkg):
    r = pkg.mod.Router([EP0, EP1], config=_fast_config(pkg))
    calls = _stub(r, {EP0: (200, {}, _OK_BODY), EP1: (200, {}, _OK_BODY)})
    body = _body(_key_for(r, EP0, want_second=EP1))
    pkg.fl.install(pkg.fl.parse_plan(f"kill-rank:{EP0}@0*1/router.forward"))
    try:
        out = [r.handle(body, {})[0]]
    finally:
        pkg.fl.uninstall()
    ejected = not r._endpoints[EP0].admitted
    calls.clear()
    out.append(r.handle(body, {})[0])
    while_ejected = list(calls)
    time.sleep(r.config.probe_s + 0.01)
    out.append(r.handle(body, {})[0])
    return dict(statuses=out, ejected=ejected, while_ejected=while_ejected,
                **_counters(r))


_SCENARIOS = {
    "failover_ejection_readmission": (
        _failover_ejection_readmission,
        lambda o: o["statuses"] == [200] * 4 and o["ejected"]
        and not o["routed_to_ejected"] and o["readmissions"] == 1),
    "retry_exhaustion_502": (_retry_exhaustion,
                             lambda o: o["status"] == 502),
    "budget_exhaustion_504": (
        _budget_exhaustion,
        lambda o: o["status"] == 504 and o["bounded"]
        and "X-Deadline-Remaining-S" in o["headers"]),
    "backpressure_503_clamped": (
        _backpressure_503,
        lambda o: o["status"] == 503 and o["retry_after_within_budget"]
        and o["ejections"] == 0),
    "hedge_buffered": (
        _hedge_buffered,
        lambda o: o["body"] == _OK_BODY and o["fast"]
        and (o["hedges"], o["hedges_won"]) == (1, 1)),
    "hedge_streamed": (
        _hedge_streamed,
        lambda o: o["headers"] is None and o["got"][0] == ("head", 200)
        and o["winner_closed"] and o["loser_closed"]
        and (o["hedges"], o["hedges_won"]) == (1, 1)),
    "probe_window_wait": (
        _probe_window_wait,
        lambda o: o["status"] == 200 and o["ejections"] == 1
        and o["readmissions"] == 1),
    "drop_and_slow_route": (
        _drop_and_slow_route,
        lambda o: o["status"] == 200 and o["calls"] == [EP1]
        and o["stalled"] and o["fired"] == ["drop-route", "slow-route"]),
    "blackhole_endpoint": (
        _blackhole,
        lambda o: o["status"] == 200 and o["calls"] == [EP1]
        and o["blackholed"]),
    "kill_rank": (
        _kill_rank,
        lambda o: o["statuses"] == [200] * 3 and o["ejected"]
        and EP0 not in o["while_ejected"] and o["readmissions"] == 1),
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_router_state_machine_matches_jax(name):
    scenario, holds = _SCENARIOS[name]
    got = scenario(PKGS["port"])
    want = scenario(PKGS["jax"])
    assert got == want
    assert holds(got), got


def test_active_health_poll_reads_brownout_and_drain():
    """The ``/healthz`` poller takes the endpoint's own verdict: a
    browned-out endpoint stays admitted but loses its affinity edge, a
    draining one leaves the candidates."""
    for pkg in PKGS.values():
        r = pkg.mod.Router([EP0, EP1], config=_fast_config(pkg))
        answers = {EP0: {"status": "ok", "brownout_level": 2},
                   EP1: {"status": "ok", "draining": True}}

        class _Conn:
            def __init__(self, host, port, timeout):
                self.name = f"{host}:{port}"

            def request(self, method, path):
                assert (method, path) == ("GET", "/healthz")

            def getresponse(self):
                return types.SimpleNamespace(
                    read=lambda: json.dumps(answers[self.name]).encode())

            def close(self):
                pass

        orig = pkg.mod.http.client.HTTPConnection
        pkg.mod.http.client.HTTPConnection = _Conn
        try:
            for ep in (EP0, EP1):
                r._probe_health(ep)
        finally:
            pkg.mod.http.client.HTTPConnection = orig
        assert r._endpoints[EP0].brownout_level == 2
        assert r._endpoints[EP1].draining
        _, avail = r._candidates(r.affinity_key([1, 2, 3, 4, 5]))
        assert avail == [EP0]


# -- a mixed fleet: one JAX endpoint, one port endpoint -----------------------

BT = 8
TVOCAB = 61
_JTINY = jt.TransformerConfig(vocab_size=TVOCAB, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, max_len=64, causal=True,
                              dtype=jnp.float32, scan_layers=False)
_TTINY = TransformerConfig(vocab_size=TVOCAB, num_layers=2, num_heads=2,
                           d_model=32, d_ff=64, max_len=64,
                           dtype=torch.float32)


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
def fleet():
    params = _flax_params()
    model = Transformer(_TTINY, device="cpu")
    model.load_state_dict(params_from_jax(params))
    jeng = JaxEngine(JaxAdapter(_JTINY, params, block_tokens=BT,
                                attn_impl="gather"),
                     kv_mode="paged", max_batch=4, prefill_chunk=5,
                     replica_id="replica-0")
    jsrv = JaxServer(JaxScheduler([JaxReplica("replica-0", None, jeng)]))
    psrv = ServeServer(build_replicas(
        lambda: TransformerAdapter(_TTINY, model, block_tokens=BT,
                                   device="cpu"),
        num_replicas=1, max_batch=4, prefill_chunk=5))
    eps = [f"127.0.0.1:{jsrv.start(port=0, host='127.0.0.1')}",
           f"127.0.0.1:{psrv.start(port=0, host='127.0.0.1')}"]
    router = Router(eps, config=RouterConfig(block_tokens=BT,
                                             retry_base_s=0.001,
                                             retry_cap_s=0.005))
    rsrv = RouterServer(router)
    rport = rsrv.start(port=0, host="127.0.0.1")
    ref = InferenceEngine(TransformerAdapter(_TTINY, model, block_tokens=BT,
                                             device="cpu"),
                          max_batch=4, prefill_chunk=5, replica_id="ref")
    ref.start()
    yield types.SimpleNamespace(jsrv=jsrv, psrv=psrv, eps=eps, router=router,
                                rsrv=rsrv, rport=rport, ref=ref)
    ref.stop()
    rsrv.stop()
    psrv.stop()
    jsrv.stop()


def _post(port, payload, headers=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/generate", json.dumps(payload).encode(),
                     dict({"Content-Type": "application/json"},
                          **(headers or {})))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_mixed_fleet_answers_as_one_port_engine(fleet):
    """6 sessions sharing a prefix, 2 repeats, through the port's router
    over a JAX and a port endpoint: no request lost, every greedy answer
    a single port engine's, both endpoints served, and the repeats
    landed where their prefix blocks live."""
    rng = np.random.RandomState(7)
    prefix = rng.randint(0, TVOCAB, (BT,)).tolist()
    prompts = [prefix + rng.randint(0, TVOCAB, (BT + s,)).tolist()
               for s in range(6)]
    want = [fleet.ref.generate(p, max_new_tokens=4) for p in prompts]
    served = set()
    for _ in range(2):
        for p, w in zip(prompts, want):
            status, _, body = _post(fleet.rport, {"tokens": p,
                                                  "max_new_tokens": 4})
            assert status == 200, body
            out = json.loads(body)
            assert out["tokens"] == w
            served.add(fleet.router._ring.lookup(
                fleet.router.affinity_key(p))[0])
    assert served == set(fleet.eps)
    snap = fleet.router.metrics.snapshot()
    assert snap["requests"]["ok"] >= 12
    assert snap["affinity"]["hit_rate"] == 1.0


def test_mixed_fleet_stream_gives_the_buffered_tokens(fleet):
    """A streamed request through the router, once to each endpoint:
    the SSE token events concatenate to a single port engine's buffered
    answer, and the stream ends with its ``done`` event."""
    rng = np.random.RandomState(3)
    by_ep = {}
    while len(by_ep) < len(fleet.eps):
        p = rng.randint(0, TVOCAB, (13,)).tolist()
        by_ep.setdefault(fleet.router._ring.lookup(
            fleet.router.affinity_key(p))[0], p)
    for ep, p in sorted(by_ep.items()):
        status, headers, raw = _post(fleet.rport, {
            "tokens": p, "max_new_tokens": 5, "stream": True})
        assert status == 200
        assert headers["Content-Type"].startswith("text/event-stream")
        events = parse_sse(raw)
        streamed = [t for kind, d in events if kind == "token"
                    for t in d["tokens"]]
        assert events[-1][0] == "done"
        assert streamed == fleet.ref.generate(p, max_new_tokens=5), ep


def _refusal(port):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"tokens": [3, 1], "max_new_tokens": 2}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Request-Timeout-S": "2"}), timeout=10)
    h = e.value.headers
    return (e.value.code, h.get("Retry-After"),
            h.get("X-Deadline-Remaining-S"), h.get("Connection"))


def test_drain_refusal_clamps_retry_after_as_jax(fleet):
    """A draining server refuses before any Request exists: its
    Retry-After is clamped by the X-Request-Timeout-S header and the
    refusal carries X-Deadline-Remaining-S, the port's as the JAX
    server's.  Meanwhile the router fails over to the other endpoint,
    and a draining router refuses the same way."""
    port_of = {ep: int(ep.rsplit(":", 1)[1]) for ep in fleet.eps}
    answers = {}
    for ep, srv in zip(fleet.eps, (fleet.jsrv, fleet.psrv)):
        srv.httpd.begin_drain()
        try:
            answers[ep] = _refusal(port_of[ep])
            prompt = [(5 * s) % TVOCAB for s in range(12)]
            status, _, body = _post(fleet.rport, {"tokens": prompt,
                                                  "max_new_tokens": 3})
            assert status == 200, body
            assert json.loads(body)["tokens"] == fleet.ref.generate(
                prompt, max_new_tokens=3)
        finally:
            srv.httpd.draining = False
    jax_answer, port_answer = answers[fleet.eps[0]], answers[fleet.eps[1]]
    assert port_answer == jax_answer
    code, retry_after, remaining, connection = port_answer
    assert code == 503 and connection == "close"
    assert float(retry_after) <= 2.0 and float(remaining) == 2.0
    fleet.rsrv.httpd.begin_drain()
    try:
        code, retry_after, remaining, connection = _refusal(fleet.rport)
    finally:
        fleet.rsrv.httpd.draining = False
    assert (code, connection) == (503, "close")
    assert float(retry_after) <= 2.0 and float(remaining) == 2.0


def test_router_cli_banner_and_drain(fleet):
    """``python -m horovod_tpu_torch.serve.router --endpoints ...``: the
    banner names the port, ``/healthz`` lists the endpoints, SIGTERM
    drains and exits 0."""
    import os
    import signal
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serve.router",
         "--endpoints", ",".join(fleet.eps), "--port", "0"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        banner = proc.stdout.readline()
        assert "hvdroute: listening on :" in banner, proc.stderr.read()
        port = int(banner.split("listening on :")[1].split()[0])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["total"] == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_router_exports_metrics_and_traces_the_hop():
    """The router's ``/metrics`` families, and a traced request's
    ``route`` span under the router's ``http-handle`` root, as the JAX
    router emits them."""
    from horovod_tpu_torch.obs import tracing as tr
    tracer = tr.install(tr.Tracer(sample=1.0))
    r = Router([EP0, EP1], config=_fast_config(PKGS["port"]))
    _stub(r, {EP0: (200, {}, _OK_BODY), EP1: (200, {}, _OK_BODY)})
    server = RouterServer(r)
    port = server.start(port=0, host="127.0.0.1")
    try:
        status, headers, _ = _post(port, {"tokens": [1, 2, 3]},
                                   {"X-Trace-Id": "abcdabcdabcdabcd"})
        assert status == 200 and headers["X-Trace-Id"] == "abcdabcdabcdabcd"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            text = resp.read().decode()
        assert 'hvd_route_requests_total{outcome="ok"} 1' in text
        assert "hvd_route_endpoint_admitted" in text
        (trace,) = [t for t in tracer.recent_traces()
                    if t["trace_id"] == "abcdabcdabcdabcd"]
        (root,) = trace["tree"]
        assert (root["name"], root["proc"]) == ("http-handle", "router")
        assert [c["name"] for c in root["children"]] == ["route"]
    finally:
        server.stop()
        tr.uninstall()


def test_listen_backlog_takes_a_burst_of_connections():
    """The port's listeners queue 128 connections where the JAX
    package's (``socketserver``'s default) queue 5: a burst of 32
    connects completes at once, none waits out a dropped SYN's 1 s
    retransmit, before a single one is accepted."""
    import socket
    from http.server import BaseHTTPRequestHandler

    from horovod_tpu.serve.server import \
        DrainingThreadingHTTPServer as JaxListener
    from horovod_tpu_torch.serve.server import DrainingThreadingHTTPServer
    assert JaxListener.request_queue_size == 5
    httpd = DrainingThreadingHTTPServer(("127.0.0.1", 0),
                                        BaseHTTPRequestHandler)
    socks = []
    try:
        # No serve_forever: nothing accepts, the backlog holds them all.
        for _ in range(32):
            socks.append(socket.create_connection(httpd.server_address,
                                                  timeout=0.5))
        assert len(socks) == 32
    finally:
        for s in socks:
            s.close()
        httpd.server_close()
