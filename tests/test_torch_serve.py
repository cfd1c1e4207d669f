"""The port's serving engine and HTTP server against the JAX package's.

Both engines serve the same weights (made with numpy from a seed, flax
tree converted by ``params_from_jax``) with ``block_tokens=8`` and a
prefill chunk of 5, deliberately unaligned with the block size, as
``tests/test_paged_attention.py`` sets them up.  The JAX engine runs its
gather path on the CPU; the port runs its plain paged attention on the
CPU.  Greedy token streams must be identical, at prompt lengths that
straddle block boundaries (k·BT, k·BT±1), for native and int8 KV
blocks.  Inside the port: batched == single, pool-exhaustion preemption
and poisoned-batch recovery still answer exactly, and the HTTP server
answers ``/generate``, ``/healthz`` and ``/metrics`` and refuses, with
400, the request fields whose modules are not ported yet and the
sampling fields ``validate_params`` refuses.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.serve import InferenceEngine as JaxEngine
from horovod_tpu.serve import TransformerAdapter as JaxAdapter
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      params_from_jax)
from horovod_tpu_torch.serve import (InferenceEngine, Request, ServeServer,
                                     TransformerAdapter, build_replicas)
from horovod_tpu_torch.serve.engine import _Seq

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BT = 8
VOCAB = 61
_JTINY = jt.TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, max_len=64, causal=True,
                              dtype=jnp.float32, scan_layers=False)
_TTINY = TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                           d_model=32, d_ff=64, max_len=64,
                           dtype=torch.float32)


def _flax_params(seed=0):
    """The flax tree of the tiny model with every leaf drawn by numpy
    (wider than GPT-2's init, so greedy streams are not constant)."""
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


def _port_engine(model, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_chunk", 5)
    ad = TransformerAdapter(_TTINY, model, block_tokens=BT, device="cpu",
                            kv_dtype=kw.pop("kv_dtype", None))
    return InferenceEngine(ad, replica_id="port", **kw)


def _greedy(model, prompt, n):
    """Full-sequence recompute with the dense ``Transformer``."""
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = model(torch.tensor([seq]))
            seq.append(int(logits[0, -1].argmax()))
    return seq[len(prompt):]


def _prompt(n, seed=None):
    return np.random.RandomState(n if seed is None else seed).randint(
        0, VOCAB, (n,)).tolist()


# -- the port's engine against the JAX engine ----------------------------------

@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_greedy_streams_match_jax_engine(weights, kv_dtype):
    params, model = weights
    jeng = JaxEngine(JaxAdapter(_JTINY, params, block_tokens=BT,
                                attn_impl="gather", kv_dtype=kv_dtype),
                     kv_mode="paged", max_batch=4, prefill_chunk=5,
                     replica_id="jax").start()
    peng = _port_engine(model, kv_dtype=kv_dtype).start()
    try:
        streams = []
        for plen in (BT - 1, BT, BT + 1, 2 * BT, 2 * BT + 1, 3):
            prompt = _prompt(plen)
            want = jeng.generate(prompt, max_new_tokens=5)
            got = peng.generate(prompt, max_new_tokens=5)
            assert got == want, f"plen={plen}"
            if kv_dtype == "native":
                assert got == _greedy(model, prompt, 5), f"plen={plen}"
            streams.append(got)
        assert len({t for s in streams for t in s}) > 3
    finally:
        jeng.stop()
        peng.stop()


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_prompt_logits_match_jax_adapter(weights, kv_dtype):
    """Final-position logits through the whole paged pipeline (storage
    quantization included) on a throwaway pool."""
    params, model = weights
    jad = JaxAdapter(_JTINY, params, block_tokens=BT, attn_impl="gather",
                     kv_dtype=kv_dtype)
    pad = TransformerAdapter(_TTINY, model, block_tokens=BT, device="cpu",
                             kv_dtype=kv_dtype)
    for plen in (3, 2 * BT + 1):
        prompt = _prompt(plen, seed=50 + plen)
        np.testing.assert_allclose(pad.prompt_logits(prompt),
                                   jad.prompt_logits(prompt),
                                   rtol=1e-4, atol=1e-5)


def test_batched_equals_single(weights):
    _, model = weights
    eng = _port_engine(model, max_batch=8).start()
    try:
        prompts = [_prompt(3 + (i * 5) % (2 * BT), seed=i) for i in range(8)]
        singles = [eng.generate(p, max_new_tokens=5) for p in prompts]
        results = [None] * len(prompts)

        def run(i):
            results[i] = eng.generate(prompts[i], max_new_tokens=5)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert results == singles
        assert eng.metrics.snapshot()["occupancy"]["max"] > 1
    finally:
        eng.stop()


def test_pool_exhaustion_preempts_youngest_and_answers_exactly(weights):
    """Two hand-built decoding sequences overcommit a 2-block pool: the
    youngest is preempted (requeued at the front, progress reset); once
    the engine runs, it is served from its prompt and answers exactly."""
    _, model = weights
    eng = _port_engine(model, num_blocks=2, prefill_chunk=64)
    old_req = Request([1] * BT, max_new_tokens=4)
    old_req.generated = [5]
    young_prompt = _prompt(BT, seed=77)
    young_req = Request(young_prompt, max_new_tokens=4)
    young_req.generated = [7]
    old = _Seq(old_req, 0, eng.blocks.allocate(2), [], admit_seq=0)
    old.length = old.prompt_pos = BT
    young = _Seq(young_req, 0, [], [], admit_seq=1)
    young.length = young.prompt_pos = BT
    eng._slots[0], eng._slots[1] = old, young
    eng._decode_once_paged()
    assert eng._slots[1] is None
    assert young_req.generated == [] and young_req.requeues == 1
    assert eng.batcher.depth() == 1
    assert eng.metrics.snapshot()["requests"]["preempted"] == 1
    assert len(old_req.generated) == 2
    eng.start()
    try:
        assert young_req.result(timeout=60) == _greedy(model, young_prompt, 4)
        old_req.result(timeout=60)
        assert eng.kv_stats()["used"] == 0
    finally:
        eng.stop()


def test_poisoned_batch_recovery_keeps_serving(weights):
    """A failed decode step fails its requests with the real error, frees
    only their blocks (the prefix registry survives) and the engine
    keeps answering exactly."""
    _, model = weights
    eng = _port_engine(model, prefill_chunk=64)
    inner = eng.adapter.decode_paged
    armed = {"on": False}

    def decode_paged(*args):
        if armed["on"]:
            armed["on"] = False
            raise RuntimeError("simulated device fault")
        return inner(*args)

    eng.adapter.decode_paged = decode_paged
    eng.start()
    try:
        shared = _prompt(2 * BT, seed=5)
        warm = eng.generate(shared + [3], max_new_tokens=4)
        assert warm == _greedy(model, shared + [3], 4)
        armed["on"] = True
        doomed = Request(shared + [9], max_new_tokens=8)
        eng.batcher.submit(doomed)
        with pytest.raises(RuntimeError, match="simulated device fault"):
            doomed.result(timeout=30)
        stats = eng.kv_stats()
        assert stats["used"] == 0 and stats["retained"] > 0
        assert eng.generate(shared + [3], max_new_tokens=4) == warm
        assert eng.metrics.snapshot()["requests"]["error"] == 1
    finally:
        eng.stop()


def test_copy_block_copies_every_layer_in_place(weights):
    _, model = weights
    ad = TransformerAdapter(_TTINY, model, block_tokens=BT, device="cpu",
                            kv_dtype="int8")
    pool = ad.init_paged_cache(4, 2)
    assert set(pool) == {"k", "v", "k_scale", "v_scale"}
    for a in pool.values():
        a[:, 1] = torch.arange(a[:, 1].numel()).reshape(
            a[:, 1].shape).to(a.dtype)
    ptrs = {k: a.data_ptr() for k, a in pool.items()}
    out = ad.copy_block(pool, 1, 3)
    for k, a in out.items():
        assert a.data_ptr() == ptrs[k]
        assert torch.equal(a[:, 3], a[:, 1])
    assert ad.paged_block_bytes() == 2 * 2 * BT * 2 * (16 + 2)


# -- the HTTP server -------------------------------------------------------------

@pytest.fixture(scope="module")
def server(weights):
    _, model = weights
    sched = build_replicas(
        lambda: TransformerAdapter(_TTINY, model, block_tokens=BT,
                                   device="cpu"),
        num_replicas=1, max_batch=4, prefill_chunk=5)
    srv = ServeServer(sched)
    port = srv.start(port=0, host="127.0.0.1")
    yield port
    srv.stop()


def _http(port, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_server_generate_healthz_metrics(server, weights):
    _, model = weights
    prompt = _prompt(BT + 1, seed=11)
    body = {"tokens": prompt, "max_new_tokens": 4}
    code1, r1 = _http(server, "/generate", body)
    code2, r2 = _http(server, "/generate", body)
    assert code1 == code2 == 200
    r1, r2 = json.loads(r1), json.loads(r2)
    assert r1["tokens"] == r2["tokens"] == _greedy(model, prompt, 4)
    assert r1["finish_reason"] == "length"
    assert r1["usage"]["completion_tokens"] == 4
    code, health = _http(server, "/healthz")
    health = json.loads(health)
    assert code == 200 and health["status"] == "ok"
    rep = health["replicas"][0]
    assert (rep["kv_mode"], rep["attn_impl"], rep["kv_dtype"]) == \
        ("paged", "gather", "native")
    assert rep["kv_blocks"]["used"] == 0
    code, text = _http(server, "/metrics")
    assert code == 200
    for family in ("hvd_serve_ttft_ms_bucket", "hvd_serve_ttft_ms_count",
                   "hvd_serve_token_step_ms_count", "hvd_serve_tokens_total",
                   'hvd_serve_requests_total{outcome="ok"',
                   "hvd_serve_batch_occupancy_max",
                   "hvd_serve_prefill_tokens_total",
                   "hvd_serve_decode_tokens_total", "hvd_serve_kv_blocks",
                   "hvd_serve_kv_bytes_per_token",
                   "hvd_serve_prefix_cache_hit_rate",
                   'hvd_serve_attention_impl{replica="replica-0",'
                   'impl="gather"}',
                   "hvd_serve_kv_dtype"):
        assert family in text, family


_UNPORTED = "not supported"


@pytest.mark.parametrize("body,headers,path,missing,why", [
    ({"stream": True}, None, "/generate", "stream", _UNPORTED),
    ({}, {"Accept": "text/event-stream"}, "/generate", "stream", _UNPORTED),
    ({"schema": {"type": "integer"}}, None, "/generate", "schema",
     _UNPORTED),
    ({"logprobs": 2}, None, "/generate", "logprobs", _UNPORTED),
    ({"temperature": -0.7, "seed": 1}, None, "/generate", "temperature",
     ">= 0"),
    ({"n": 2.5, "temperature": 0.7}, None, "/generate", "n",
     "must be an integer"),
    ({"n": 0}, None, "/generate", "n", ">= 1"),
    ({"model": "other"}, None, "/generate", "model", _UNPORTED),
    ({}, None, "/score", "/score", _UNPORTED),
], ids=["stream", "accept-sse", "schema", "logprobs", "temperature",
        "n-sampled", "n", "model", "score"])
def test_unported_fields_get_400(server, body, headers, path, missing, why):
    """Fields whose modules are not ported answer 400 naming the
    feature; the sampling fields are served now, so their cases send a
    value ``validate_params`` refuses and get the 400 naming the
    field."""
    payload = {"tokens": [1, 2, 3], "max_new_tokens": 2, **body}
    code, text = _http(server, path, payload,
                       {"Content-Type": "application/json",
                        **(headers or {})})
    assert code == 400, text
    err = json.loads(text)["error"]
    assert missing in err and why in err


def test_mark_dead_fails_over_and_mark_alive_readmits(weights):
    """A dead replica leaves routing (healthz degraded) and requests are
    served exactly by the survivor; mark_alive re-admits it."""
    _, model = weights
    sched = build_replicas(
        lambda: TransformerAdapter(_TTINY, model, block_tokens=BT,
                                   device="cpu"),
        num_replicas=2, max_batch=2, prefill_chunk=5).start()
    try:
        prompt = _prompt(BT + 1, seed=21)
        sched.mark_dead("replica-0", reason="test")
        health = sched.healthz()
        assert (health["status"], health["healthy"]) == ("degraded", 1)
        reqs = [Request(prompt, max_new_tokens=3) for _ in range(3)]
        for r in reqs:
            assert sched.submit(r).replica_id == "replica-1"
        want = _greedy(model, prompt, 3)
        assert [r.result(timeout=60) for r in reqs] == [want] * 3
        sched.mark_alive("replica-0")
        assert sched.healthz()["status"] == "ok"
        r = Request(prompt, max_new_tokens=3)
        sched.submit(r)
        assert r.result(timeout=60) == want
        assert sched.metrics.snapshot()["replica_events"] == {
            "mark_dead": 1, "mark_alive": 1}
    finally:
        sched.stop()


@pytest.mark.parametrize("fields", [
    (0.0, None, 1.0, 1, 5), (0.7, 40, 0.9, 2, 7), (1, 3.0, 1, 1.0, 0),
    (-1.0, None, 1.0, 1, 1), (0.5, 0, 1.0, 1, 1), (0.5, None, 0.0, 1, 1),
    (0.5, None, 1.0, 0, 1), (True, None, 1.0, 1, 1), (0.5, None, 1.0, 1, 1.5),
], ids=lambda f: repr(f))
def test_validate_params_matches_jax(fields):
    """The copied ``/generate`` field validation gives JAX's result or
    JAX's error."""
    from horovod_tpu.serve import sampling as jax_sampling
    from horovod_tpu_torch.serve import sampling as port_sampling

    def call(mod):
        try:
            return mod.validate_params(*fields)
        except ValueError as e:
            return f"ValueError: {e}"

    assert call(port_sampling) == call(jax_sampling)


def test_cli_needs_a_card_unless_told(monkeypatch):
    from horovod_tpu_torch.serve.server import run_commandline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_commandline(["--model", "gpt2-small", "--port", "0"])


def test_cli_serves_gpt2_small_on_cpu():
    """``python -m horovod_tpu_torch.serve --model gpt2-small --device
    cpu --port 0``: the banner names the port, ``/generate`` answers, and
    SIGTERM drains and exits 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serve", "--model",
         "gpt2-small", "--device", "cpu", "--port", "0", "--max-len", "64"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                           OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        banner = proc.stdout.readline()
        assert "listening on :" in banner, proc.stderr.read()
        port = int(banner.split("listening on :")[1].split()[0])
        code, text = _http(port, "/generate",
                           {"tokens": [464, 2068, 7586], "max_new_tokens": 2})
        assert code == 200, text
        tokens = json.loads(text)["tokens"]
        assert len(tokens) == 2 and all(0 <= t < 50257 for t in tokens)
        code, health = _http(port, "/healthz")
        assert json.loads(health)["replicas"][0]["kv_mode"] == "paged"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_cli_factory_builds_an_f32_model(monkeypatch):
    """The CLI asks for GPT-2 in f32 by name, as the JAX CLI does
    (``create_gpt2(..., dtype=jnp.float32)``), now that the configs
    compute in bf16 by default: the model it builds and the adapters
    its factory makes carry f32.  One layer at a small vocabulary keeps
    the build cheap; the dtype is the factory's own."""
    import argparse
    from horovod_tpu_torch import models
    from horovod_tpu_torch.serve import server
    real, built = models.create_gpt2, []

    def one_layer(size, **kw):
        built.append(real(size, num_layers=1, vocab_size=97, **kw))
        return built[-1]

    monkeypatch.setattr(models, "create_gpt2", one_layer)
    factory = server._build_adapter_factory(argparse.Namespace(
        model="gpt2-small", device="cpu", seed=0, max_len=64))
    assert models.GPT2_SMALL.dtype == torch.bfloat16
    assert [m.cfg.dtype for m in built] == [torch.float32]
    assert factory().cfg.dtype == torch.float32
