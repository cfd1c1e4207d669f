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
answers ``/generate``, ``/healthz`` and ``/metrics``, and answers the
values the JAX server refuses with the JAX server's status.  The request
surface: ``score_logits`` and ``decode_paged_logits`` against the JAX
adapter's, logprob entries, grammar-constrained greedy output and the
EOS stop (greedy, speculative, n > 1) against the JAX engine's, and the
CLI's ``--checkpoint``.
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
from horovod_tpu_torch.serve import (InferenceEngine, Request, ServeMetrics,
                                     ServeServer, TransformerAdapter,
                                     build_replicas)
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


@pytest.fixture(scope="module")
def jax_server(weights):
    """The JAX package's server over the same weights, for the status
    every refused request must share."""
    from horovod_tpu.serve import Replica as JaxReplica
    from horovod_tpu.serve import ReplicaScheduler as JaxScheduler
    from horovod_tpu.serve import ServeServer as JaxServer
    params, _ = weights
    eng = JaxEngine(JaxAdapter(_JTINY, params, block_tokens=BT,
                               attn_impl="gather"),
                    kv_mode="paged", max_batch=4, prefill_chunk=5,
                    replica_id="replica-0")
    srv = JaxServer(JaxScheduler([JaxReplica("replica-0", None, eng)]))
    port = srv.start(port=0, host="127.0.0.1")
    yield port
    srv.stop()


@pytest.mark.parametrize("body,headers,path,missing,why", [
    ({"stream": True, "max_new_tokens": 100}, None, "/generate",
     "max_len", "exceeds"),
    ({"max_new_tokens": 100}, {"Accept": "text/event-stream"},
     "/generate", "max_len", "exceeds"),
    ({"schema": {"anyOf": [{"type": "boolean"}]}, "eos_id": 0}, None,
     "/generate", "anyOf", "unsupported"),
    ({"logprobs": 0}, None, "/generate", "logprobs", "[1, 16]"),
    ({"temperature": -0.7, "seed": 1}, None, "/generate", "temperature",
     ">= 0"),
    ({"n": 2.5, "temperature": 0.7}, None, "/generate", "n",
     "must be an integer"),
    ({"n": 0}, None, "/generate", "n", ">= 1"),
    ({"model": "other"}, None, "/generate", "'other'", "unknown model"),
    ({"tokens": []}, None, "/score", "tokens", "non-empty"),
], ids=["stream", "accept-sse", "schema", "logprobs", "temperature",
        "n-sampled", "n", "model", "score"])
def test_unported_fields_get_400(server, jax_server, body, headers, path,
                                 missing, why):
    """Every request field the JAX server accepts is served; each case
    sends a value the JAX server refuses and gets its answer, a 400
    naming the field: a stream refused before its first byte (by the
    body flag or the ``Accept`` header) answers the buffered 400, an
    unsupported schema keyword, ``logprobs`` below 1, an unknown model,
    ``/score`` without tokens, and the sampling fields
    ``validate_params`` refuses."""
    payload = {"tokens": [1, 2, 3], "max_new_tokens": 2, **body}
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    code, text = _http(server, path, payload, hdrs)
    jcode, jtext = _http(jax_server, path, payload, hdrs)
    assert code == jcode == 400, (text, jtext)
    for err in (json.loads(text)["error"], json.loads(jtext)["error"]):
        assert missing in err and why in err, err


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


# -- the request surface: host-mode logits, logprobs, grammars, EOS ----------------

def _pools(jad, pad, prompts, nb=16):
    """The same prompts prefilled into a JAX pool and a port pool (one
    chunk each, blocks dealt in order); returns both pools and the
    tables."""
    tables, nxt = [], 0
    for p in prompts:
        need = -(-(len(p) + 2) // BT)
        tables.append(list(range(nxt, nxt + need)))
        nxt += need
    jcache = jad.init_paged_cache(nb, 4)
    pcache = pad.init_paged_cache(nb, 4)
    starts = [0] * len(prompts)
    jcache, _ = jad.prefill_chunk(jcache, prompts, starts, tables)
    pcache, _ = pad.prefill_chunk(pcache, prompts, starts, tables)
    return jcache, pcache, tables


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_score_and_decode_logits_match_jax_adapter(weights, kv_dtype):
    """``score_logits`` (every position, one chunk on a throwaway pool)
    and ``decode_paged_logits`` (the raw rows of a paged decode step,
    inactive rows all holes) against the JAX adapter's."""
    params, model = weights
    jad = JaxAdapter(_JTINY, params, block_tokens=BT, attn_impl="gather",
                     kv_dtype=kv_dtype)
    pad = TransformerAdapter(_TTINY, model, block_tokens=BT, device="cpu",
                             kv_dtype=kv_dtype)
    for n in (1, BT, 2 * BT + 3, 63):
        toks = _prompt(n, seed=90 + n)
        got, want = pad.score_logits(toks), jad.score_logits(toks)
        assert got.shape == (n, VOCAB)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[-1], pad.prompt_logits(toks),
                                   rtol=1e-5, atol=1e-6)
    prompts = [_prompt(n, seed=n) for n in (BT - 1, BT, 2 * BT + 1)]
    jcache, pcache, tables = _pools(jad, pad, prompts)
    tokens = np.array([5, 9, 13, 0])
    positions = np.array([len(p) for p in prompts] + [0])
    tab = np.full((4, pad.max_blocks_per_seq), 16)
    for i, t in enumerate(tables):
        tab[i, :len(t)] = t
    _, got = pad.decode_paged_logits(pcache, tokens, positions, tab)
    _, want = jad.decode_paged_logits(jcache, tokens, positions, tab)
    np.testing.assert_allclose(got[:3], np.asarray(want)[:3], rtol=1e-4,
                               atol=1e-5)


def test_logprob_entries_and_streams_match_jax_engine(weights):
    """Greedy with ``logprobs: 3``: the same tokens as the JAX engine and
    as the same request without logprobs; each entry's logprob within
    the adapters' tolerance, and the same top-3 ids wherever neighbours
    are farther apart than it."""
    params, model = weights
    jeng = JaxEngine(JaxAdapter(_JTINY, params, block_tokens=BT,
                                attn_impl="gather"),
                     kv_mode="paged", max_batch=4, prefill_chunk=5,
                     replica_id="jax").start()
    peng = _port_engine(model).start()
    try:
        from horovod_tpu.serve import Request as JaxRequest
        for plen in (3, BT + 1, 2 * BT):
            prompt = _prompt(plen, seed=200 + plen)
            r, jr = Request(prompt, max_new_tokens=6, logprobs=3), \
                JaxRequest(prompt, max_new_tokens=6, logprobs=3)
            peng.batcher.submit(r)
            jeng.batcher.submit(jr)
            toks, jtoks = r.result(timeout=60), jr.result(timeout=60)
            assert toks == jtoks == peng.generate(prompt, max_new_tokens=6)
            assert len(r.token_logprobs) == len(toks)
            for e, je in zip(r.token_logprobs, jr.token_logprobs):
                assert e["token"] == je["token"]
                assert e["logprob"] == pytest.approx(je["logprob"],
                                                     rel=1e-4, abs=1e-5)
                jt_ = je["top"]
                for k, (a, b) in enumerate(zip(e["top"], jt_)):
                    gaps = [abs(jt_[k]["logprob"] - jt_[j]["logprob"])
                            for j in (k - 1, k + 1) if 0 <= j < len(jt_)]
                    if min(gaps) > 1e-4:
                        assert a["token"] == b["token"]
                    assert a["logprob"] == pytest.approx(
                        b["logprob"], rel=1e-4, abs=1e-5)
    finally:
        jeng.stop()
        peng.stop()


_ENUM = {"enum": [12, 345, -7, 60]}


def test_grammar_greedy_matches_jax_engine_and_sampled_stays_valid(weights):
    """The tiny model's vocabulary (61 < 256) has token strings, so a
    schema'd request decodes there: greedy output is the JAX engine's,
    token for token, with its finish reason; sampled output always
    parses into the enum."""
    from horovod_tpu.serve import Request as JaxRequest
    params, model = weights
    jeng = JaxEngine(JaxAdapter(_JTINY, params, block_tokens=BT,
                                attn_impl="gather"),
                     kv_mode="paged", max_batch=4, prefill_chunk=5,
                     replica_id="jax").start()
    peng = _port_engine(model).start()
    try:
        for plen in (3, BT + 1):
            prompt = _prompt(plen, seed=300 + plen)
            r = Request(prompt, max_new_tokens=8, eos_id=0, schema=_ENUM)
            jr = JaxRequest(prompt, max_new_tokens=8, eos_id=0,
                            schema=_ENUM)
            peng.batcher.submit(r)
            jeng.batcher.submit(jr)
            assert r.result(timeout=60) == jr.result(timeout=60)
            assert r.finish_reason == jr.finish_reason
        for seed in range(6):
            r = Request(_prompt(5, seed=seed), max_new_tokens=8, eos_id=0,
                        schema=_ENUM, temperature=1.0, seed=seed)
            peng.batcher.submit(r)
            toks = [t for t in r.result(timeout=60) if t != 0]
            assert json.loads("".join(chr(t) for t in toks)) in \
                _ENUM["enum"]
    finally:
        jeng.stop()
        peng.stop()


def test_schema_on_a_vocabulary_without_token_strings_answers_as_jax():
    """GPT-2's vocabulary (over 256 tokens) has no token strings in
    either package: a schema'd request is refused, and the server's
    answer is JAX's — a buffered 400 when streamed (refused before the
    first byte), a 500 when buffered (an engine-side failure)."""
    from horovod_tpu.serve import Replica as JaxReplica
    from horovod_tpu.serve import ReplicaScheduler as JaxScheduler
    from horovod_tpu.serve import ServeServer as JaxServer
    jcfg = jt.TransformerConfig(vocab_size=300, num_layers=1, num_heads=2,
                                d_model=32, d_ff=64, max_len=64, causal=True,
                                dtype=jnp.float32, scan_layers=False)
    tcfg = TransformerConfig(vocab_size=300, num_layers=1, num_heads=2,
                             d_model=32, d_ff=64, max_len=64,
                             dtype=torch.float32)
    params = jt.Transformer(jcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    pad = TransformerAdapter(tcfg, params_from_jax(jax.device_get(params)),
                             block_tokens=BT, device="cpu")
    assert pad.token_strings() is None
    psrv = ServeServer(build_replicas(lambda: pad, num_replicas=1,
                                      max_batch=2))
    jsrv = JaxServer(JaxScheduler([JaxReplica("replica-0", None, JaxEngine(
        JaxAdapter(jcfg, params, block_tokens=BT, attn_impl="gather"),
        kv_mode="paged", max_batch=2))]))
    ports = (psrv.start(port=0, host="127.0.0.1"),
             jsrv.start(port=0, host="127.0.0.1"))
    try:
        body = {"tokens": [1, 2], "max_new_tokens": 4, "eos_id": 0,
                "schema": {"type": "boolean"}}
        hdrs = {"Content-Type": "application/json"}
        for stream, want in ((True, 400), (False, 500)):
            got = [_http(p, "/generate", dict(body, stream=stream), hdrs)
                   for p in ports]
            assert [c for c, _ in got] == [want, want], got
            for _, text in got:
                assert "token strings" in json.loads(text)["error"]
    finally:
        psrv.stop()
        jsrv.stop()


def _aligned_flax(params):
    """The tiny model with block 1's output projections at zero: the
    one-block draft then agrees with the target, so speculation accepts
    runs of drafts."""
    aligned = jax.tree_util.tree_map(np.array, params)
    for leaf in (("attn", "proj", "kernel"), ("attn", "proj", "bias"),
                 ("fc2", "kernel"), ("fc2", "bias")):
        node = aligned["block_1"]
        for k in leaf[:-1]:
            node = node[k]
        node[leaf[-1]] = np.zeros_like(node[leaf[-1]])
    return aligned


@pytest.mark.parametrize("spec", [False, True], ids=["greedy", "spec"])
def test_eos_stop_matches_jax_greedy_chain(weights, spec):
    """The EOS stop, pinned: the port's answer with ``eos_id`` is the JAX
    adapter's greedy chain cut at the first EOS, inclusive, with finish
    reason ``stop`` — plain and speculative (k = 4 on the aligned model,
    so the EOS falls inside a run of accepted drafts)."""
    params, _ = weights
    params = _aligned_flax(params) if spec else params
    state = params_from_jax(params)
    jeng = JaxEngine(JaxAdapter(_JTINY, params, block_tokens=BT,
                                attn_impl="gather"),
                     kv_mode="paged", max_batch=4, prefill_chunk=5,
                     replica_id="jax").start()
    peng = InferenceEngine(
        TransformerAdapter(_TTINY, state, block_tokens=BT, device="cpu",
                           draft_layers=1 if spec else 0),
        max_batch=4, prefill_chunk=5, spec_k=4 if spec else 0,
        metrics=ServeMetrics(), replica_id="port").start()
    try:
        cut_inside = 0
        for plen in (3, BT, 2 * BT + 1):
            prompt = _prompt(plen, seed=400 + plen)
            chain = jeng.generate(prompt, max_new_tokens=12)
            for at in (0, 3, 7):
                eos = chain[at]
                want = chain[:chain.index(eos) + 1]
                r = Request(prompt, max_new_tokens=12, eos_id=eos)
                peng.batcher.submit(r)
                assert r.result(timeout=60) == want, (plen, at)
                assert r.finish_reason == "stop"
                cut_inside += len(want) > 2
        assert cut_inside
        if spec:
            snap = peng.metrics.snapshot()["spec"]
            assert snap["accepted"] > 0 and snap["rejected"] == 0
    finally:
        jeng.stop()
        peng.stop()


def test_eos_stops_each_fork_on_its_own_stream(weights):
    """An n = 3 sampled family whose members stop at different positions:
    each member is its chain without ``eos_id`` cut at its own first
    EOS, inclusive — the rule the JAX engine keeps for its members."""
    from horovod_tpu.serve import Request as JaxRequest
    params, model = weights
    jeng = JaxEngine(JaxAdapter(_JTINY, params, block_tokens=BT,
                                attn_impl="gather"),
                     kv_mode="paged", max_batch=4, prefill_chunk=5,
                     replica_id="jax").start()
    peng = _port_engine(model).start()
    try:
        prompt = _prompt(BT + 2, seed=501)
        for eng, req in ((peng, Request), (jeng, JaxRequest)):
            free = req(prompt, max_new_tokens=10, n=3, temperature=1.0,
                       seed=11)
            eng.batcher.submit(free)
            free.result(timeout=60)
            samples = free.samples

            def stops(eos):
                return [s.index(eos) + 1 if eos in s else len(s)
                        for s in samples]

            eos = next(t for s in samples for t in s
                       if len(set(stops(t))) > 1)
            r = req(prompt, max_new_tokens=10, n=3, temperature=1.0,
                    seed=11, eos_id=eos)
            eng.batcher.submit(r)
            r.result(timeout=60)
            assert [len(s) for s in r.samples] == stops(eos)
            assert r.samples == [s[:k] for s, k in zip(samples,
                                                       stops(eos))]
            assert r.generated == r.samples[0]
    finally:
        jeng.stop()
        peng.stop()


def test_cli_checkpoint_serves_the_saved_weights(monkeypatch, tmp_path,
                                                 weights):
    """``--checkpoint``: the factory serves the parameters of a
    ``checkpoint.save_model`` directory (or of the JAX tree written with
    ``checkpoint.save``) with ``prompt_logits`` equal, bit for bit, to
    the in-memory model's."""
    import argparse
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, models
    from horovod_tpu_torch.serve import server
    params, model = weights
    monkeypatch.setattr(models, "GPT2_SMALL", _TTINY)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        checkpoint.save_model(str(tmp_path / "port"), model)
        checkpoint.save(str(tmp_path / "jax"), jax.tree_util.tree_map(
            torch.from_numpy, params))
    finally:
        hvd.shutdown()
    want = TransformerAdapter(_TTINY, model, block_tokens=16,
                              device="cpu").prompt_logits(list(range(20)))
    for name in ("port", "jax"):
        factory = server._build_adapter_factory(argparse.Namespace(
            model="gpt2-small", device="cpu", seed=0, max_len=64,
            checkpoint=str(tmp_path / name)))
        got = factory().prompt_logits(list(range(20)))
        assert np.array_equal(got, want), name


def test_cli_checkpoint_replicas_share_one_weight_copy(monkeypatch,
                                                       tmp_path, weights):
    """``--checkpoint``: every adapter the factory makes (one a replica)
    serves views of ONE f32 copy of the loaded weights, a checkpoint
    saved in bf16 too (served in f32, as the JAX CLI serves)."""
    import argparse
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, models
    from horovod_tpu_torch.serve import server
    _, model = weights
    monkeypatch.setattr(models, "GPT2_SMALL", _TTINY)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        checkpoint.save_model(str(tmp_path / "f32"), model)
        checkpoint.save(str(tmp_path / "bf16"), {
            k: v.detach().bfloat16() for k, v in model.state_dict().items()})
    finally:
        hvd.shutdown()
    for name in ("f32", "bf16"):
        factory = server._build_adapter_factory(argparse.Namespace(
            model="gpt2-small", device="cpu", seed=0, max_len=64,
            checkpoint=str(tmp_path / name)))
        a, b = factory(), factory()
        for get in (lambda p: p["wte"], lambda p: p["blocks"][0]["qkv_w"],
                    lambda p: p["blocks"][-1]["fc2_w"]):
            ta, tb = get(a.params), get(b.params)
            assert ta.dtype == torch.float32, name
            assert ta.data_ptr() == tb.data_ptr(), name
        assert a.prompt_logits([1, 2, 3]).dtype == np.float32
