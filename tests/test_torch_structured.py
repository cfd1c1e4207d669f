"""The port's grammar-constrained decoding (``serve/structured.py``),
per-token logprobs and ``/score`` against the JAX package's
(``tests/test_structured.py``, every case).

``structured.py`` is a copy, so its grammars are held to JAX's own: the
same ``allowed_mask`` bits at every state of seeded walks.  The engines
serve a byte-vocabulary MLP (vocab 256: token ids ARE character codes)
whose weights are the JAX MLP's, converted by ``mlp_params_from_jax``;
greedy schema'd and logprob'd answers are held token for token to the
JAX engine's, logprob entries within rtol 1e-5, and sampled schema'd
answers by validity (the port draws with its own keys).
"""

import http.client
import json
import math
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import create_mlp as jax_create_mlp
from horovod_tpu.serve import InferenceEngine as JaxEngine
from horovod_tpu.serve import MLPAdapter as JaxMLPAdapter
from horovod_tpu.serve import Request as JaxRequest
from horovod_tpu.serve.structured import TokenGrammar as JaxGrammar
from horovod_tpu_torch.models import create_mlp, mlp_params_from_jax
from horovod_tpu_torch.serve import (InferenceEngine, MLPAdapter, Replica,
                                     ReplicaScheduler, Request, ServeMetrics,
                                     ServeServer)
from horovod_tpu_torch.serve.streaming import parse_sse
from horovod_tpu_torch.serve.structured import TokenGrammar, parse_schema

torch.set_num_threads(2)

EOS = 0
BYTE_VOCAB = [chr(i) for i in range(128)]


# -- harness -------------------------------------------------------------------

def _mlp_pair(seed=3, max_len=512):
    """The byte-vocabulary MLP adapter of the port and of JAX, on the
    same (converted) weights."""
    vocab = 256
    jmlp = jax_create_mlp(features=(16, vocab))
    params = jmlp.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, vocab)))["params"]
    mlp = create_mlp((16, vocab), in_features=vocab, device="cpu",
                     seed=None)
    mlp.load_state_dict(mlp_params_from_jax(jax.device_get(params)))
    return (MLPAdapter(mlp, vocab_size=vocab, max_len=max_len),
            JaxMLPAdapter(jmlp, params, vocab_size=vocab, max_len=max_len))


def _mlp256():
    return _mlp_pair()[0]


def _paged_engine(adapter=None, **kw):
    kw.setdefault("max_batch", 4)
    return InferenceEngine(adapter or _mlp256(), kv_mode="paged",
                           metrics=ServeMetrics(),
                           replica_id="structured-t", **kw)


def _run(eng, prompt, req=Request, **req_kw):
    r = req(prompt, **req_kw)
    eng.batcher.submit(r)
    toks = r.result(timeout=60)
    return r, toks


def _doc(tokens):
    """A byte-vocabulary completion as text, a trailing EOS dropped."""
    toks = list(tokens)
    while toks and toks[-1] == EOS:
        toks.pop()
    return bytes(toks).decode()


def _server(adapter_fn=_mlp256, n=1):
    replicas = [Replica(f"replica-{i}", None, _paged_engine(adapter_fn()))
                for i in range(n)]
    sched = ReplicaScheduler(replicas, metrics=replicas[0].engine.metrics)
    server = ServeServer(sched, request_timeout_s=60)
    port = server.start(port=0, host="127.0.0.1")
    return server, sched, port


def _post(port, payload, path="/generate", timeout=30):
    body = json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _stream_events(port, payload, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/generate",
                     body=json.dumps(payload).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        raw = b""
        while True:
            chunk = resp.read1(8192)
            if not chunk:
                break
            raw += chunk
            cut = raw.rfind(b"\n\n")
            events = parse_sse(raw[:cut + 2]) if cut >= 0 else []
            if events and events[-1][0] in ("done", "error"):
                return events
        return parse_sse(raw)
    finally:
        conn.close()


# -- parse_schema: the supported subset, loudly bounded --------------------------

@pytest.mark.parametrize("schema,needle", [
    ({"anyOf": [{"type": "string"}]}, "anyOf"),
    ({"type": "object", "patternProperties": {}}, "patternProperties"),
    ({"type": "string", "minLength": 3}, "minLength"),
    ({"type": "tuple"}, "unsupported type"),
    ({"type": "object", "additionalProperties": True},
     "additionalProperties"),
    ({"type": "array"}, "items"),
    ({"type": "array", "items": {"type": "integer"}, "minItems": 5,
      "maxItems": 2}, "maxItems"),
    ({"type": "object", "properties": {}, "required": ["ghost"]},
     "ghost"),
    ({"const": True, "type": "boolean"}, "const"),
    ({"enum": []}, "enum"),
    (True, "boolean"),
    ([1, 2], "JSON object"),
])
def test_parse_schema_names_the_unsupported_piece(schema, needle):
    with pytest.raises(ValueError, match=needle):
        parse_schema(schema)


def test_parse_schema_accepts_the_documented_subset():
    parse_schema({"type": "object",
                  "properties": {"a": {"type": "integer"}},
                  "required": ["a"], "additionalProperties": False})
    parse_schema({"type": "array", "items": {"type": "number"},
                  "minItems": 1, "maxItems": 4})
    for t in ("string", "number", "integer", "boolean", "null"):
        parse_schema({"type": t})
    parse_schema({"enum": ["red", 3, None]})
    parse_schema({"const": {"x": 1}})


# -- TokenGrammar: masked walks spell conforming documents ------------------------

def _constrained_walk(g, rng, max_steps=2000, jax_g=None):
    """A random walk honoring ``allowed_mask``, ending on ``exhausted``
    or on EOS where the mask admits it; returns the tokens (EOS
    excluded).  With ``jax_g``, JAX's grammar walks the same tokens and
    its mask must equal the port's at every state."""
    state, toks = g.start, []
    jstate = jax_g.start if jax_g is not None else None
    for _ in range(max_steps):
        mask = g.allowed_mask(state)
        if jax_g is not None:
            assert np.array_equal(mask, jax_g.allowed_mask(jstate)), toks
            assert g.exhausted(state) == jax_g.exhausted(jstate)
            assert g.accepting(state) == jax_g.accepting(jstate)
        if g.exhausted(state):
            return toks
        if mask[g.eos_id] and rng.rand() < 0.6:
            return toks  # EOS is only maskable at accepting states
        allowed = np.flatnonzero(mask)
        allowed = allowed[allowed != g.eos_id]
        assert allowed.size, "live non-exhausted state with no moves"
        tok = int(allowed[rng.randint(0, allowed.size)])
        toks.append(tok)
        state = g.advance_token(state, tok)
        assert state, "mask admitted a killing token"
        if jax_g is not None:
            jstate = jax_g.advance_token(jstate, tok)
    raise AssertionError("walk did not terminate")


def _validate(doc, schema):
    t = schema.get("type")
    if "const" in schema:
        assert doc == schema["const"]
    elif "enum" in schema:
        assert doc in schema["enum"]
    elif t == "object":
        assert isinstance(doc, dict)
        assert set(doc) <= set(schema.get("properties", {}))
        for name in schema.get("required", []):
            assert name in doc
        for name, sub in schema.get("properties", {}).items():
            if name in doc:
                _validate(doc[name], sub)
    elif t == "array":
        assert isinstance(doc, list)
        assert len(doc) >= schema.get("minItems", 0)
        if "maxItems" in schema:
            assert len(doc) <= schema["maxItems"]
        for item in doc:
            _validate(item, schema["items"])
    elif t == "string":
        assert isinstance(doc, str)
    elif t == "integer":
        assert isinstance(doc, int) and not isinstance(doc, bool)
    elif t == "number":
        assert isinstance(doc, (int, float)) and not isinstance(doc, bool)
    elif t == "boolean":
        assert isinstance(doc, bool)
    elif t == "null":
        assert doc is None


@pytest.mark.parametrize("schema", [
    {"type": "object",
     "properties": {"a": {"type": "integer"},
                    "b": {"type": "boolean"},
                    "c": {"type": "string"}},
     "required": ["a"], "additionalProperties": False},
    {"type": "array", "items": {"type": "integer"},
     "minItems": 1, "maxItems": 3},
    {"type": "array", "items": {"type": "boolean"}, "minItems": 0,
     "maxItems": 2},
    {"type": "string"},
    {"type": "number"},
    {"type": "integer"},
    {"type": "boolean"},
    {"type": "null"},
    {"enum": ["red", "green", 3]},
    {"const": {"x": 1, "y": [True]}},
], ids=["object", "array", "array-empty-ok", "string", "number",
        "integer", "boolean", "null", "enum", "const"])
def test_grammar_masked_walks_spell_conforming_documents(schema):
    """Every walk spells a conforming document, and JAX's grammar gives
    the same mask bits at every state along it."""
    g = TokenGrammar(schema, BYTE_VOCAB, eos_id=EOS)
    jg = JaxGrammar(schema, BYTE_VOCAB, eos_id=EOS)
    rng = np.random.RandomState(7)
    for _ in range(20):
        toks = _constrained_walk(g, rng, jax_g=jg)
        assert g.matches(toks), toks
        assert g.matches(toks + [EOS])  # a trailing EOS is accepted
        assert jg.matches(toks)
        doc = json.loads("".join(BYTE_VOCAB[t] for t in toks))
        _validate(doc, schema)


def test_grammar_eos_masked_in_only_at_accepting_states():
    g = TokenGrammar({"const": True}, BYTE_VOCAB, eos_id=EOS)
    state = g.start
    for i, ch in enumerate("true"):
        mask = g.allowed_mask(state)
        assert not mask[EOS], f"EOS allowed mid-emission at {i}"
        assert not g.accepting(state)
        assert int(mask.sum()) == 1 and mask[ord(ch)]
        state = g.advance_token(state, ord(ch))
    assert g.accepting(state)
    assert g.allowed_mask(state)[EOS]
    assert g.exhausted(state)  # nothing but EOS left: reason grammar


def test_grammar_const_and_enum_emit_canonical_json():
    g = TokenGrammar({"const": {"x": 1, "y": [True]}}, BYTE_VOCAB,
                     eos_id=EOS)
    toks = _constrained_walk(g, np.random.RandomState(0))
    assert "".join(BYTE_VOCAB[t] for t in toks) == '{"x":1,"y":[true]}'
    g = TokenGrammar({"enum": ["red", 3]}, BYTE_VOCAB, eos_id=EOS)
    rng = np.random.RandomState(1)
    seen = {"".join(BYTE_VOCAB[t] for t in _constrained_walk(g, rng))
            for _ in range(30)}
    assert seen == {'"red"', "3"}


def test_grammar_matches_rejects_tampered_and_truncated():
    g = TokenGrammar({"const": True}, BYTE_VOCAB, eos_id=EOS)
    good = [ord(c) for c in "true"]
    assert g.matches(good)
    assert not g.matches(good[:-1])          # incomplete document
    assert not g.matches(good + [ord("x")])  # trailing garbage
    bad = list(good)
    bad[1] = ord("x")
    assert not g.matches(bad)                # tampered interior
    assert not g.matches([EOS])              # EOS before acceptance
    assert not g.matches(good[:2] + [EOS] + good[2:])  # EOS mid-document


def test_grammar_requires_byte_transparent_vocab_and_valid_eos():
    g = TokenGrammar({"type": "boolean"}, BYTE_VOCAB, eos_id=9999)
    assert g.eos_id is None  # out of range: disabled, never in a mask


# -- engine: constrained decoding through the paged pipeline ------------------------

BOOL_SCHEMA = {"type": "boolean"}
OBJ_SCHEMA = {"type": "object",
              "properties": {"ok": {"type": "boolean"}},
              "required": ["ok"], "additionalProperties": False}


def test_engine_schema_greedy_and_sampled_always_valid():
    ad, jad = _mlp_pair()
    eng = _paged_engine(ad).start()
    jeng = JaxEngine(jad, kv_mode="paged", max_batch=4,
                     replica_id="jax").start()
    g = TokenGrammar(OBJ_SCHEMA, [chr(i) for i in range(256)], eos_id=EOS)
    try:
        r, toks = _run(eng, [65, 66, 67], max_new_tokens=64, eos_id=EOS,
                       schema=OBJ_SCHEMA)
        doc = json.loads(_doc(toks))
        assert isinstance(doc.get("ok"), bool) and set(doc) <= {"ok"}
        assert g.matches([t for t in toks if t != EOS])
        # Greedy: the masked argmax chain is JAX's, token for token.
        jr, jtoks = _run(jeng, [65, 66, 67], req=JaxRequest,
                         max_new_tokens=64, eos_id=EOS, schema=OBJ_SCHEMA)
        assert toks == jtoks and r.finish_reason == jr.finish_reason
        for seed in range(8):
            r, toks = _run(eng, [70 + seed], max_new_tokens=64,
                           eos_id=EOS, temperature=1.0, seed=1000 + seed,
                           schema=OBJ_SCHEMA)
            doc = json.loads(_doc(toks))
            assert isinstance(doc.get("ok"), bool), (seed, toks)
            assert set(doc) <= {"ok"}
            assert r.finish_reason in ("grammar", "stop")
    finally:
        eng.stop()
        jeng.stop()


def test_engine_exhausted_grammar_finishes_with_reason_grammar():
    eng = _paged_engine().start()
    try:
        r, toks = _run(eng, [65], max_new_tokens=64, eos_id=EOS,
                       temperature=0.9, seed=5, schema=BOOL_SCHEMA)
        assert _doc(toks) in ("true", "false")
        # "true"/"false" admit no continuation: the engine finishes the
        # sequence itself instead of waiting for the model's EOS.
        assert r.finish_reason == "grammar"
        assert len(toks) <= 6
    finally:
        eng.stop()


def test_engine_schema_needs_paged_sampling_capable_stack():
    eng = InferenceEngine(_mlp256(), max_batch=2, kv_mode="slot",
                          metrics=ServeMetrics(),
                          replica_id="slot-t").start()
    try:
        r = Request([65], max_new_tokens=8, eos_id=EOS, schema=BOOL_SCHEMA)
        eng.batcher.submit(r)
        with pytest.raises(ValueError, match="paged"):
            r.result(timeout=30)
    finally:
        eng.stop()


def test_engine_logprobs_report_model_belief_with_topk():
    ad, jad = _mlp_pair()
    eng = _paged_engine(ad).start()
    jeng = JaxEngine(jad, kv_mode="paged", max_batch=4,
                     replica_id="jax").start()
    try:
        r, toks = _run(eng, [5, 7], max_new_tokens=6, logprobs=3)
        entries = r.token_logprobs
        assert len(entries) == len(toks)
        # Markov chain: each row depends only on the previous token.
        context = [7] + toks[:-1]
        for ctx_tok, tok, entry in zip(context, toks, entries):
            assert entry["token"] == tok
            row = np.asarray(ad._logits_of([ctx_tok]), np.float64)[0]
            lse = float(row.max()) + math.log(
                float(np.sum(np.exp(row - row.max()))))
            assert entry["logprob"] == pytest.approx(
                float(row[tok] - lse), rel=1e-5)
            top = entry["top"]
            assert len(top) == 3
            lps = [t["logprob"] for t in top]
            assert lps == sorted(lps, reverse=True)
            assert top[0]["token"] == tok  # greedy: the chosen is top-1
        # The JAX engine's stream and entries on the same weights.
        jr, jtoks = _run(jeng, [5, 7], req=JaxRequest, max_new_tokens=6,
                         logprobs=3)
        assert toks == jtoks
        for e, je in zip(entries, jr.token_logprobs):
            assert e["token"] == je["token"]
            assert e["logprob"] == pytest.approx(je["logprob"], rel=1e-5)
            assert [t["token"] for t in e["top"]] == \
                [t["token"] for t in je["top"]]
    finally:
        eng.stop()
        jeng.stop()


def test_logprobs_and_masks_leave_the_sampled_draw_unchanged():
    """A host-mode row (logprobs asked, or a mask that allows every
    token) draws the tokens of the fused device step: asking for
    logprobs never changes a seeded answer."""
    eng = _paged_engine().start()
    try:
        plain = eng.generate([9, 8, 7], max_new_tokens=12,
                             temperature=0.9, seed=77)
        r, toks = _run(eng, [9, 8, 7], max_new_tokens=12, temperature=0.9,
                       seed=77, logprobs=1)
        assert toks == plain
        assert len(r.token_logprobs) == 12
    finally:
        eng.stop()


# -- HTTP: schema, logprobs, /score ---------------------------------------------------

def test_http_schema_stream_matches_buffered_and_validates():
    server, _, port = _server()
    try:
        payload = {"tokens": [65, 66], "max_new_tokens": 64,
                   "eos_id": EOS, "temperature": 0.8, "seed": 42,
                   "schema": OBJ_SCHEMA}
        status, buffered = _post(port, payload)
        assert status == 200
        doc = json.loads(_doc(buffered["tokens"]))
        assert isinstance(doc.get("ok"), bool)
        events = _stream_events(port, dict(payload, stream=True))
        assert events[-1][0] == "done"
        streamed = [t for e in events if e[0] == "token"
                    for t in e[1]["tokens"]]
        assert streamed == buffered["tokens"]
        assert events[-1][1]["finish_reason"] == buffered["finish_reason"]
    finally:
        server.stop()


def test_http_generate_rejects_unsupported_schema_keyword():
    server, _, port = _server()
    try:
        status, body = _post(port, {
            "tokens": [65], "eos_id": EOS,
            "schema": {"anyOf": [{"type": "boolean"}]}})
        assert status == 400
        assert "anyOf" in body["error"]
        status, body = _post(port, {
            "tokens": [65], "schema": BOOL_SCHEMA})  # no eos_id
        assert status == 400
        assert "eos_id" in body["error"]
    finally:
        server.stop()


def test_http_generate_logprobs_ride_body_and_stream_events():
    server, _, port = _server()
    try:
        payload = {"tokens": [5, 7], "max_new_tokens": 5, "logprobs": 2}
        status, buffered = _post(port, payload)
        assert status == 200
        entries = buffered["logprobs"]
        assert len(entries) == len(buffered["tokens"])
        for tok, entry in zip(buffered["tokens"], entries):
            assert entry["token"] == tok
            assert entry["logprob"] <= 0.0
            assert len(entry["top"]) == 2
        events = _stream_events(port, dict(payload, stream=True))
        streamed = [lp for e in events if e[0] == "token"
                    for lp in e[1]["logprobs"]]
        assert streamed == entries
        assert events[-1][1]["logprobs"] == entries
    finally:
        server.stop()


def test_http_score_parity_with_adapter_log_softmax():
    ad, jad = _mlp_pair()
    server, _, port = _server(lambda: ad)
    jeng = JaxEngine(jad, kv_mode="paged", max_batch=4, replica_id="jax")
    try:
        tokens = [5, 7, 11, 2]
        status, body = _post(port, {"tokens": tokens, "top_logprobs": 3},
                             path="/score")
        assert status == 200
        assert body["tokens"] == tokens
        entries = body["logprobs"]
        assert len(entries) == len(tokens)
        assert entries[0] is None  # nothing conditions position 0
        logits = np.asarray(ad.score_logits(tokens), np.float64)
        want_entries = jeng.score_tokens(tokens, top=3)
        for p in range(1, len(tokens)):
            row = logits[p - 1]
            lse = float(row.max()) + math.log(
                float(np.sum(np.exp(row - row.max()))))
            assert entries[p]["token"] == tokens[p]
            assert entries[p]["logprob"] == pytest.approx(
                float(row[tokens[p]] - lse), rel=1e-5)
            assert entries[p]["logprob"] == pytest.approx(
                want_entries[p]["logprob"], rel=1e-5)
            top = entries[p]["top"]
            assert len(top) == 3
            assert top[0]["logprob"] >= entries[p]["logprob"]
            assert [t["token"] for t in top] == \
                [t["token"] for t in want_entries[p]["top"]]
        # Scoring takes no decode slot; without top_logprobs no "top".
        status, again = _post(port, {"tokens": tokens}, path="/score")
        assert status == 200 and "top" not in (again["logprobs"][1] or {})
    finally:
        server.stop()


def test_http_score_validation_400s():
    server, _, port = _server()
    try:
        for payload, needle in [
            ({"tokens": [5, 999]}, "out of range"),
            ({"tokens": [5], "top_logprobs": 17}, "top_logprobs"),
            ({"tokens": []}, "non-empty"),
            ({"tokens": "nope"}, "non-empty"),
        ]:
            status, body = _post(port, payload, path="/score")
            assert status == 400, payload
            assert needle in body["error"], (payload, body)
    finally:
        server.stop()


# -- the sampler's mask hook (the Queue C repair of this slice) ---------------------

@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, None, 1.0), (1.0, 5, 0.9), (0.3, 40, 0.5)])
def test_sampler_applies_the_mask_before_the_filters_as_jax(
        temperature, top_k, top_p):
    """``filtered_probs`` / ``sample_host`` / ``sample_host_fused`` take
    JAX's ``allowed=`` mask and apply it BEFORE temperature, top-k and
    top-p (``horovod_tpu/serve/sampling.py:137-172``): the filtered
    distribution is JAX's, a greedy row is the masked argmax, and a mask
    that allows every token changes no draw."""
    from horovod_tpu.serve import sampling as jsm
    from horovod_tpu_torch.serve import sampling as sm
    rng = np.random.RandomState(17)
    logits = (2.0 * rng.randn(97)).astype(np.float32)
    allowed = rng.rand(97) < 0.3
    allowed[int(np.argmax(logits))] = False  # the argmax is masked out
    want = jsm.filtered_probs(logits, temperature, top_k, top_p,
                              allowed=allowed)
    got = sm.filtered_probs(logits, temperature, top_k, top_p,
                            allowed=allowed)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert not got[~allowed].any()
    masked_argmax = int(np.argmax(np.where(allowed, logits, -np.inf)))
    key = sm.seq_key(3)
    for fn in (sm.sample_host, sm.sample_host_fused):
        assert fn(logits, key, 9, 0.0, None, 1.0, allowed=allowed) == \
            masked_argmax == jsm.sample_host(
                logits, np.zeros(2, np.uint32), 9, 0.0, None, 1.0,
                allowed=allowed)
        for pos in range(40):
            tok = fn(logits, key, pos, temperature, top_k, top_p,
                     allowed=allowed)
            assert allowed[tok] and got[tok] > 0
            assert fn(logits, key, pos, temperature, top_k, top_p,
                      allowed=np.ones(97, bool)) == \
                fn(logits, key, pos, temperature, top_k, top_p)
