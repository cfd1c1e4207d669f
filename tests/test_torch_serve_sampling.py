"""The port's decode-algorithm layer — seeded sampling, n > 1 forks and
speculative decoding — against the JAX engine's behaviour list
(``tests/test_serve_sampling.py``).

Both engines serve the same tiny GPT-2 (weights made with numpy from a
seed, the flax tree converted by ``params_from_jax``) with
``block_tokens=8`` and a prefill chunk of 5, deliberately unaligned with
the block size.  The port draws with its own keys, not jax's bits, so
sampled tokens are held within the port (batched == single given the
same seed, replay, spec against non-spec by distribution) and
everything that does not depend on the drawn values is held to the JAX
engine: greedy tokens (spec and not), and the fork path's block
accounting (CoW copies, free / used / retained blocks, peak use,
``seq_forks``) on the same prompts.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.serve import InferenceEngine as JaxEngine
from horovod_tpu.serve import Request as JaxRequest
from horovod_tpu.serve import TransformerAdapter as JaxAdapter
from horovod_tpu.serve.engine import _ForkGroup as JaxForkGroup
from horovod_tpu.serve.engine import _Seq as JaxSeq
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import (TransformerConfig, create_mlp,
                                      params_from_jax)
from horovod_tpu_torch.serve import (DynamicBatcher, InferenceEngine,
                                     MLPAdapter, Replica, ReplicaScheduler,
                                     Request, ServeMetrics, ServeServer,
                                     TransformerAdapter, build_replicas)
from horovod_tpu_torch.serve.engine import _ForkGroup, _Seq

torch.set_num_threads(2)

BT = 8
VOCAB = 61
_JTINY = jt.TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, max_len=64, causal=True,
                              dtype=jnp.float32, scan_layers=False)
_TTINY = TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                           d_model=32, d_ff=64, max_len=64,
                           dtype=torch.float32)
# The block-accounting fields held to the JAX engine.
_ACCOUNTING = ("total", "free", "used", "retained", "used_peak", "cow",
               "seq_forks", "forked_requests")


def _flax_params(seed=0, amplify_block_1=1.0):
    """The tiny model's flax tree, every leaf drawn by numpy (wider than
    GPT-2's init, so greedy streams are not constant); ``amplify_block_1``
    scales the last block's leaves (draft and target then disagree)."""
    tree = jt.Transformer(_JTINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(seed)
    std = {"scale": 0.1, "bias": 0.1, "embedding": 0.5, "kernel": 0.2}

    def leaf(path, x):
        v = std[path[-1].key] * rng.randn(*x.shape) \
            + (path[-1].key == "scale")
        if path[0].key == "block_1":
            v = v * amplify_block_1
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(tree))


_SHARED = {}


def _adapters():
    """One draft-capable adapter per framework, shared by every engine on
    the default weights (the JAX adapter's compile caches live on it; a
    draft_layers=1 adapter serves plain decoding identically)."""
    if not _SHARED:
        params = _flax_params()
        _SHARED["state"] = params_from_jax(params)
        _SHARED["jax"] = JaxAdapter(_JTINY, params, block_tokens=BT,
                                    attn_impl="gather", draft_layers=1)
        _SHARED["port"] = TransformerAdapter(
            _TTINY, _SHARED["state"], block_tokens=BT, device="cpu",
            draft_layers=1)
    return _SHARED["port"], _SHARED["jax"]


def _engine(adapter=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_chunk", 5)
    kw.setdefault("metrics", ServeMetrics())
    kw.setdefault("replica_id", "port")
    return InferenceEngine(adapter or _adapters()[0], kv_mode="paged", **kw)


def _jax_engine(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_chunk", 5)
    kw.setdefault("replica_id", "jax")
    return JaxEngine(_adapters()[1], kv_mode="paged", **kw)


def _accounting(eng):
    kv = eng.kv_stats()
    return {k: kv[k] for k in _ACCOUNTING}


def _prompt(n, seed):
    return [int(t) for t in
            np.random.RandomState(seed).randint(0, VOCAB, size=(n,))]


def _mlp_adapter(vocab=13, max_len=128, seed=3):
    mlp = create_mlp((16, vocab), in_features=vocab, device="cpu",
                     seed=seed)
    return MLPAdapter(mlp, vocab_size=vocab, max_len=max_len)


# -- batched == single given the same key --------------------------------------

def test_batched_equals_single_given_same_key_at_block_boundaries():
    """Sampled requests at 2·BT-1 / 2·BT / 2·BT+1 prompt lengths with
    mixed filters and one greedy row riding along: the batched storm
    emits the same streams as each request alone on another engine with
    the same seed; a replay reproduces, another seed diverges; the
    greedy row equals the JAX engine's greedy tokens."""
    rows = [(_prompt(2 * BT - 1, 1), dict(temperature=0.8, seed=101)),
            (_prompt(2 * BT, 2), dict(temperature=1.1, top_k=7, seed=102)),
            (_prompt(2 * BT + 1, 3), dict(temperature=0.9, top_p=0.7,
                                          seed=103)),
            (_prompt(2 * BT, 4), dict(temperature=0.0, seed=104))]
    new = 9  # crosses the next block boundary mid-decode
    batched_eng = _engine().start()
    reqs = [Request(p, max_new_tokens=new, **kw) for p, kw in rows]
    for r in reqs:
        batched_eng.batcher.submit(r)
    batched = [r.result(timeout=120) for r in reqs]
    batched_eng.stop()
    single_eng = _engine(replica_id="port-single").start()
    try:
        singles = [single_eng.generate(p, max_new_tokens=new, **kw)
                   for p, kw in rows]
        assert batched == singles
        assert single_eng.generate(rows[0][0], max_new_tokens=new,
                                   **rows[0][1]) == batched[0]
        other = single_eng.generate(rows[0][0], max_new_tokens=new,
                                    temperature=0.8, seed=999)
    finally:
        single_eng.stop()
    assert other != batched[0]
    jeng = _jax_engine().start()
    try:
        assert jeng.generate(rows[3][0], max_new_tokens=new) == batched[3]
    finally:
        jeng.stop()


# -- n > 1 forks: the port's accounting against the JAX engine's ---------------

def _fork_run(make_engine, request_cls, prompt, **kw):
    eng = make_engine().start()
    try:
        req = request_cls(prompt, **kw)
        eng.batcher.submit(req)
        out = req.result(timeout=120)
        return eng, req, out, _accounting(eng)
    finally:
        eng.stop()


def test_fork_shares_prompt_blocks_cow_counts_and_zero_leaks():
    n = 3
    prompt = _prompt(2 * BT + 3, 2)   # 2 full blocks + a partial
    kw = dict(max_new_tokens=5, temperature=0.9, n=n, seed=77)
    eng, req, out, acc = _fork_run(
        lambda: _engine(max_batch=8, num_blocks=32), Request, prompt, **kw)
    base = eng._request_cost_blocks(Request(prompt, max_new_tokens=5))
    cost = eng._request_cost_blocks(req)
    assert cost == base + (n - 1) * (base - len(prompt) // BT) < n * base
    assert acc["seq_forks"] == n - 1 and acc["forked_requests"] == 1
    assert acc["cow"] >= n - 1
    assert acc["used_peak"] <= cost and acc["used"] == 0
    assert len(req.samples) == n and all(req.samples)
    assert out == req.samples[0]
    eng.start()
    try:
        assert eng.generate(prompt, max_new_tokens=5, temperature=0.9,
                            seed=77) == req.samples[0]
    finally:
        eng.stop()
    _, _, _, jacc = _fork_run(
        lambda: _jax_engine(max_batch=8, num_blocks=32), JaxRequest, prompt,
        **kw)
    assert acc == jacc


def test_fork_primary_finishing_first_never_aliases_blocks():
    """The primary retiring on its first token (max_new_tokens=1) must
    not free the shared prompt blocks before the other forks take their
    references; the pool then still serves exactly."""
    prompt = _prompt(BT + 3, 5)
    kw = dict(max_new_tokens=1, temperature=0.8, n=3, seed=11)
    eng, req, _, acc = _fork_run(
        lambda: _engine(max_batch=8, num_blocks=32, prefix_cache=False),
        Request, prompt, **kw)
    assert all(len(s) == 1 for s in req.samples)
    assert acc["used"] == 0 and acc["free"] + acc["retained"] == acc["total"]
    eng.start()
    try:
        assert eng.generate(prompt, max_new_tokens=4) == \
            eng.generate(prompt, max_new_tokens=4)
        kv = eng.kv_stats()
        assert kv["used"] == 0 and kv["free"] + kv["retained"] == kv["total"]
    finally:
        eng.stop()
    _, _, _, jacc = _fork_run(
        lambda: _jax_engine(max_batch=8, num_blocks=32, prefix_cache=False),
        JaxRequest, prompt, **kw)
    assert acc == jacc


def test_fork_tail_reservation_blocks_over_admission():
    """The fork tails admission counts but does not allocate stay
    reserved: a competitor waits for the family instead of stealing its
    blocks, so both complete with zero preemptions."""
    prompt = _prompt(12, 6)

    def run(make, request_cls):
        eng = make().start()
        try:
            big = request_cls(prompt, max_new_tokens=12, temperature=0.7,
                              n=2, seed=1)
            small = request_cls([1] * BT, max_new_tokens=8)
            eng.batcher.submit(big)
            eng.batcher.submit(small)
            assert len(big.result(timeout=120)) == 12
            assert len(small.result(timeout=120)) == 8
            snap = eng.metrics.snapshot()
            kv = _accounting(eng)
        finally:
            eng.stop()
        assert snap["requests"]["preempted"] == 0, snap["requests"]
        assert kv["used"] == 0 and kv["free"] + kv["retained"] == kv["total"]
        return {k: kv[k] for k in ("total", "free", "used", "retained",
                                   "seq_forks", "forked_requests")}

    assert run(lambda: _engine(max_batch=8, num_blocks=5,
                               prefix_cache=False), Request) == \
        run(lambda: _jax_engine(max_batch=8, num_blocks=5,
                                prefix_cache=False), JaxRequest)


def _members(eng, seq_cls, group_cls, req, tables, **fields):
    group = group_cls(req)
    members = []
    for i, table in enumerate(tables):
        m = seq_cls(req, 0, table, [], admit_seq=fields.get("admit", 0))
        m.group = group
        m.sample_index = i
        m.generated = [7]
        m.length = m.prompt_pos = fields.get("length", BT)
        group.seqs.append(m)
        members.append(m)
    group.forked = True
    return members


@pytest.mark.parametrize("framework", ["port", "jax"])
def test_retired_member_table_never_double_freed_on_group_preempt(framework):
    """A fork member that retires leaves its freed table cleared; a later
    preempt of a surviving member walks the whole family and must not
    free it again.  Same accounting on both engines."""
    port = framework == "port"
    eng = (_engine(max_batch=4, num_blocks=8) if port
           else _jax_engine(max_batch=4, num_blocks=8))
    req = (Request if port else JaxRequest)([1] * BT, max_new_tokens=4, n=2)
    members = _members(eng, _Seq if port else JaxSeq,
                       _ForkGroup if port else JaxForkGroup, req,
                       [eng.blocks.allocate(2), eng.blocks.allocate(2)])
    eng._slots[0], eng._slots[1] = members
    with eng._lock:
        eng._retire_seq(0, members[0])
    assert members[0].table == []
    eng._preempt(1, members[1])
    kv = eng.kv_stats()
    assert (kv["used"], kv["free"] + kv["retained"], req.requeues) == \
        (0, kv["total"], 1)


@pytest.mark.parametrize("framework", ["port", "jax"])
def test_pool_exhaustion_preempts_whole_fork_group(framework):
    """A fork family is preempted as ONE unit: every member's blocks
    freed, every member slot cleared, the request requeued once, the old
    sequence decoding on."""
    port = framework == "port"
    eng = (_engine(max_batch=4, num_blocks=3) if port
           else _jax_engine(max_batch=4, num_blocks=3))
    req_cls = Request if port else JaxRequest
    seq_cls = _Seq if port else JaxSeq
    old_req = req_cls([1] * BT, max_new_tokens=4)
    old_req.generated = [5]
    old = seq_cls(old_req, 0, eng.blocks.allocate(2), [], admit_seq=0)
    old.length = old.prompt_pos = BT
    fork_req = req_cls([2] * BT, max_new_tokens=4, n=2)
    members = _members(eng, seq_cls, _ForkGroup if port else JaxForkGroup,
                       fork_req, [eng.blocks.allocate(1), []], admit=1)
    eng._slots[0] = old
    eng._slots[1], eng._slots[2] = members
    fork_req.samples = [None, None]
    eng._decode_once_paged()
    assert eng._slots[1] is None and eng._slots[2] is None
    assert fork_req.requeues == 1 and fork_req.samples == [None, None]
    assert all(m.table == [] for m in members)
    assert eng.batcher.depth() == 1
    assert eng.metrics.snapshot()["requests"]["preempted"] == 1
    assert eng.blocks.stats()["used"] == 2
    assert len(old_req.generated) == 2


@pytest.mark.parametrize("framework", ["port", "jax"])
def test_drain_resets_fork_family_once(framework):
    """A drained n>1 request travels as ONE unit: returned once, with
    samples and progress cleared for a clean resubmission."""
    port = framework == "port"
    eng = (_engine(max_batch=8, num_blocks=32) if port
           else _jax_engine(max_batch=8, num_blocks=32))
    req = (Request if port else JaxRequest)(
        [1] * (BT + 2), max_new_tokens=4, temperature=0.5, n=2, seed=3)
    members = _members(eng, _Seq if port else JaxSeq,
                       _ForkGroup if port else JaxForkGroup, req,
                       [eng.blocks.allocate(1), eng.blocks.allocate(1)])
    for i, m in enumerate(members):
        m.generated = [4 + i]
        eng._slots[i] = m
    req.samples = [[9], None]
    assert eng.drain() == [req]
    assert req.samples == [None, None]
    assert req.generated == [] and req.requeues == 1
    assert eng.blocks.stats()["used"] == 0


# -- speculative decoding ------------------------------------------------------

def test_spec_greedy_equals_greedy_across_bucket_boundaries():
    """Greedy speculative decoding (k = 4, a 1-layer draft) emits the
    tokens of plain greedy decoding — the port's and the JAX engine's —
    at prompts of BT-1, BT, BT+1 and 2·BT, batched; the draft/verify
    machinery ran and is observable."""
    prompts = [_prompt(n, 30 + n) for n in (BT - 1, BT, BT + 1, 2 * BT)]
    new = 10  # crosses block boundaries mid-decode
    jeng = _jax_engine().start()
    try:
        want = [jeng.generate(p, max_new_tokens=new) for p in prompts]
    finally:
        jeng.stop()
    plain = _engine().start()
    try:
        assert [plain.generate(p, max_new_tokens=new)
                for p in prompts] == want
    finally:
        plain.stop()
    spec = _engine(spec_k=4, replica_id="spec").start()
    try:
        reqs = [Request(p, max_new_tokens=new) for p in prompts]
        for r in reqs:
            spec.batcher.submit(r)
        outs = [r.result(timeout=120) for r in reqs]
        snap = spec.metrics.snapshot()
        kv = spec.kv_stats()
    finally:
        spec.stop()
    assert outs == want
    s = snap["spec"]
    assert s["steps"] > 0 and s["drafted"] > 0
    assert s["drafted"] == s["accepted"] + s["rejected"]
    assert snap["stage"]["spec"]["count"] >= len(prompts)
    assert s["acceptance_rate"] > 0
    assert kv["used"] == 0 and kv["spec_k"] == 4


def test_spec_rejection_rollback_leaks_zero_refs():
    """With the last block's weights amplified, draft and target
    disagree: rejections fire, greedy spec still equals greedy, and the
    rolled-back table entries leak no reference."""
    ad = TransformerAdapter(_TTINY,
                            params_from_jax(_flax_params(amplify_block_1=6.0)),
                            block_tokens=BT, device="cpu", draft_layers=1)
    prompts = [_prompt(BT + 2, 40 + i) for i in range(3)]
    plain = _engine(ad).start()
    try:
        base = [plain.generate(p, max_new_tokens=12) for p in prompts]
    finally:
        plain.stop()
    spec = _engine(ad, spec_k=4, replica_id="spec-r").start()
    try:
        outs = [spec.generate(p, max_new_tokens=12) for p in prompts]
        snap = spec.metrics.snapshot()
        kv = spec.kv_stats()
    finally:
        spec.stop()
    assert outs == base
    assert snap["spec"]["rejected"] > 0, snap["spec"]
    assert kv["used"] == 0


def test_spec_sampled_matches_nonspec_sampled_distribution():
    """Sampled speculation keeps the law of sampled decoding: the
    empirical distribution of whole sampled sequences under spec matches
    non-spec sampling (two-sample chi-square over a tiny vocab, 400
    fixed seeds, the JAX test's bound)."""
    ad = _mlp_adapter(vocab=7)
    seeds = list(range(5000, 5400))

    def storm(spec_k):
        eng = InferenceEngine(ad, max_batch=8, kv_mode="paged",
                              batcher=DynamicBatcher(max_queue=1024),
                              metrics=ServeMetrics(), spec_k=spec_k,
                              replica_id=f"dist-{spec_k}").start()
        try:
            reqs = [Request([1, 2], max_new_tokens=2, temperature=1.2,
                            top_k=4, seed=s) for s in seeds]
            for r in reqs:
                eng.batcher.submit(r)
            return [tuple(r.result(timeout=120)) for r in reqs]
        finally:
            eng.stop()

    plain, spec = storm(0), storm(3)
    assert plain != spec  # the draws differ mechanically ...
    outcomes = sorted(set(plain) | set(spec))
    c1 = np.array([sum(o == x for o in plain) for x in outcomes], float)
    c2 = np.array([sum(o == x for o in spec) for x in outcomes], float)
    pooled = (c1 + c2) / 2
    live = pooled > 0
    chi2 = float((((c1 - pooled) ** 2 + (c2 - pooled) ** 2)
                  / pooled)[live].sum())
    df = int(live.sum()) - 1
    assert chi2 < df + 4 * (2 * df) ** 0.5 + 11, (chi2, df, outcomes)


def test_mlp_spec_accepts_every_draft():
    """``MLPAdapter`` is its own draft: greedy spec accepts every draft,
    so the target runs once per k + 1 tokens, and emits plain greedy's
    tokens."""
    ad = _mlp_adapter()
    k, new = 3, 9
    plain = InferenceEngine(ad, max_batch=4, kv_mode="paged").start()
    try:
        want = plain.generate([1, 2], max_new_tokens=new)
    finally:
        plain.stop()
    spec = InferenceEngine(ad, max_batch=4, kv_mode="paged", spec_k=k,
                           metrics=ServeMetrics()).start()
    try:
        assert spec.generate([1, 2], max_new_tokens=new) == want
    finally:
        spec.stop()
    # Read after stop: the request completes inside the step, before the
    # loop records that step's metrics.
    snap = spec.metrics.snapshot()
    assert snap["spec"]["acceptance_rate"] == 1.0
    # One target call for the first token (prefill), then (new-1)/(k+1)
    # verify steps.
    assert snap["decode_steps"] == (new - 1) // (k + 1)
    assert snap["tokens_total"] == new


def test_spec_needs_a_draft():
    _adapters()
    state = _SHARED["state"]
    with pytest.raises(ValueError, match="no usable draft"):
        InferenceEngine(TransformerAdapter(_TTINY, state, block_tokens=BT,
                                           device="cpu"),
                        kv_mode="paged", spec_k=2)
    with pytest.raises(ValueError, match="requires kv_mode='paged'"):
        InferenceEngine(_mlp_adapter(), kv_mode="slot", spec_k=2)
    with pytest.raises(ValueError, match="draft_layers"):
        TransformerAdapter(_TTINY, state, device="cpu", draft_layers=2)


# -- the HTTP surface ----------------------------------------------------------

def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_http_per_field_400s_seed_echo_and_fork_counters():
    eng = InferenceEngine(_mlp_adapter(), max_batch=4, kv_mode="paged",
                          metrics=ServeMetrics(), replica_id="replica-0")
    sched = ReplicaScheduler([Replica("replica-0", None, eng)],
                             metrics=eng.metrics)
    server = ServeServer(sched)
    port = server.start(port=0, host="127.0.0.1")
    try:
        for bad in [{"temperature": -1}, {"temperature": "hot"},
                    {"top_k": 0}, {"top_k": 2.5}, {"top_p": 0},
                    {"top_p": 1.5}, {"n": 0}, {"n": "two"},
                    {"seed": "abc"}, {"seed": 1.5}, {"seed": True}]:
            payload = {"tokens": [1, 2, 3], "max_new_tokens": 3, **bad}
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, payload)
            assert e.value.code == 400, bad
        out = _post(port, {"tokens": [1, 2, 3], "max_new_tokens": 6,
                           "temperature": 0.9})
        assert isinstance(out["seed"], int)
        replay = _post(port, {"tokens": [1, 2, 3], "max_new_tokens": 6,
                              "temperature": 0.9, "seed": out["seed"]})
        assert replay["tokens"] == out["tokens"]
        assert replay["seed"] == out["seed"]
        greedy = _post(port, {"tokens": [1, 2, 3], "max_new_tokens": 3})
        assert isinstance(greedy["seed"], int)
        nbest = _post(port, {"tokens": [1, 2, 3], "max_new_tokens": 4,
                             "temperature": 1.0, "n": 3, "seed": 9})
        assert nbest["n"] == 3 and len(nbest["completions"]) == 3
        assert all(len(c) == 4 for c in nbest["completions"])
        assert nbest["tokens"] == nbest["completions"][0]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
            text = resp.read().decode()
        assert 'hvd_serve_cow_forks_total{replica="replica-0"} 2' in text
        assert ('hvd_serve_forked_requests_total{replica="replica-0"} 1'
                in text)
        assert "hvd_serve_spec_tokens_total" in text
        kvb = sched.healthz()["replicas"][0]["kv_blocks"]
        assert (kvb["seq_forks"], kvb["forked_requests"], kvb["spec_k"]) \
            == (2, 1, 0)
        assert sched.metrics.snapshot()["seq_forks"] == 2
    finally:
        server.stop()


# -- replicas over process sets ------------------------------------------------

def test_build_replicas_maps_replicas_to_process_sets():
    """After ``hvd.init()`` (a gloo world of one) each replica is a
    process set of ``partition_process_sets``, by default
    ``max(num_slots() // 2, 1)`` of them; without a runtime there are no
    sets and the count is explicit."""
    sched = build_replicas(_mlp_adapter, num_replicas=2, max_batch=2)
    assert [r.process_set for r in sched.replicas] == [None, None]
    assert [r.ranks for r in sched.replicas] == [[], []]
    hvd.init(device="cpu")
    try:
        sched = build_replicas(_mlp_adapter, max_batch=2)
        assert len(sched.replicas) == 1
        rep = sched.replicas[0]
        assert rep.process_set.process_set_id is not None
        assert rep.process_set.included() and rep.ranks == [0]
        assert sched.healthz()["replicas"][0]["ranks"] == [0]
        sched.start()
        try:
            r = Request([1, 2], max_new_tokens=3, temperature=0.5, seed=4)
            sched.submit(r)
            assert len(r.result(timeout=60)) == 3
        finally:
            sched.stop()
        with pytest.raises(ValueError, match="cannot partition"):
            build_replicas(_mlp_adapter, num_replicas=2)
    finally:
        hvd.shutdown()
