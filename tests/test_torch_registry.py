"""The port's model registry (``serve/registry.py``): resident variants,
deltas, the live roll, warmup, and the server's ``model`` / ``tenant``
ingress, against the JAX package's behaviour list
(``tests/test_tenancy.py``, its registry, roll, warmup and ingress
cases).

The engines serve the MLP Markov chain (the port's weights the JAX
MLP's, converted by ``mlp_params_from_jax``) and the tiny GPT-2 (the flax
tree converted by ``params_from_jax``).  ``apply_delta`` is held to JAX's
leaf for leaf through the converter's names; a variant rolled in while
requests are in flight answers with the chains of the JAX engine serving
the same weights.
"""

import json
import threading
from http.client import HTTPConnection

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.faultline as jfl
from horovod_tpu.models import create_mlp as jax_create_mlp
from horovod_tpu.models import transformer as jt
from horovod_tpu.serve import InferenceEngine as JaxEngine
from horovod_tpu.serve import MLPAdapter as JaxMLPAdapter
from horovod_tpu.serve import TransformerAdapter as JaxAdapter
from horovod_tpu.serve import apply_delta as jax_apply_delta
from horovod_tpu.serve import model_salt as jax_model_salt
import horovod_tpu_torch as hvd
import horovod_tpu_torch.faultline as fl
from horovod_tpu_torch.faultline.plan import FaultInjected
from horovod_tpu_torch.models import (TransformerConfig, create_mlp,
                                      mlp_params_from_jax, params_from_jax)
from horovod_tpu_torch.serve import (DynamicBatcher, InferenceEngine,
                                     MLPAdapter, ModelRegistry, Replica,
                                     ReplicaScheduler, Request, ServeMetrics,
                                     ServeServer, TransformerAdapter,
                                     apply_delta, model_salt)
from horovod_tpu_torch.serve.blocks import chain_hashes

torch.set_num_threads(2)

VOCAB = 31
BT = 8
_JTINY = jt.TransformerConfig(vocab_size=61, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, max_len=64, causal=True,
                              dtype=jnp.float32, scan_layers=False)
_TTINY = TransformerConfig(vocab_size=61, num_layers=2, num_heads=2,
                           d_model=32, d_ff=64, max_len=64,
                           dtype=torch.float32)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    fl.uninstall()
    jfl.uninstall()
    yield
    fl.uninstall()
    jfl.uninstall()


def _mlp_pair(seed=3, vocab=VOCAB, max_len=64):
    jmlp = jax_create_mlp(features=(16, vocab))
    params = jmlp.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, vocab)))["params"]
    mlp = create_mlp((16, vocab), in_features=vocab, device="cpu",
                     seed=None)
    mlp.load_state_dict(mlp_params_from_jax(jax.device_get(params)))
    return (MLPAdapter(mlp, vocab_size=vocab, max_len=max_len),
            JaxMLPAdapter(jmlp, params, vocab_size=vocab, max_len=max_len))


def _mlp_adapter(seed=3, max_len=64):
    return _mlp_pair(seed, max_len=max_len)[0]


def _mlp_chain(adapter, prompt, n):
    seq, tok = [], prompt[-1]
    for _ in range(n):
        tok = int(adapter._next([tok])[0])
        seq.append(tok)
    return seq


def _engine(adapter=None, replica_id="replica-t", warmup=False, **kw):
    return InferenceEngine(adapter or _mlp_adapter(),
                           batcher=DynamicBatcher(),
                           metrics=ServeMetrics(), max_batch=4,
                           kv_mode="paged", replica_id=replica_id,
                           warmup=warmup, **kw)


def _fleet(n=2, warmup=False, metrics=None):
    metrics = metrics or ServeMetrics()
    replicas = []
    for i in range(n):
        eng = InferenceEngine(
            _mlp_adapter(3), batcher=DynamicBatcher(), metrics=metrics,
            max_batch=4, kv_mode="paged", replica_id=f"replica-{i}",
            warmup=warmup)
        replicas.append(Replica(f"replica-{i}", None, eng))
    return ReplicaScheduler(replicas, metrics=metrics)


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


# -- salts and deltas ------------------------------------------------------------

def test_model_salt_and_prefix_hash_salting():
    assert model_salt("default", 0) == 0          # unsalted hashes
    assert model_salt("default", 1) != 0          # a roll invalidates
    assert model_salt("tuned", 0) != model_salt("tuned", 1)
    for name, version in (("default", 0), ("default", 1), ("tuned", 3)):
        assert model_salt(name, version) == jax_model_salt(name, version)
    toks = list(range(32))
    base = chain_hashes(toks, 16)
    assert chain_hashes(toks, 16, salt=0) == base
    assert chain_hashes(toks, 16, salt=model_salt("tuned", 0)) != base


def test_apply_delta_full_lowrank_and_shape_check():
    base = {"blk.w": torch.ones((4, 4)), "blk.b": torch.zeros((4,))}
    out = apply_delta(base, {"blk.b": np.full((4,), 2.0)})
    assert torch.allclose(out["blk.b"], torch.full((4,), 2.0))
    assert out["blk.w"] is base["blk.w"]          # untouched: shared
    a = np.ones((4, 2), np.float32)
    b2 = np.ones((2, 4), np.float32)
    out2 = apply_delta(base, {"blk.w": {"a": a, "b": b2}}, alpha=0.5)
    assert torch.allclose(out2["blk.w"], torch.full((4, 4), 2.0))
    with pytest.raises(ValueError):
        apply_delta(base, {"blk.b": np.zeros((5,))})
    with pytest.raises(KeyError):
        apply_delta(base, {"blk.ghost": np.zeros((4,))})


def test_apply_delta_matches_jax_through_the_converter_names():
    """JAX's flax paths (``block_0.fc1.kernel``) and the port's names
    (``blocks.0.fc1.kernel``) give equal leaves, full and low-rank; a
    rank-r update of the qkv kernel [d, 3, H, Dh] (B carrying the
    output layout) equals the numpy contraction, where JAX's ``a @ b``
    refuses the pair."""
    flax = _flax_params()
    rng = np.random.RandomState(5)
    jdelta = {
        "block_0.fc1.kernel": {"a": rng.randn(32, 4).astype(np.float32),
                               "b": rng.randn(4, 64).astype(np.float32)},
        "block_1.fc2.bias": rng.randn(32).astype(np.float32),
        "ln_f.scale": rng.randn(32).astype(np.float32),
    }
    pdelta = {("blocks." + k[len("block_"):] if k.startswith("block_")
               else k): v for k, v in jdelta.items()}
    want = params_from_jax(jax.device_get(
        jax_apply_delta(flax, jdelta, alpha=0.25)))
    got = apply_delta(params_from_jax(flax), pdelta, alpha=0.25)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    qkv = flax["block_0"]["attn"]["qkv"]["kernel"]          # [d, 3, H, Dh]
    a = rng.randn(32, 8).astype(np.float32)
    b = np.zeros((8,) + qkv.shape[1:], np.float32)
    b[:, 0] = rng.randn(8, *qkv.shape[2:])                   # query only
    got = apply_delta(params_from_jax(flax),
                      {"blocks.0.attn.qkv.kernel": {"a": a, "b": b}})
    np.testing.assert_allclose(
        got["blocks.0.attn.qkv.kernel"].numpy(),
        qkv + np.tensordot(a, b, 1), rtol=1e-6, atol=1e-6)
    assert torch.equal(got["blocks.0.attn.qkv.kernel"][:, 1:],
                       torch.from_numpy(qkv[:, 1:]))
    with pytest.raises((ValueError, TypeError)):
        jax_apply_delta(flax, {"block_0.attn.qkv.kernel": {"a": a, "b": b}})


def test_delta_variant_serves_the_jax_chains():
    """A delta variant resident beside the base on one engine (both
    models in the same prefill and decode steps) answers with the JAX
    engine's chains for the same variant, and the base keeps its own."""
    flax = _flax_params()
    rng = np.random.RandomState(9)
    jdelta = {"block_1.fc1.kernel": {
        "a": rng.randn(32, 4).astype(np.float32),
        "b": rng.randn(4, 64).astype(np.float32)}}
    pdelta = {"blocks.1.fc1.kernel": jdelta["block_1.fc1.kernel"]}
    state = params_from_jax(flax)

    def port_ad(params):
        return TransformerAdapter(_TTINY, params, block_tokens=BT,
                                  device="cpu")

    eng = InferenceEngine(port_ad(state), kv_mode="paged", max_batch=4,
                          prefill_chunk=5, metrics=ServeMetrics())
    eng.add_model("tuned", port_ad(apply_delta(state, pdelta, alpha=0.5)))
    jeng = JaxEngine(JaxAdapter(_JTINY, flax, block_tokens=BT,
                                attn_impl="gather"),
                     kv_mode="paged", max_batch=4, prefill_chunk=5)
    jeng.add_model("tuned", JaxAdapter(
        _JTINY, jax_apply_delta(flax, jdelta, alpha=0.5), block_tokens=BT,
        attn_impl="gather"))
    eng.start()
    jeng.start()
    try:
        prompts = [list(rng.randint(0, 61, n)) for n in (3, 9, 17)]
        reqs = [Request(p, max_new_tokens=6, model=m)
                for p in prompts for m in (None, "tuned")]
        for r in reqs:  # the two models share every step
            eng.batcher.submit(r)
        got = [r.result(timeout=60) for r in reqs]
        want = [jeng.generate(p, max_new_tokens=6, model=m)
                for p in prompts for m in (None, "tuned")]
        assert got == want
        assert any(got[i] != got[i + 1] for i in range(0, len(got), 2))
        assert eng.kv_stats()["used"] == 0
    finally:
        eng.stop()
        jeng.stop()


# -- the registry --------------------------------------------------------------------

def test_registry_register_routes_and_introspects():
    sched = _fleet(2)
    reg = ModelRegistry(sched)
    reg.adopt("default")
    alt = _mlp_adapter(7)
    reg.register("alt", adapter=alt, replica_ids=["replica-1"])
    assert reg.has("alt") and not reg.has("nope")
    assert reg.replicas_for("alt") == ["replica-1"]
    sched.start()
    try:
        r = Request([1, 2, 3], max_new_tokens=4, model="alt")
        rep = sched.submit(r)
        assert rep.replica_id == "replica-1"
        assert r.result(timeout=30) == _mlp_chain(alt, [1, 2, 3], 4)
        health = sched.healthz()["replicas"]
        models = {h["id"]: h["models"] for h in health}
        assert models["replica-0"] == {"default": 0}
        assert models["replica-1"] == {"alt": 0, "default": 0}
        with pytest.raises(ValueError):
            reg.register("alt", adapter=_mlp_adapter(9))  # dup: roll()
        with pytest.raises(ValueError):
            reg.register("bad name!", adapter=alt)
    finally:
        sched.stop()


def test_registry_builds_variants_from_params_delta_and_checkpoint(
        tmp_path):
    """``register`` builds through ``adapter_builder`` from a state
    dict, a delta over ``base_params`` or a checkpoint directory (the
    port's ``save_model``, or a JAX parameter tree)."""
    from horovod_tpu_torch import checkpoint
    flax = _flax_params()
    state = params_from_jax(flax)
    built = []

    def builder(params):
        built.append(params)
        return TransformerAdapter(_TTINY, params, block_tokens=BT,
                                  device="cpu")

    sched = ReplicaScheduler([Replica("replica-0", None, InferenceEngine(
        builder(state), kv_mode="paged", max_batch=2,
        metrics=ServeMetrics()))])
    reg = ModelRegistry(sched, adapter_builder=builder, base_params=state)
    reg.register("full", params=state)
    reg.register("delta", delta={"ln_f.bias": np.ones(32, np.float32)})
    assert torch.equal(built[-1]["ln_f.bias"], torch.ones(32))
    assert built[-1]["wte.embedding"] is state["wte.embedding"]
    hvd.shutdown()
    hvd.init(device="cpu")  # save_model writes from rank 0 of a world
    try:
        checkpoint.save_model(str(tmp_path / "port"), state)
        # The JAX tree as orbax restores it, leaves as tensors.
        checkpoint.save(str(tmp_path / "jax"), jax.tree_util.tree_map(
            torch.from_numpy, jax.device_get(flax)))
    finally:
        hvd.shutdown()
    for name in ("port", "jax"):
        reg.register(f"ckpt-{name}", checkpoint_path=str(tmp_path / name))
        assert set(built[-1]) == set(state)
        for k in state:
            assert torch.equal(built[-1][k], state[k]), (name, k)
    with pytest.raises(ValueError, match="exactly one"):
        reg.register("two", params=state, delta={})


def test_engine_fails_unknown_model_request():
    eng = _engine().start()
    try:
        r = Request([1, 2], max_new_tokens=2, model="ghost")
        eng.batcher.submit(r)
        with pytest.raises(ValueError, match="ghost"):
            r.result(timeout=30)
        assert eng.metrics.snapshot()["requests"]["error"] == 1
    finally:
        eng.stop()


def test_add_model_refuses_slot_mode_and_bad_geometry():
    slot_eng = InferenceEngine(_mlp_adapter(), batcher=DynamicBatcher(),
                               metrics=ServeMetrics(), max_batch=2,
                               kv_mode="slot", replica_id="slot-t")
    with pytest.raises(ValueError, match="slot"):
        slot_eng.add_model("alt", _mlp_adapter(7))
    eng = _engine()
    with pytest.raises(ValueError, match="max_len"):
        eng.add_model("alt", _mlp_adapter(7, max_len=32))
    with pytest.raises(ValueError, match="already"):
        eng.add_model("default", _mlp_adapter(7))


def test_swap_model_requires_stopped_engine():
    eng = _engine().start()
    try:
        with pytest.raises(RuntimeError, match="stopped"):
            eng.swap_model("default", _mlp_adapter(7), version=1)
    finally:
        eng.stop()


def test_roll_zero_failures_and_post_roll_bit_identical():
    sched = _fleet(2)
    reg = ModelRegistry(sched)
    reg.adopt("default")
    reg.register("tuned", adapter=_mlp_adapter(7))
    sched.start()
    try:
        new_adapter, new_jax = _mlp_pair(11)
        reqs = [Request([1, 2, 3], max_new_tokens=6,
                        model="tuned" if i % 2 else None)
                for i in range(12)]
        for r in reqs:
            sched.submit(r)
        assert reg.roll("tuned", adapter=new_adapter) == 2  # mid-storm
        for r in reqs:  # zero failed requests across the roll
            assert len(r.result(timeout=60)) == 6
        post = Request([1, 2, 3], max_new_tokens=6, model="tuned")
        sched.submit(post)
        got = post.result(timeout=30)
        # The new weights served cold, by the port and by JAX.
        assert got == _mlp_chain(new_adapter, [1, 2, 3], 6)
        jeng = JaxEngine(new_jax, kv_mode="paged", max_batch=4).start()
        try:
            assert got == jeng.generate([1, 2, 3], max_new_tokens=6)
        finally:
            jeng.stop()
        assert reg.models() == [
            {"name": "default", "version": 0, "pending_version": None},
            {"name": "tuned", "version": 1, "pending_version": None}]
        snap = sched.metrics.snapshot()
        assert snap["swap"]["tuned"] == {"done": 2, "total": 2}
        assert snap["requests"].get("error", 0) == 0
        assert {h["id"]: h["models"]["tuned"]
                for h in sched.healthz()["replicas"]} == {
            "replica-0": 1, "replica-1": 1}
    finally:
        sched.stop()


def test_roll_without_weights_or_pending_raises():
    sched = _fleet(1)
    reg = ModelRegistry(sched)
    reg.adopt("default")
    with pytest.raises(KeyError):
        reg.roll("ghost", adapter=_mlp_adapter(7))
    with pytest.raises(ValueError, match="pending"):
        reg.roll("default")


def test_swap_abort_leaves_both_versions_serving_and_resumes():
    sched = _fleet(2)
    reg = ModelRegistry(sched)
    reg.adopt("default")
    old = _mlp_adapter(7)
    new = _mlp_adapter(11)
    reg.register("tuned", adapter=old)
    sched.start()
    try:
        # Abort when the walk reaches replica-1: replica-0 swaps,
        # replica-1 keeps the old weights and stays alive.
        fl.install(fl.FaultPlan(
            [fl.FaultSpec("swap-abort", step=0, target="replica-1")]))
        with pytest.raises(FaultInjected):
            reg.roll("tuned", adapter=new)
        fl.uninstall()
        assert [r.state for r in sched.fleet()] == ["healthy", "healthy"]
        versions = {r.replica_id: r.engine._model_versions["tuned"]
                    for r in sched.fleet()}
        assert sorted(versions.values()) == [0, 1]  # half-rolled
        assert reg.models()[1]["pending_version"] == 1
        outs = set()
        for _ in range(8):
            r = Request([1, 2, 3], max_new_tokens=6, model="tuned")
            sched.submit(r)
            outs.add(tuple(r.result(timeout=30)))
        assert outs <= {tuple(_mlp_chain(old, [1, 2, 3], 6)),
                        tuple(_mlp_chain(new, [1, 2, 3], 6))}
        assert reg.roll("tuned") == 1  # resumes: one replica moves
        assert all(r.engine._model_versions["tuned"] == 1
                   for r in sched.fleet())
        post = Request([1, 2, 3], max_new_tokens=6, model="tuned")
        sched.submit(post)
        assert post.result(timeout=30) == _mlp_chain(new, [1, 2, 3], 6)
    finally:
        fl.uninstall()
        sched.stop()


def test_mark_dead_deals_orphans_only_to_holders_of_their_model():
    """A dead replica's queued requests for a variant go only to the
    survivors holding it; with none left they fail, never served by
    another model."""
    sched = _fleet(3)
    reg = ModelRegistry(sched)
    reg.adopt("default")
    alt = _mlp_adapter(7)
    reg.register("alt", adapter=alt, replica_ids=["replica-0",
                                                  "replica-2"])
    victim = sched.fleet()[0].engine
    reqs = [Request([1, 2, 3], max_new_tokens=4,
                    model="alt" if i % 2 else None) for i in range(6)]
    for r in reqs:
        victim.batcher.submit(r)   # queued on the victim, loop not run
    # Dead before any loop runs: a running victim could serve its queue
    # before mark_dead takes it.
    sched.mark_dead("replica-0", reason="test")
    sched.start()
    try:
        for r in reqs:
            want = (_mlp_chain(alt, [1, 2, 3], 4) if r.model
                    else _mlp_chain(victim.adapter, [1, 2, 3], 4))
            assert r.result(timeout=30) == want
            if r.model:
                assert r.replica_id == "replica-2"
        sched.mark_dead("replica-2", reason="test")
        r = Request([1, 2, 3], max_new_tokens=4, model="alt")
        with pytest.raises(Exception, match="alt"):
            sched.submit(r)
    finally:
        sched.stop()


# -- warmup ------------------------------------------------------------------------

def test_warmup_runs_at_every_start_mark_alive_regression():
    """A revived replica's engine restart re-runs warmup."""
    sched = _fleet(2, warmup=True)
    sched.start()
    try:
        eng = sched.fleet()[0].engine
        assert eng.warmup_runs == 1
        assert eng.last_warmup_ms > 0.0
        sched.mark_dead("replica-0", reason="test revive")
        sched.mark_alive("replica-0", reason="test revive")
        assert eng.warmup_runs == 2
        r = Request([1, 2, 3], max_new_tokens=4)
        sched.submit(r)
        assert len(r.result(timeout=30)) == 4
        snap = sched.metrics.snapshot()
        assert snap["warmup"]["runs"]["replica-0"] == 2
    finally:
        sched.stop()


def test_warmup_skips_busy_engine():
    eng = _engine()
    eng._slots[0] = object()  # an in-flight sequence
    assert eng.warmup() == 0.0
    assert eng.warmup_runs == 0
    eng._slots[0] = None


def test_warmup_failure_degrades_to_cold_serving():
    eng = _engine(warmup=True)
    orig = eng.adapter.prefill_chunk
    eng.adapter.prefill_chunk = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("boom"))
    assert eng.warmup() == 0.0
    assert eng.warmup_runs == 0
    eng.adapter.prefill_chunk = orig
    eng.start()
    try:
        r = Request([1, 2], max_new_tokens=3)
        eng.batcher.submit(r)
        assert len(r.result(timeout=30)) == 3  # cold but serving
    finally:
        eng.stop()


def test_warmup_leaves_the_transformer_pool_untouched():
    """Warmup's chunks and decode step carry all-hole tables: no block is
    allocated, nothing retained, and the answers after it are the JAX
    engine's."""
    flax = _flax_params()
    ad = TransformerAdapter(_TTINY, params_from_jax(flax), block_tokens=BT,
                            device="cpu")
    eng = InferenceEngine(ad, kv_mode="paged", max_batch=4,
                          prefill_chunk=16, metrics=ServeMetrics(),
                          warmup=True).start()
    jeng = JaxEngine(JaxAdapter(_JTINY, flax, block_tokens=BT,
                                attn_impl="gather"),
                     kv_mode="paged", max_batch=4, prefill_chunk=16)
    try:
        assert eng.warmup_runs == 1
        stats = eng.kv_stats()
        assert stats["used"] == 0 and stats["retained"] == 0
        prompt = list(range(3, 20))
        assert eng.generate(prompt, max_new_tokens=5) == \
            jeng.start().generate(prompt, max_new_tokens=5)
    finally:
        eng.stop()
        jeng.stop()


# -- HTTP ingress ----------------------------------------------------------------------

def test_server_tenant_and_model_ingress():
    sched = _fleet(1)
    reg = ModelRegistry(sched)
    reg.adopt("default")
    alt = _mlp_adapter(7)
    reg.register("alt", adapter=alt)
    server = ServeServer(sched, registry=reg, request_timeout_s=30)
    port = server.start(port=0, host="127.0.0.1")
    try:
        def post(payload, headers=None):
            conn = HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("POST", "/generate", json.dumps(payload),
                         {"Content-Type": "application/json",
                          **(headers or {})})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            return resp.status, body

        status, body = post({"tokens": [1, 2, 3], "max_new_tokens": 2},
                            headers={"X-Tenant-Id": "acme"})
        assert status == 200 and body["tenant"] == "acme"
        status, body = post({"tokens": [1, 2, 3], "max_new_tokens": 2,
                             "tenant": "beta"},
                            headers={"X-Tenant-Id": "acme"})
        assert status == 200 and body["tenant"] == "beta"  # body wins
        status, body = post({"tokens": [1], "tenant": "eévil"})
        assert status == 400
        status, body = post({"tokens": [1]},
                            headers={"X-Tenant-Id": "sp ace"})
        assert status == 400
        status, body = post({"tokens": [1], "model": "ghost"})
        assert status == 400 and "ghost" in body["error"]
        status, body = post({"tokens": [1, 2, 3], "max_new_tokens": 4,
                             "model": "alt"})
        assert status == 200 and body["model"] == "alt"
        assert body["tokens"] == _mlp_chain(alt, [1, 2, 3], 4)
        conn = HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
        assert 'hvd_serve_tenant_requests_total{tenant="acme",' \
            'outcome="ok"} 1' in text
        assert 'hvd_serve_swap_progress' in text
    finally:
        server.stop()


def test_http_storm_across_a_roll_has_no_failure():
    """Requests over HTTP while the variant rolls: every one answers 200
    with the old or the new chain, and after the roll the new one."""
    sched = _fleet(2)
    reg = ModelRegistry(sched)
    reg.adopt("default")
    old, new = _mlp_adapter(7), _mlp_adapter(11)
    reg.register("tuned", adapter=old)
    server = ServeServer(sched, registry=reg, request_timeout_s=30)
    port = server.start(port=0, host="127.0.0.1")
    results = []

    def client(i):
        conn = HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/generate", json.dumps(
            {"tokens": [1, 2, 3], "max_new_tokens": 5,
             "model": "tuned" if i % 2 else None}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        results.append((i, resp.status, json.loads(resp.read())))
        conn.close()

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        reg.roll("tuned", adapter=new)
        for t in threads:
            t.join(30)
        assert len(results) == 16
        chains = {tuple(_mlp_chain(a, [1, 2, 3], 5))
                  for a in (old, new, sched.fleet()[0].engine.adapter)}
        for i, status, body in results:
            assert status == 200, body
            assert tuple(body["tokens"]) in chains
        client(1)
        assert results[-1][2]["tokens"] == _mlp_chain(new, [1, 2, 3], 5)
    finally:
        server.stop()
