"""Slot mode and ``MLPAdapter`` of the port's engine against the JAX
engine's.

Slot mode keeps one contiguous ``[L, max_batch, max_len, H, Dh]`` cache
row per sequence and attends densely in f32 (``kv_mode="slot"``; the
JAX package has no kernel there).  On the tiny GPT-2 with converted
weights its greedy tokens equal the JAX slot engine's at prompt lengths
around the prompt buckets (8, 16, 32), alone and batched, and equal the
port's paged engine's.  ``MLPAdapter`` — next token = argmax
MLP(one_hot(token)), its flax weights converted by
``mlp_params_from_jax`` — gives JAX's chains in both modes.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import create_mlp as jax_create_mlp
from horovod_tpu.models import transformer as jt
from horovod_tpu.serve import InferenceEngine as JaxEngine
from horovod_tpu.serve import MLPAdapter as JaxMLPAdapter
from horovod_tpu.serve import TransformerAdapter as JaxAdapter
from horovod_tpu_torch.models import (TransformerConfig, create_mlp,
                                      mlp_params_from_jax, params_from_jax)
from horovod_tpu_torch.serve import (DeadlineExceededError, InferenceEngine,
                                     MLPAdapter, Replica, ReplicaScheduler,
                                     Request, ServeMetrics,
                                     TransformerAdapter)
from horovod_tpu_torch.serve.engine import _Slot

torch.set_num_threads(2)

VOCAB = 61
_JTINY = jt.TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, max_len=64, causal=True,
                              dtype=jnp.float32, scan_layers=False)
_TTINY = TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                           d_model=32, d_ff=64, max_len=64,
                           dtype=torch.float32)
# Prompt lengths around the prompt buckets 8, 16 and 32.
_LENGTHS = (3, 7, 8, 9, 15, 16, 17, 31)


@pytest.fixture(scope="module")
def weights():
    tree = jt.Transformer(_JTINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(1)
    std = {"scale": 0.1, "bias": 0.1, "embedding": 0.5, "kernel": 0.2}
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(
            std[path[-1].key] * rng.randn(*x.shape)
            + (path[-1].key == "scale"), np.float32),
        jax.device_get(tree))
    return params, params_from_jax(params)


def _prompt(n):
    return [int(t) for t in
            np.random.RandomState(100 + n).randint(0, VOCAB, (n,))]


def _run_batched(eng, prompts, new):
    reqs = [Request(p, max_new_tokens=new) for p in prompts]
    for r in reqs:
        eng.batcher.submit(r)
    return [r.result(timeout=120) for r in reqs]


def test_slot_greedy_matches_jax_slot_engine(weights):
    params, state = weights
    new = 6
    prompts = [_prompt(n) for n in _LENGTHS]
    jeng = JaxEngine(JaxAdapter(_JTINY, params), kv_mode="slot",
                     max_batch=4, replica_id="jax-slot").start()
    try:
        want = [jeng.generate(p, max_new_tokens=new) for p in prompts]
    finally:
        jeng.stop()
    ad = TransformerAdapter(_TTINY, state, block_tokens=8, device="cpu")
    eng = InferenceEngine(ad, kv_mode="slot", max_batch=4,
                          replica_id="slot").start()
    try:
        assert eng.kv_mode == "slot" and eng.attn_impl == "dense"
        assert eng.kv_stats() is None
        assert [eng.generate(p, max_new_tokens=new) for p in prompts] == want
        assert _run_batched(eng, prompts, new) == want
    finally:
        eng.stop()
    assert len({t for s in want for t in s}) > 3
    paged = InferenceEngine(ad, kv_mode="paged", max_batch=4,
                            prefill_chunk=5, replica_id="paged").start()
    try:
        assert [paged.generate(p, max_new_tokens=new)
                for p in prompts] == want
    finally:
        paged.stop()


def test_slot_prefill_padding_rows_write_nothing(weights):
    """A batch of 3 prompts pads to 4 rows: the padding row computes but
    its K/V never reaches a cache row (JAX's scatter drops its slot index
    ``max_batch``; the port drops the row on the host)."""
    _, state = weights
    ad = TransformerAdapter(_TTINY, state, device="cpu")
    cache = ad.init_cache(4)
    cache, first = ad.prefill(cache, [_prompt(3), _prompt(9), _prompt(5)],
                              [2, 0, 3])
    assert len(first) == 3
    assert cache["k"][:, 1].abs().max() == 0 == cache["v"][:, 1].abs().max()
    assert cache["k"][:, 0, :9].abs().min() > 0
    # Positions past the bucket (16) stay untouched.
    assert cache["k"][:, :, 16:].abs().max() == 0


def test_slot_mode_expiry_reports_request_tokens():
    """Slot-mode ``_Slot`` carries no stream of its own: mid-flight expiry
    reads the request's token list and frees the slot."""
    eng = InferenceEngine(_mlp_adapter()[0], max_batch=2, kv_mode="slot",
                          metrics=ServeMetrics(), replica_id="slot-exp")
    req = Request([1, 2], max_new_tokens=8, timeout_s=0.001)
    req.generated = [5, 6]
    time.sleep(0.01)
    eng._slots[0] = _Slot(req, 4)
    assert eng._expire_inflight() == 1
    assert eng._slots[0] is None
    with pytest.raises(DeadlineExceededError) as e:
        req.result(timeout=5)
    assert "2 token(s)" in str(e.value)
    assert eng.metrics.snapshot()["requests"]["expired"] == 1


def _mlp_adapter(vocab=13, max_len=128):
    jm = jax_create_mlp(features=(16, vocab))
    jp = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, vocab)))["params"]
    tm = create_mlp((16, vocab), in_features=vocab, device="cpu", seed=None)
    tm.load_state_dict(mlp_params_from_jax(jax.device_get(jp)))
    return (MLPAdapter(tm, vocab_size=vocab, max_len=max_len),
            JaxMLPAdapter(jm, jp, vocab_size=vocab, max_len=max_len))


@pytest.mark.parametrize("mode", ["paged", "slot"])
def test_mlp_chains_match_jax(mode):
    port, jad = _mlp_adapter()
    prompts = [[1, 2], [5], [3, 9, 4, 0], [12] * 7]
    jeng = JaxEngine(jad, kv_mode=mode, max_batch=4,
                     replica_id="jax-mlp").start()
    try:
        want = [jeng.generate(p, max_new_tokens=9) for p in prompts]
    finally:
        jeng.stop()
    eng = InferenceEngine(port, kv_mode=mode, max_batch=4,
                          replica_id="mlp").start()
    try:
        assert eng.kv_mode == mode
        assert [eng.generate(p, max_new_tokens=9) for p in prompts] == want
        assert _run_batched(eng, prompts, 9) == want
    finally:
        eng.stop()
    _, logits = port.prefill_chunk_logits({}, [[3, 9], [4]], [0, 0], [[], []])
    np.testing.assert_allclose(
        logits, jad.prefill_chunk_logits((), [[3, 9], [4]], [0, 0],
                                         [[], []])[1], rtol=1e-5, atol=1e-6)
    if mode == "paged":
        kv = eng.kv_stats()
        assert (kv["block_tokens"], kv["used"], kv["used_peak"]) == (1, 0, 0)


class _SlotOnly:
    """An adapter with only the slot interface (MLPAdapter's)."""

    kv_token_cost = 0

    def __init__(self, inner):
        self._inner = inner
        self.vocab_size, self.max_len = inner.vocab_size, inner.max_len

    def weight_bytes(self):
        return self._inner.weight_bytes()

    def init_cache(self, max_batch):
        return self._inner.init_cache(max_batch)

    def prefill(self, cache, prompts, slots):
        return self._inner.prefill(cache, prompts, slots)

    def decode(self, cache, tokens, positions):
        return self._inner.decode(cache, tokens, positions)


def test_auto_mode_picks_paged_when_the_adapter_can_page():
    port, _ = _mlp_adapter()
    assert InferenceEngine(port, max_batch=2, kv_mode="auto").kv_mode == \
        "paged"
    slot_only = _SlotOnly(port)
    eng = InferenceEngine(slot_only, max_batch=2, kv_mode="auto")
    assert eng.kv_mode == "slot"
    with pytest.raises(ValueError, match="no paged interface"):
        InferenceEngine(slot_only, max_batch=2, kv_mode="paged")
    with pytest.raises(ValueError, match="kv_mode must be"):
        InferenceEngine(port, max_batch=2, kv_mode="ring")


def test_slot_engine_fails_sampled_and_forked_requests_loudly():
    """Sampling and n > 1 need the paged engine: a slot engine fails them
    with a ValueError naming why, and serves greedy requests."""
    port, _ = _mlp_adapter()
    eng = InferenceEngine(port, kv_mode="slot", max_batch=4,
                          metrics=ServeMetrics(), replica_id="slot").start()
    try:
        for kw in (dict(temperature=0.7, seed=1), dict(n=2)):
            with pytest.raises(ValueError, match="sampling/n>1 needs a "
                                                 "paged engine"):
                eng.generate([1, 2], max_new_tokens=3, **kw)
        assert len(eng.generate([1, 2], max_new_tokens=3)) == 3
        assert eng.metrics.snapshot()["requests"]["error"] == 2
        sched = ReplicaScheduler([Replica("replica-0", None, eng)])
        rep = sched.healthz()["replicas"][0]
        assert rep["kv_mode"] == "slot" and "kv_blocks" not in rep
    finally:
        eng.stop()


def test_slot_recovery_reinitialises_the_cache_and_keeps_serving(weights):
    _, state = weights
    ad = TransformerAdapter(_TTINY, state, device="cpu")
    eng = InferenceEngine(ad, kv_mode="slot", max_batch=2,
                          metrics=ServeMetrics(), replica_id="slot-rec")
    inner = ad.decode
    armed = {"on": False}

    def decode(*args):
        if armed["on"]:
            armed["on"] = False
            raise RuntimeError("simulated device fault")
        return inner(*args)

    ad.decode = decode
    eng.start()
    try:
        want = eng.generate(_prompt(9), max_new_tokens=4)
        armed["on"] = True
        with pytest.raises(RuntimeError, match="simulated device fault"):
            eng.generate(_prompt(9), max_new_tokens=4)
        assert eng.generate(_prompt(9), max_new_tokens=4) == want
    finally:
        eng.stop()
