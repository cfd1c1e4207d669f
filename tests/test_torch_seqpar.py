"""The port's sequence-parallel prefill against the JAX package's.

Both packages serve the same TINY GPT-2 (vocab 61, 2 layers, 2 heads,
d 32, BT 8; flax weights drawn with numpy from a seed, carried across by
``params_from_jax``).

* ``sp_prefill_chunk``: on the same side pool, chunk, offsets and hop
  buffers, the written K/V rows agree with JAX's at the paged-attention
  tolerance (2e-4 / 2e-5, ``tests/test_paged_attention.py:105``) and the
  logits at the ring flash transformer's (2e-3 / 2e-3,
  ``tests/test_sequence_parallel.py:255``); on an int8 pool the stored
  values are JAX's, any one-quantum difference counted (0 at these
  seeds); every other row of the pool is left as it was;
* the engine: SP greedy tokens equal single-rank prefill at 3·BT and
  3·BT ± 1; the int8 handoff gives JAX's tokens, handoff bytes and
  ``ring_hops == 3`` at 4 ranks; a kill-rank drill leaks no block on
  any rank, requeues once and retries single-rank; ``sp_denied`` is
  advisory; one job at a time; the ``sp-extent-chunk`` / ``sp-handoff``
  spans and the ring's hop schedule reach the tracer; the prefill stage
  partitions exactly; ``sp_comm_bytes == ring_bytes_per_prefill`` (JAX's
  figure), 0 for a single-rank engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.serve import InferenceEngine as JaxEngine
from horovod_tpu.serve import TransformerAdapter as JaxAdapter
from horovod_tpu.serve.seqpar import SPWorld as JaxSPWorld
from horovod_tpu_torch import faultline as fl
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      params_from_jax)
from horovod_tpu_torch.obs import tracing as tr
from horovod_tpu_torch.serve import (DynamicBatcher, InferenceEngine,
                                     Request, ServeMetrics, SPConfig,
                                     SPWorld, TransformerAdapter)

torch.set_num_threads(2)

BT = 8
VOCAB = 61
_JTINY = jt.TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, max_len=64, causal=True,
                              dtype=jnp.float32, scan_layers=False)
_TTINY = TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=2,
                           d_model=32, d_ff=64, max_len=64,
                           dtype=torch.float32)


def _flax_params(seed=0):
    """The tiny model's flax tree with every leaf drawn by numpy (wider
    than GPT-2's init, so greedy streams are not constant)."""
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


def _adapter(model, kv_dtype=None):
    return TransformerAdapter(_TTINY, model, block_tokens=BT, device="cpu",
                              kv_dtype=kv_dtype)


def _prompt(n, seed=3):
    return np.random.RandomState(seed).randint(0, VOCAB, (n,)).tolist()


def _run_one(model, prompt, *, sp_ranks=0, max_new=6, kv_dtype=None,
             **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("prefill_chunk", 5)  # deliberately unaligned with BT
    kw.setdefault("prefix_cache", False)
    if sp_ranks:
        kw.setdefault("sp_min_tokens", 16)
        kw["sp_ranks"] = sp_ranks
    eng = InferenceEngine(_adapter(model, kv_dtype), metrics=ServeMetrics(),
                          replica_id=f"sp-t{sp_ranks}", **kw).start()
    try:
        r = Request(list(prompt), max_new_tokens=max_new)
        eng.batcher.submit(r)
        out = r.result(timeout=120)
        return out, r, eng.kv_stats(), eng
    finally:
        eng.stop()


# -- sp_prefill_chunk against JAX's -------------------------------------------

def _side_pool(jad, nb, rng):
    """A side pool holding random prior contents, as JAX arrays and as
    the port's tensors (the same values)."""
    host = {}
    for k, a in jad.sp_pool(nb).items():
        a = np.asarray(a)
        if a.dtype == np.int8:
            host[k] = rng.randint(-127, 128, a.shape).astype(np.int8)
        elif a.dtype == np.float16:
            host[k] = (0.05 * rng.rand(*a.shape)).astype(np.float16)
        else:
            host[k] = rng.randn(*a.shape).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v.copy()) for k, v in host.items()}, host)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("q_start,extent_start,hop_len,ltable", [
    (0, 0, 0, [6, 2]),            # rank 0's first chunk: no hop buffer
    (21, 16, 16, [3, 1, 5]),      # mid-extent, two prior blocks of hops
])
def test_sp_prefill_chunk_matches_jax(weights, kv_dtype, q_start,
                                      extent_start, hop_len, ltable):
    params, model = weights
    jad = JaxAdapter(_JTINY, params, block_tokens=BT, attn_impl="gather",
                     kv_dtype=kv_dtype)
    pad = _adapter(model, kv_dtype)
    rng = np.random.RandomState(5 + q_start)
    jpool, ppool, before = _side_pool(jad, 8, rng)
    chunk = rng.randint(0, VOCAB, (6,)).tolist()
    hk = rng.randn(2, hop_len, 2, 16).astype(np.float32)
    hv = rng.randn(2, hop_len, 2, 16).astype(np.float32)
    jpool, jlogits = jad.sp_prefill_chunk(jpool, chunk, q_start,
                                          extent_start, ltable, hop_k=hk,
                                          hop_v=hv, hop_len=hop_len)
    ppool, plogits = pad.sp_prefill_chunk(ppool, chunk, q_start,
                                          extent_start, ltable, hop_k=hk,
                                          hop_v=hv, hop_len=hop_len)
    np.testing.assert_allclose(plogits, np.asarray(jlogits), rtol=2e-3,
                               atol=2e-3)
    pos = q_start + np.arange(len(chunk)) - extent_start
    blk = np.asarray(ltable)[pos // BT]
    off = pos % BT
    written = np.zeros(ppool["k"].shape[1:3], bool)
    written[blk, off] = True
    for key in before:
        got, want = ppool[key].numpy(), np.asarray(jpool[key])
        # Rows the chunk did not write are left as they were.
        np.testing.assert_array_equal(got[:, ~written],
                                      before[key][:, ~written])
        g, w = got[:, blk, off], want[:, blk, off]
        if got.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            one_quantum = int((diff == 1).sum())
            assert one_quantum == 0, f"{key}: {one_quantum} one-quantum"
            np.testing.assert_array_equal(g, w)
        elif key.endswith("_scale"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)


# -- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("plen", [3 * BT - 1, 3 * BT, 3 * BT + 1])
def test_sp_matches_single_rank_at_block_boundaries(weights, plen):
    _, model = weights
    prompt = _prompt(plen)
    base, _, _, _ = _run_one(model, prompt)
    got, _, stats, eng = _run_one(model, prompt, sp_ranks=4)
    assert got == base
    assert stats["sp"]["jobs"] == 1 and stats["sp"]["aborts"] == 0
    assert stats["sp"]["sp_tokens"] == plen
    assert stats["used"] == 0
    for m in eng.seqpar.managers:
        assert m.available() == eng.seqpar.blocks_per_rank
    assert eng.metrics.snapshot()["sp"]["prefills"] == 1


def test_int8_handoff_matches_jax(weights):
    """int8 blocks: the extent handoff ships quantized payloads with their
    scale rows through the codec; decode over the handed-off blocks
    gives single-rank prefill's tokens and JAX's, and the handoff bytes
    and ring hops (3 at 4 ranks) are JAX's."""
    params, model = weights
    prompt = _prompt(5 * BT - 3, seed=11)
    base, _, _, _ = _run_one(model, prompt, kv_dtype="int8")
    got, _, stats, _ = _run_one(model, prompt, sp_ranks=4,
                                kv_dtype="int8")
    jad = JaxAdapter(_JTINY, params, block_tokens=BT, attn_impl="gather",
                     kv_dtype="int8")
    jeng = JaxEngine(jad, kv_mode="paged", replica_id="sp-jax", max_batch=8,
                     prefill_chunk=5, prefix_cache=False, sp_ranks=4,
                     sp_min_tokens=16).start()
    try:
        want = jeng.generate(prompt, max_new_tokens=6)
        jstats = jeng.kv_stats()["sp"]
    finally:
        jeng.stop()
    assert got == base == want
    assert stats["sp"]["ring_hops"] == 3
    for key in ("jobs", "sp_tokens", "handoff_bytes", "ring_hops",
                "ring_bytes_per_prefill", "blocks_per_rank"):
        assert stats["sp"][key] == jstats[key], key
    assert stats["sp"]["handoff_bytes"] > 0


def test_kill_rank_mid_sp_prefill_resubmits_whole_no_leaks(weights):
    _, model = weights
    prompt = _prompt(40, seed=7)
    base, _, _, _ = _run_one(model, prompt)
    fl.install(fl.FaultPlan(
        [fl.FaultSpec("kill-rank", point="sp.prefill", step=0)]))
    try:
        got, r, stats, eng = _run_one(model, prompt, sp_ranks=4)
    finally:
        fl.uninstall()
    assert got == base                 # faults cost latency, not answers
    assert r.requeues == 1             # resubmitted whole...
    assert stats["sp"]["jobs"] == 1
    assert stats["sp"]["aborts"] == 1  # ...after the world aborted
    for m in eng.seqpar.managers:      # no leak on any rank
        assert m.available() == eng.seqpar.blocks_per_rank
        assert m.stats()["used"] == 0
    assert stats["used"] == 0
    # The retry went single-rank (a requeued request is SP-ineligible).
    snap = eng.metrics.snapshot()
    assert snap["sp"]["prefills"] == 0 and snap["sp"]["aborts"] == 1


def test_sp_denied_is_advisory_not_rejection():
    """The third admission resource (transient extent blocks) never
    rejects: an over-capacity long prompt is admitted with sp_denied
    set, and a short prompt is never charged."""
    b = DynamicBatcher(max_wait_ms=0.0)
    long1 = Request(list(range(40)), max_new_tokens=2)
    long2 = Request(list(range(40, 80)), max_new_tokens=2)
    short = Request([1, 2, 3], max_new_tokens=2)
    for r in (long1, long2, short):
        b.submit(r)
    got = b.get_admission(8, sp_min_tokens=16, sp_capacity=2,
                          sp_cost=lambda r: 2)
    assert got == [long1, long2, short]
    assert long1.sp_denied is False
    assert long2.sp_denied is True
    assert short.sp_denied is False


def test_sp_world_runs_one_job_at_a_time(weights):
    _, model = weights
    world = SPWorld(_adapter(model), 4, 16)
    assert world.free_extent_blocks() == world.blocks_per_rank
    assert world.extent_cost_blocks(40) == 2  # 16-token extents, BT 8

    class _S:
        def __init__(self, n):
            self.request = Request(_prompt(n), max_new_tokens=1)

    job = world.begin(_S(40), 0)
    assert job is not None and world.job is job
    assert world.free_extent_blocks() == 0
    assert world.begin(_S(40), 1) is None
    world.abort(job)
    assert world.job is None and world.aborts_total == 1
    assert world.free_extent_blocks() == world.blocks_per_rank


def test_geometry_and_comm_bytes_match_jax(weights, monkeypatch):
    params, model = weights
    jworld = JaxSPWorld(JaxAdapter(_JTINY, params, block_tokens=BT,
                                   attn_impl="gather"), 4, 16)
    eng = InferenceEngine(_adapter(model), metrics=ServeMetrics(),
                          max_batch=8, prefill_chunk=5, prefix_cache=False,
                          sp_ranks=4, sp_min_tokens=16)
    world = eng.seqpar
    for n in (1, 17, 33, 40, 56, 64):
        assert world.extents_of(n) == jworld.extents_of(n), n
        assert world.extent_cost_blocks(n) == jworld.extent_cost_blocks(n)
    assert world.ring_bytes_per_prefill() == \
        jworld.ring_bytes_per_prefill() > 0
    assert eng.sp_comm_bytes == eng.kv_stats()["sp"][
        "ring_bytes_per_prefill"]
    single = InferenceEngine(_adapter(model), metrics=ServeMetrics(),
                             max_batch=8, prefill_chunk=5)
    assert single.sp_comm_bytes == 0
    assert "sp" not in single.kv_stats()
    monkeypatch.setenv("HVD_SERVE_SP", "4")
    monkeypatch.setenv("HVD_SERVE_SP_MIN_TOKENS", "99")
    cfg = SPConfig()
    assert cfg.enabled and cfg.ranks == 4 and cfg.min_tokens == 99
    monkeypatch.setenv("HVD_SERVE_SP", "0")
    assert not SPConfig().enabled
    with pytest.raises(ValueError):
        SPWorld(object(), 1, 16)


class _HopTimeline:
    def __init__(self):
        self.hops = []

    def ring_hop(self, name, hop, **kw):
        self.hops.append((name, hop, kw))

    def trace_span(self, *a, **k):
        pass


def test_sp_spans_and_ring_hops_reach_the_tracer(weights):
    """A traced request's SP prefill emits per-extent chunk and handoff
    spans under its trace, and the engine points the ring's hop schedule
    at the tracer's timeline."""
    _, model = weights
    tracer = tr.install(tr.Tracer(sample=1.0))
    tl = _HopTimeline()
    tracer.set_timeline(tl)
    # 56 tokens over 4 ranks: 16-token extents 16/16/16/8, all live.
    eng = InferenceEngine(_adapter(model), metrics=ServeMetrics(),
                          replica_id="sp-trace", max_batch=8,
                          prefill_chunk=5, prefix_cache=False, sp_ranks=4,
                          sp_min_tokens=16).start()
    try:
        r = Request(_prompt(56, seed=13), max_new_tokens=4)
        r.trace = tracer.new_context()
        eng.batcher.submit(r)
        r.result(timeout=120)
        assert eng.kv_stats()["sp"]["jobs"] == 1
        spans = [s for t in tracer.recent_traces()
                 if t["trace_id"] == r.trace.trace_id for s in t["tree"]]
        names = [s["name"] for s in spans]
        assert "sp-extent-chunk" in names and "sp-handoff" in names
        chunk_args = [s["args"] for s in spans
                      if s["name"] == "sp-extent-chunk"]
        assert {a["rank"] for a in chunk_args} == {0, 1, 2, 3}
        hand = [s["args"] for s in spans if s["name"] == "sp-handoff"]
        assert sum(a["bytes"] for a in hand) == \
            eng.kv_stats()["sp"]["handoff_bytes"]
        assert any(a["bytes"] == 0 for a in hand)  # rank 0 is local
        sp_hops = [h for h in tl.hops if "sp_prefill" in h[0]]
        assert len(sp_hops) == 4
        assert sp_hops[0][0].startswith("serve:sp-trace:sp/")
        assert {h[1] for h in sp_hops} == {0, 1, 2, 3}
        assert all(h[2]["bytes_rotated"] > 0 for h in sp_hops)
    finally:
        eng.stop()
        tr.uninstall()


def test_sp_prefill_stage_partitions_exactly(weights):
    """SP prefill accounts into the prefill stage (no new stage label),
    and the stages partition the request's wall."""
    _, model = weights
    _, r, stats, _ = _run_one(model, _prompt(40, seed=17), sp_ranks=4)
    assert stats["sp"]["jobs"] == 1
    assert set(r.stage_ms) >= {"queue", "prefill", "decode"}
    assert r.stage_ms["prefill"] > 0.0
    # The stages cover [submitted_at, the last boundary] without gap.
    assert sum(r.stage_ms.values()) == pytest.approx(
        (r._stage_mark - r.submitted_at) * 1e3, rel=1e-9, abs=1e-6)
