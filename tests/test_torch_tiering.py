"""The port's tiered KV hierarchy against the JAX package's.

Both packages serve the same TINY GPT-2 (vocab 61, 2 layers, 2 heads,
d 32, BT 8; flax weights drawn with numpy from a seed, carried across by
``params_from_jax``).  The fleet tier runs over one KV server in this
process (the port's ``KVStoreServer``), which JAX and port clients both
talk to.

* the codec: ``pack_payload`` blobs are byte-equal between the packages
  for f32, bf16, int8 + f16 scales and fp8 + f16 scales, and each
  package unpacks the other's blob bit for bit;
* ``HostTier``: LRU, capacity and salt scoping, step for step against
  JAX's over one scripted run;
* ``TieredBlockManager``: spill → promote round-trips bit for bit (its
  counters step for step against JAX's manager), ``ensure_writable``
  faults a staged payload in before the fork, and retained eviction
  drops the fleet directory entry;
* the engine: under pool pressure the tiered port engine answers as the
  untiered one and as JAX's tiered engine, with more requests in flight
  at the same pool bytes; migration between two port endpoints answers
  as local prefill at prompt tails 3·BT and 3·BT ± 1; a JAX engine
  publishes and a port engine migrates, and the reverse; a
  ``drop-tier-block`` train past the retry budget recomputes with the
  same tokens; ``delay-tier-fetch`` gives a counted, histogrammed stall;
  ``mark_dead`` unpublishes; a roll mid-migration misses and recomputes;
  the tier and SP series of ``/metrics`` are JAX's.
"""

import re
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.runner.http_server import KVStoreClient as JaxKVClient
from horovod_tpu.serve import InferenceEngine as JaxEngine
from horovod_tpu.serve import ServeMetrics as JaxMetrics
from horovod_tpu.serve import TransformerAdapter as JaxAdapter
from horovod_tpu.serve import tiering as jtier
from horovod_tpu_torch import faultline as fl
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      params_from_jax)
from horovod_tpu_torch.runner.http_server import (KVStoreClient,
                                                  KVStoreServer)
from horovod_tpu_torch.serve import (InferenceEngine, Replica,
                                     ReplicaScheduler, ServeMetrics,
                                     TierClient, TierConfig,
                                     TieredBlockManager, TransformerAdapter,
                                     chain_hashes)
from horovod_tpu_torch.serve import tiering as ptier

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
    # One JAX adapter for every JAX engine: its compiled programs live on
    # the adapter and are shared.
    jad = JaxAdapter(_JTINY, params, block_tokens=BT, attn_impl="gather")
    return params, model, jad


@pytest.fixture()
def kv_world(monkeypatch):
    monkeypatch.setenv("HVD_KV_RETRY_MAX", "3")
    monkeypatch.setenv("HVD_KV_RETRY_BASE_MS", "1")
    monkeypatch.setenv("HVD_KV_RETRY_CAP_MS", "5")
    server = KVStoreServer()
    port = server.start(0)
    yield port
    fl.uninstall()
    server.stop()


def _engine(model, rid, tier=None, client=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("prefill_chunk", 16)
    kw.setdefault("num_blocks", 32)
    ad = TransformerAdapter(_TTINY, model, block_tokens=BT, device="cpu",
                            kv_dtype=kw.pop("kv_dtype", None))
    return InferenceEngine(ad, replica_id=rid, metrics=ServeMetrics(),
                           tiering=tier, tier_client=client, **kw)


def _jax_engine(jad, rid, tier=None, client=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("prefill_chunk", 16)
    kw.setdefault("num_blocks", 32)
    return JaxEngine(jad, kv_mode="paged", replica_id=rid,
                     metrics=JaxMetrics(), tiering=tier, tier_client=client,
                     **kw)


def _client(port, rid):
    return TierClient(KVStoreClient("127.0.0.1", port), replica_id=rid)


def _jax_client(port, rid):
    return jtier.TierClient(JaxKVClient("127.0.0.1", port), replica_id=rid)


def _wait_published(eng, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if eng.kv_stats()["tier"]["published"] >= n:
            return True
        time.sleep(0.01)
    return False


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, VOCAB, (n,)).tolist()


# -- the codec ------------------------------------------------------------------

def _payload(kind, seed=0):
    """One block's pool rows as the JAX package holds them (numpy, with
    ml_dtypes for bf16 / fp8) and as the port does (CPU tensors, the
    same bits)."""
    rng = np.random.RandomState(seed)
    shape = (2, BT, 2, 16)
    vals = {k: rng.randn(*shape).astype(np.float32) for k in ("k", "v")}
    if kind == "f32":
        jp = vals
    elif kind == "bf16":
        jp = {k: a.astype(ml_dtypes.bfloat16) for k, a in vals.items()}
    elif kind == "int8":
        jp = {k: rng.randint(-128, 128, shape).astype(np.int8)
              for k in vals}
    else:
        jp = {k: a.astype(ml_dtypes.float8_e4m3fn) for k, a in vals.items()}
    if kind in ("int8", "fp8"):
        for k in ("k_scale", "v_scale"):
            jp[k] = rng.rand(*shape[:-1]).astype(np.float16)
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16, "int8": torch.int8,
             "float8_e4m3fn": torch.float8_e4m3fn}
    # The same bits as CPU tensors: through a uint8 view of the last dim.
    tp = {k: torch.from_numpy(np.ascontiguousarray(a).view(np.uint8))
          .view(names[a.dtype.name]) for k, a in jp.items()}
    return jp, tp


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "fp8"])
def test_pack_payload_blobs_are_byte_equal_to_jax(kind):
    jp, tp = _payload(kind)
    blob = ptier.pack_payload(tp)
    assert blob == jtier.pack_payload(jp)
    assert ptier.payload_nbytes(tp) == jtier.payload_nbytes(jp)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "fp8"])
def test_each_package_unpacks_the_others_blob_bit_for_bit(kind):
    jp, tp = _payload(kind, seed=1)
    got = ptier.unpack_payload(jtier.pack_payload(jp))
    back = jtier.unpack_payload(ptier.pack_payload(tp))
    assert sorted(got) == sorted(jp) == sorted(back)
    for k in jp:
        assert tuple(got[k].shape) == jp[k].shape
        assert _bits(got[k]) == _bits(jp[k]), k
        assert back[k].dtype == jp[k].dtype
        assert _bits(back[k]) == _bits(tp[k]), k


# -- HostTier -------------------------------------------------------------------

def test_host_tier_steps_as_jax():
    """One scripted run (puts past capacity, pops, drops, a salt scrub,
    cold scans and a failed demote) through both host tiers: every
    return value, the LRU order, the length and the evictions agree at
    every step."""
    jh, ph = jtier.HostTier(3), ptier.HostTier(3)

    def entries(salt, step):
        a = np.full((2,), salt, np.int8)
        return (jtier._HostEntry({"k": a}, salt, step),
                ptier._HostEntry({"k": torch.from_numpy(a.copy())}, salt,
                                 step))

    script = [("put", 1, 7, 0), ("put", 2, 7, 1), ("put", 3, 9, 2),
              ("put", 4, 9, 3), ("contains", 1), ("pop", 2), ("put", 5, 7, 4),
              ("put", 3, 9, 5), ("cold", 6, 3), ("cold", 6, 3),
              ("demote_failed", 4), ("cold", 9, 3), ("drop", 5),
              ("put", 6, 7, 8), ("drop_salt", 9), ("pop", 3), ("put", 7, 9, 9),
              ("put", 8, 9, 9), ("put", 9, 7, 10), ("drop_salt", 7)]
    for op in script:
        if op[0] == "put":
            je, pe = entries(op[2], op[3])
            out = (jh.put(op[1], je), ph.put(op[1], pe))
        elif op[0] == "cold":
            out = ([h for h, _ in jh.cold(op[1], op[2])],
                   [h for h, _ in ph.cold(op[1], op[2])])
        elif op[0] == "pop":
            j, p = jh.pop(op[1]), ph.pop(op[1])
            out = ((j.salt, j.step, j.nbytes) if j else None,
                   (p.salt, p.step, p.nbytes) if p else None)
        else:
            out = (getattr(jh, op[0])(*op[1:]), getattr(ph, op[0])(*op[1:]))
        assert out[0] == out[1], op
        assert list(jh._entries) == list(ph._entries), op
        assert (len(jh), jh.evictions, jh.bytes()) == \
            (len(ph), ph.evictions, ph.bytes()), op


# -- TieredBlockManager ---------------------------------------------------------

def _fake_pool(nb):
    """Host stand-ins for the device pool (int8 values + f16 scale rows
    per block) and the extract / insert pair make_block_io wires."""
    rng = np.random.RandomState(1)
    pool = {bid: {"k": torch.from_numpy(
                      rng.randint(-128, 128, (2, BT, 4)).astype(np.int8)),
                  "k_scale": torch.from_numpy(
                      rng.rand(2, BT).astype(np.float16))}
            for bid in range(nb)}

    def extract(bid):
        return {k: a.clone() for k, a in pool[bid].items()}

    def insert(bid, payload):
        pool[bid] = {k: a.clone() for k, a in payload.items()}

    return pool, extract, insert


def test_spill_then_promote_round_trips_bit_exact_and_counts_as_jax():
    """Pool pressure spills the coldest retained blocks host-ward; the
    next same-prefix lookup promotes them back bit for bit, and the
    manager's counters follow JAX's manager over the same script."""
    pm = TieredBlockManager(4, BT, TierConfig(), bytes_per_block=64)
    jm = jtier.TieredBlockManager(4, BT, jtier.TierConfig(),
                                  bytes_per_block=64)
    pool, extract, insert = _fake_pool(4)
    pm.set_device_io(extract, insert)
    jpool = {b: {k: a.numpy().copy() for k, a in p.items()}
             for b, p in pool.items()}
    jm.set_device_io(lambda b: {k: a.copy() for k, a in jpool[b].items()},
                     lambda b, p: jpool.__setitem__(
                         b, {k: np.asarray(a).copy() for k, a in p.items()}))
    prompt = list(range(4 * BT))
    hashes = chain_hashes(prompt, BT)
    golden = None
    for m in (pm, jm):
        blocks = m.allocate(3)
        for h, bid in zip(hashes, blocks):
            m.register(h, bid, salt=5)
        if m is pm:
            golden = [extract(bid) for bid in blocks]
        m.free_table(blocks)                # retained, not freed
        taken = m.allocate(4)               # pressure: all 3 spill
        m.free_table(taken)
    pst, jst = pm.stats()["tier"], jm.stats()["tier"]
    assert pst["spills"] == 3 and pst["host_blocks"] == 3
    assert pst == jst
    ids, matched = pm.lookup_prefix(prompt, hashes=hashes)
    jids, jmatched = jm.lookup_prefix(prompt, hashes=hashes)
    assert (ids, matched) == (jids, jmatched)
    assert matched == 3 * BT
    for want, bid in zip(golden, ids):
        got = extract(bid)
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert pm.stats() == jm.stats()
    assert pm.stats()["tier"]["promotes"] == 3


def test_ensure_writable_faults_a_staged_payload_in_before_the_fork():
    bm = TieredBlockManager(4, BT, TierConfig())
    pool, extract, insert = _fake_pool(4)
    bm.set_device_io(extract, insert)
    bid = bm.allocate(1)[0]
    staged = {"k": torch.full((2, BT, 4), 7, dtype=torch.int8),
              "k_scale": torch.ones((2, BT), dtype=torch.float16)}
    bm.note_pending(bid, staged)
    bm.ref(bid)                              # shared: the fork must copy
    new_bid, copied = bm.ensure_writable(bid)
    assert copied and new_bid != bid
    # The staged bytes landed on the ORIGINAL block before the fork
    # decision, so a fork copies the real contents.
    assert torch.equal(pool[bid]["k"], staged["k"])
    assert bm.apply_pending(bid) is False    # consumed exactly once


def test_retained_eviction_drops_the_directory_entry(kv_world):
    port = kv_world
    client = _client(port, "evict-t")
    bm = TieredBlockManager(2, BT, TierConfig(), client=client)
    h = chain_hashes(list(range(2 * BT)), BT)[0]
    bid = bm.allocate(1)[0]
    bm.register(h, bid, salt=3)
    assert bm.mark_publishing(h)
    assert client.publish(h, 3, ptier.pack_payload(
        {"k": torch.zeros((1, BT), dtype=torch.int8)}))
    bm.note_published(h, 3, True)
    assert client.lookup(h) is not None
    bm.free(bid)                             # → retained
    # The corruption scrub takes the base eviction path (no extract
    # wired): the hash leaves the registry AND the fleet directory.
    assert bm.invalidate_retained(1) == 1
    assert client.lookup(h) is None
    peer = TieredBlockManager(2, BT, TierConfig(),
                              client=_client(port, "evict-peer"))
    assert peer.remote_hits([h]) == 0


# -- the engine: demote over preempt ------------------------------------------

def _storm(eng, prompts, max_new, peak=None):
    out = [None] * len(prompts)
    done = threading.Event()

    def run(i):
        out[i] = eng.generate(prompts[i], max_new_tokens=max_new)

    def watch():
        while not done.is_set():
            with eng._lock:
                live = len({id(s.request) for s in eng._slots
                            if s is not None})
            peak[0] = max(peak[0], live)
            time.sleep(0.0005)

    w = threading.Thread(target=watch) if peak is not None else None
    ts = [threading.Thread(target=run, args=(i,))
          for i in range(len(prompts))]
    if w is not None:
        w.start()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    done.set()
    if w is not None:
        w.join()
    return out


def test_tiered_engine_under_pressure_answers_as_untiered_and_jax(weights):
    """An 8-block pool and 6 concurrent requests of 3 blocks' lifetime
    each: the untiered engine holds at most 2 in flight, the tiered one
    swaps cold sequences host-ward and holds more, and both answer as
    each request alone, as JAX's tiered engine does."""
    params, model, jad = weights
    prompts = [_prompt(10, 100 + i) for i in range(6)]
    base = _engine(model, "dop-base", num_blocks=8).start()
    tiered = _engine(model, "dop-tier", TierConfig(oversub=4.0, quantum=2),
                     num_blocks=8).start()
    jtiered = _jax_engine(jad, "dop-jax",
                          jtier.TierConfig(oversub=4.0, quantum=2),
                          num_blocks=8).start()
    try:
        singles = [base.generate(p, max_new_tokens=12) for p in prompts]
        base_peak = [0]
        assert _storm(base, prompts, 12, base_peak) == singles
        assert _storm(tiered, prompts, 12) == singles
        assert _storm(jtiered, prompts, 12) == singles
        st = tiered.kv_stats()["tier"]
        assert st["inflight_peak"] > base_peak[0], \
            (st["inflight_peak"], base_peak[0])
        assert st["swapped_out_seqs"] > 0 and st["swapped_in_seqs"] > 0
        assert st["spill_bytes"] > 0 and st["promote_bytes"] > 0
        assert tiered.metrics.snapshot()["requests"]["preempted"] == 0
        assert tiered.kv_stats()["used"] == 0
    finally:
        base.stop()
        tiered.stop()
        jtiered.stop()


# -- the engine: cross-replica migration --------------------------------------

SHARED = list(range(1, 3 * BT + 2))  # 3 full blocks and a tail


def test_migration_between_port_endpoints_matches_local_prefill(
        kv_world, weights):
    """B's answers through A's migrated prefix blocks equal local prefill
    at prompt tails 3·BT - 1, 3·BT and 3·BT + 1 past the shared 3
    blocks; the migrated tokens count as prefix hits."""
    _, model, _ = weights
    port = kv_world
    base = _engine(model, "mig-base").start()
    ea = _engine(model, "mig-a", TierConfig(), _client(port, "mig-a")).start()
    ebs = []
    try:
        assert ea.generate(SHARED, max_new_tokens=6) == \
            base.generate(SHARED, max_new_tokens=6)
        assert _wait_published(ea, 3)
        for n in (3 * BT - 1, 3 * BT, 3 * BT + 1):
            p = SHARED + _prompt(n, n)
            eb = _engine(model, f"mig-b{n}", TierConfig(),
                         _client(port, f"mig-b{n}")).start()
            ebs.append(eb)
            assert eb.generate(p, max_new_tokens=6) == \
                base.generate(p, max_new_tokens=6), n
            st = eb.kv_stats()["tier"]
            assert st["migrated_tokens"] == 3 * BT, n
            assert st["migration_failures"] == 0
            assert eb.blocks.stats()["prefix_hit_tokens"] >= 3 * BT
            assert eb.metrics.snapshot()["tier"]["migrations"] == 1
    finally:
        for e in [base, ea] + ebs:
            e.stop()


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_mixed_fleet_migrates_across_the_packages(kv_world, weights,
                                                  publisher):
    """A JAX engine publishes and a port engine migrates, and the
    reverse: the follower's greedy tokens are the publisher's."""
    _, model, jad = weights
    port = kv_world
    if publisher == "jax":
        pub = _jax_engine(jad, "mix-pub", jtier.TierConfig(),
                          _jax_client(port, "mix-pub")).start()
        fol = _engine(model, "mix-fol", TierConfig(),
                      _client(port, "mix-fol")).start()
    else:
        pub = _engine(model, "mix-pub", TierConfig(),
                      _client(port, "mix-pub")).start()
        fol = _jax_engine(jad, "mix-fol", jtier.TierConfig(),
                          _jax_client(port, "mix-fol")).start()
    try:
        prompt = SHARED + [41, 42]
        want = pub.generate(prompt, max_new_tokens=6)
        assert _wait_published(pub, 3)
        assert fol.generate(prompt, max_new_tokens=6) == want
        assert fol.kv_stats()["tier"]["migrated_tokens"] == 3 * BT
    finally:
        pub.stop()
        fol.stop()


def test_drop_tier_block_train_degrades_to_recompute(kv_world, weights):
    """A drop train longer than the KV retry budget kills the migration
    fetches: the follower prefills the prefix itself and answers as the
    never-migrated run."""
    _, model, _ = weights
    port = kv_world
    base = _engine(model, "drop-base").start()
    ea = _engine(model, "drop-a", TierConfig(),
                 _client(port, "drop-a")).start()
    eb = _engine(model, "drop-b", TierConfig(),
                 _client(port, "drop-b")).start()
    try:
        ref = base.generate(SHARED, max_new_tokens=6)
        assert ea.generate(SHARED, max_new_tokens=6) == ref
        assert _wait_published(ea, 3)
        # retry_max 3: a train of 9 exhausts every block's budget however
        # the fetches interleave.
        fl.install(fl.FaultPlan(
            [fl.FaultSpec("drop-tier-block", step=0, repeat=9)]))
        assert eb.generate(SHARED, max_new_tokens=6) == ref
        st = eb.kv_stats()["tier"]
        assert st["migration_failures"] >= 1
        assert st["fetch_drops"] >= 3
        assert st["migrated_tokens"] == 0
    finally:
        fl.uninstall()
        base.stop()
        ea.stop()
        eb.stop()


def test_delay_tier_fetch_is_a_counted_histogrammed_stall(kv_world,
                                                          weights):
    """A delayed fetch the loop has to wait on is one tier fault: counted
    on the engine and in the metrics, histogrammed, and harmless to the
    answer."""
    _, model, _ = weights
    port = kv_world
    base = _engine(model, "pf-base").start()
    ea = _engine(model, "pf-a", TierConfig(), _client(port, "pf-a")).start()
    eb = _engine(model, "pf-b", TierConfig(), _client(port, "pf-b")).start()
    try:
        ref = base.generate(SHARED, max_new_tokens=4)
        assert ea.generate(SHARED, max_new_tokens=4) == ref
        assert _wait_published(ea, 3)
        fl.install(fl.FaultPlan(
            [fl.FaultSpec("delay-tier-fetch", step=0, repeat=3,
                          param=0.05)]))
        assert eb.generate(SHARED, max_new_tokens=4) == ref
        snap = eb.metrics.snapshot()["tier"]
        assert eb.kv_stats()["tier"]["faults"] >= 1
        assert snap["faults"] >= 1
        assert snap["fault_stall"]["count"] >= 1
        assert snap["fault_stall"]["p50_ms"] > 0
        assert eb.kv_stats()["tier"]["migrated_tokens"] == 3 * BT
    finally:
        fl.uninstall()
        base.stop()
        ea.stop()
        eb.stop()


def test_mark_dead_unpublishes_the_directory_entries(kv_world, weights):
    """The scheduler's mark_dead withdraws the dead replica's directory
    entries: a peer's fleet probe then misses."""
    _, model, _ = weights
    port = kv_world
    ea = _engine(model, "dead-a", TierConfig(), _client(port, "dead-a"))
    sched = ReplicaScheduler([Replica("dead-a", None, ea)])
    ea.start()
    try:
        ea.generate(SHARED, max_new_tokens=4)
        assert _wait_published(ea, 3)
        hashes = chain_hashes(SHARED, BT, salt=ea._prefix_salt(None))
        peer = TieredBlockManager(4, BT, TierConfig(),
                                  client=_client(port, "dead-peer"))
        assert peer.remote_hits(hashes[:3]) == 3
        sched.mark_dead("dead-a", reason="test")
        assert ea.kv_stats()["tier"]["published"] == 0
        fresh = TieredBlockManager(4, BT, TierConfig(),
                                   client=_client(port, "dead-p2"))
        assert fresh.remote_hits(hashes[:3]) == 0
    finally:
        ea.stop()


def test_roll_mid_migration_misses_and_recomputes(kv_world, weights):
    """A roll (``swap_model`` on the drained publisher) unpublishes the
    old version's chain: a peer migrating it misses and prefills under
    its own weights, with the same tokens and no migrated token."""
    _, model, _ = weights
    port = kv_world
    base = _engine(model, "roll-base").start()
    ea = _engine(model, "roll-a", TierConfig(),
                 _client(port, "roll-a")).start()
    eb = _engine(model, "roll-b", TierConfig(),
                 _client(port, "roll-b")).start()
    try:
        ref = base.generate(SHARED, max_new_tokens=4)
        assert ea.generate(SHARED, max_new_tokens=4) == ref
        assert _wait_published(ea, 3)
        ea.stop()
        ea.swap_model("default", TransformerAdapter(
            _TTINY, model, block_tokens=BT, device="cpu"), version=1)
        assert ea.kv_stats()["tier"]["published"] == 0
        assert eb.generate(SHARED, max_new_tokens=4) == ref
        assert eb.kv_stats()["tier"]["migrated_tokens"] == 0
    finally:
        base.stop()
        ea.stop()
        eb.stop()


def test_tier_and_sp_metric_series_are_jaxs():
    """The tier and SP series (``# TYPE`` names) of ``/metrics`` and the
    snapshot's ``tier`` / ``sp`` keys are the JAX package's."""
    def series(text):
        return {m.group(1) for m in re.finditer(
            r"^# TYPE (hvd_serve_(?:tier|sp)_\w+) ", text, re.M)}

    pm, jm = ServeMetrics(), JaxMetrics()
    for m in (pm, jm):
        m.observe_tier_stall(3.0)
        m.count_tier_bytes(spill=1, promote=2, demote=3)
        m.count_tier_migration(8)
        m.count_sp_prefill(40, 100, 3)
        m.count_sp_abort()
    assert series(pm.render()) == series(jm.render())
    assert len(series(pm.render())) == 11
    ps, js = pm.snapshot(), jm.snapshot()
    assert ps["tier"] == js["tier"] and ps["sp"] == js["sp"]
