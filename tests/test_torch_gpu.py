"""Tests of the port that need an NVIDIA card (marker ``gpu``).

They skip without a card, deciding inside a fixture.  The card's machine
has no JAX, so this file imports none and is run there without the
repository's ``conftest.py`` (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The CUDA paged-attention kernels are held against their plain version
(rtol 2e-4 / atol 2e-5, the JAX package's paged-attention tolerance) in
every mask mode, for f32/bf16/int8/fp8 pools and f32/bf16 queries, with
an all-hole row, a poisoned never-mapped block, and tables wide enough to
be split: the decode route (one query row,
``csrc/paged_attention_decode_sm90.cu``) and the prefill route (chunks
of C > 1, ``csrc/paged_attention_prefill_sm90.cu``, 3xTF32 on the
tensor cores) at every head dim and at BT 8, 16 and 64, bit for bit
alone and in a batch (and, for chunks, at every chunk bucket).  The
engine's kernel path gives the gather path's tokens and batched ==
single on the card, sampled decoding included (the device sampler is
held to the filtered distribution by chi-square), and greedy
speculative decoding on the kernels gives greedy's tokens.  The fleet:
the router in front of two card endpoints gives one engine's greedy
and seeded answers, and a request traced through it leaves a tree from
the router's root down to the engine's prefill and decode spans.  The
tiered KV hierarchy: a card pool's block through the tier codec and
back is bit-equal, and a tiered engine swapping under pressure answers
as an untiered one; sequence-parallel prefill gives single-rank
prefill's tokens on the card.
"""

import threading

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.models.transformer import init_gpt2_
from horovod_tpu_torch.serve import (InferenceEngine, ServeMetrics,
                                     TransformerAdapter)
from horovod_tpu_torch.serve import paged_attention as tpa

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest "
                    "-m gpu tests/test_torch_gpu.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(rng, kv, q_dtype, C, MB, dev):
    NB, bt, H, Dh = 3 * MB + 4, 16, 12, 64
    kp = rng.randn(NB, bt, H, Dh).astype(np.float32)
    vp = rng.randn(NB, bt, H, Dh).astype(np.float32)
    kp[NB - 1], vp[NB - 1] = 1e4, -1e4      # never mapped: clamped holes only
    k, v = torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)
    ks = vs = None
    if kv == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    elif kv in ("int8", "fp8"):
        k, ks = tpa.quantize_kv(k, kv)
        v, vs = tpa.quantize_kv(v, kv)
    B = 4
    tables = np.full((B, MB), NB, np.int32)
    perm = rng.permutation(NB - 1)
    starts = np.array([0, 5 * bt + 3, (MB - 1) * bt - C // 2, 0], np.int32)
    used = [min((C - 1) // bt + 1, MB), min(6 + (C - 1) // bt, MB), MB, 0]
    for b in range(B):
        tables[b, :used[b]] = perm[MB * b:MB * b + used[b]]
    q = torch.from_numpy(rng.randn(B, C, H, Dh).astype(np.float32)).to(dev)
    if q_dtype == "bf16":
        q = q.bfloat16()
    return (q, k, v, torch.from_numpy(tables).to(dev),
            torch.from_numpy(starts).to(dev)), dict(k_scale=ks, v_scale=vs)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("C,MB", [(1, 4), (1, 21), (37, 12)])
def test_cuda_kernel_matches_plain_version(cuda_device, kv, C, MB):
    """Every launch counts once; one query row takes the decode route,
    a longer chunk the prefill kernel."""
    rng = np.random.RandomState(C * 100 + MB)
    for q_dtype in ("f32", "bf16"):
        args, kw = _card_case(rng, kv, q_dtype, C, MB, cuda_device)
        for mode in (tpa.MASK_NONE, tpa.MASK_CAUSAL, tpa.MASK_STRICT):
            before = dict(tpa.LAUNCHES)
            got = tpa.paged_prefill_attention(*args, mask_mode=mode, **kw)
            torch.cuda.synchronize()
            assert tpa.LAUNCHES["paged_attention"] == \
                before["paged_attention"] + 1
            assert tpa.LAUNCHES["paged_attention_decode"] == \
                before["paged_attention_decode"] + (C == 1)
            assert tpa.LAUNCHES["paged_attention_prefill"] == \
                before["paged_attention_prefill"] + (C > 1)
            ref = tpa.paged_attention_reference(*args, mask_mode=mode, **kw)
            torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
            assert float(got[3].abs().max()) == 0.0


@pytest.mark.gpu
def test_cuda_decode_entry_point(cuda_device):
    rng = np.random.RandomState(3)
    for kv in ("f32", "bf16", "int8", "fp8"):
        (q, k, v, tables, pos), kw = _card_case(rng, kv, "f32", 1, 21,
                                                cuda_device)
        before = tpa.LAUNCHES["paged_attention_decode"]
        got = tpa.paged_decode_attention(q[:, 0].contiguous(), k, v, tables,
                                         pos, **kw)
        ref = tpa.paged_attention_reference(q[:, 0], k, v, tables, pos,
                                            **kw)
        torch.cuda.synchronize()
        assert tpa.LAUNCHES["paged_attention_decode"] == before + 1
        assert got.shape == ref.shape == q[:, 0].shape
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


def _decode_rows(rng, kv, q_dtype, Dh, BT, dev, H=3, MB=21):
    """Eight decode rows of different lengths over one pool: a full
    table, rows of 1, BT and BT + 1 keys, an all-hole row (4), a row with
    a hole between its blocks (5), and two more; the pool's last block
    is never mapped and holds garbage.  q is [8, 1, H, Dh]."""
    lengths = [MB * BT, 1, BT, BT + 1, 0, 5 * BT - 3, MB * BT // 2 + 1, 2]
    need = [-(-n // BT) for n in lengths]
    NB = sum(need) + 1
    kp = rng.randn(NB, BT, H, Dh).astype(np.float32)
    vp = rng.randn(NB, BT, H, Dh).astype(np.float32)
    kp[NB - 1], vp[NB - 1] = 1e4, -1e4
    tables = np.full((len(lengths), MB), NB, np.int32)
    perm, cur = rng.permutation(NB - 1), 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[cur:cur + n]
        cur += n
    tables[5, 1] = NB
    pos = np.array([max(n - 1, 0) for n in lengths], np.int32)
    k, v = torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)
    ks = vs = None
    if kv == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    elif kv in ("int8", "fp8"):
        k, ks = tpa.quantize_kv(k, kv)
        v, vs = tpa.quantize_kv(v, kv)
    q = torch.from_numpy(rng.randn(len(lengths), 1, H, Dh).astype(
        np.float32)).to(dev)
    if q_dtype == "bf16":
        q = q.bfloat16()
    return (q, k, v, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev)), dict(k_scale=ks, v_scale=vs)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
@pytest.mark.parametrize("BT", [8, 16, 64])
def test_cuda_decode_route_matches_plain_version(cuda_device, kv, Dh, BT):
    """The decode route against the plain version for every q kind and
    mask mode: split tables (3 splits), short rows whose later splits
    are empty, holes, and an all-hole row that comes out exactly 0."""
    rng = np.random.RandomState(Dh * 100 + BT)
    for q_dtype in ("f32", "bf16"):
        args, kw = _decode_rows(rng, kv, q_dtype, Dh, BT, cuda_device)
        for mode in (tpa.MASK_NONE, tpa.MASK_CAUSAL, tpa.MASK_STRICT):
            before = dict(tpa.LAUNCHES)
            got = tpa.paged_prefill_attention(*args, mask_mode=mode, **kw)
            torch.cuda.synchronize()
            assert {n: tpa.LAUNCHES[n] - before[n] for n in before} == {
                "paged_attention": 1, "paged_attention_decode": 1,
                "paged_attention_prefill": 0}
            ref = tpa.paged_attention_reference(*args, mask_mode=mode, **kw)
            torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"{q_dtype} mode "
                                       f"{mode}: {m}")
            assert float(got[4].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
def test_cuda_decode_route_wide_table(cuda_device, kv):
    """A table of 70 blocks has 9 splits, more than one cluster merges:
    each split writes its partial and the merge pass combines them."""
    rng = np.random.RandomState(70)
    args, kw = _decode_rows(rng, kv, "f32", 64, 8, cuda_device, MB=70)
    assert tpa.num_splits(70) == 9
    for mode in (tpa.MASK_NONE, tpa.MASK_CAUSAL, tpa.MASK_STRICT):
        got = tpa.paged_prefill_attention(*args, mask_mode=mode, **kw)
        ref = tpa.paged_attention_reference(*args, mask_mode=mode, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        assert float(got[4].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
def test_cuda_decode_route_batched_equals_single_bitwise(cuda_device, kv):
    """At the serving shape (H=12, Dh=64, BT=16, MB=64: 8 splits) each
    row computed alone gives the bits it gets in a batch of 8 rows of
    other lengths, and a repeat gives the same bits."""
    rng = np.random.RandomState(77)
    (q, k, v, tables, pos), kw = _decode_rows(rng, kv, "f32", 64, 16,
                                              cuda_device, H=12, MB=64)
    q = q[:, 0].contiguous()
    batch = tpa.paged_decode_attention(q, k, v, tables, pos, **kw)
    again = tpa.paged_decode_attention(q, k, v, tables, pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(batch, again)
    for b in range(q.shape[0]):
        alone = tpa.paged_decode_attention(
            q[b:b + 1].contiguous(), k, v, tables[b:b + 1].contiguous(),
            pos[b:b + 1].contiguous(), **kw)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], batch[b]), f"row {b}"
    torch.testing.assert_close(
        batch, tpa.paged_attention_reference(q, k, v, tables, pos, **kw),
        rtol=RTOL, atol=ATOL)


def _prefill_rows(rng, kv, q_dtype, Dh, BT, dev, C=37, H=3, MB=21):
    """Seven prefill chunks of C rows over one pool: a chunk ending at the
    table's last key, chunks from position 0, BT - 1 and BT + 1, an
    all-hole row (4), a row with a hole between its blocks (5) and one
    in the middle of its table; the pool's last block is never mapped
    and holds garbage.  q is [7, C, H, Dh]."""
    K = MB * BT
    starts = [K - C, 0, BT - 1, BT + 1, 0, 5 * BT - 3, K // 2 - C // 2]
    need = [0 if b == 4 else min(-(-(s0 + C) // BT), MB)
            for b, s0 in enumerate(starts)]
    NB = sum(need) + 1
    kp = rng.randn(NB, BT, H, Dh).astype(np.float32)
    vp = rng.randn(NB, BT, H, Dh).astype(np.float32)
    kp[NB - 1], vp[NB - 1] = 1e4, -1e4
    tables = np.full((len(starts), MB), NB, np.int32)
    perm, cur = rng.permutation(NB - 1), 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[cur:cur + n]
        cur += n
    tables[5, 1] = NB
    k, v = torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)
    ks = vs = None
    if kv == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    elif kv in ("int8", "fp8"):
        k, ks = tpa.quantize_kv(k, kv)
        v, vs = tpa.quantize_kv(v, kv)
    q = torch.from_numpy(rng.randn(len(starts), C, H, Dh).astype(
        np.float32)).to(dev)
    if q_dtype == "bf16":
        q = q.bfloat16()
    return (q, k, v, torch.from_numpy(tables).to(dev),
            torch.from_numpy(np.array(starts, np.int32)).to(dev)), \
        dict(k_scale=ks, v_scale=vs)


def _check_prefill(args, kw, mode, msg=""):
    """One prefill-route launch against the plain version: the launch
    counts, rtol 2e-4 / atol 2e-5, and the all-hole row exactly 0."""
    before = dict(tpa.LAUNCHES)
    got = tpa.paged_prefill_attention(*args, mask_mode=mode, **kw)
    torch.cuda.synchronize()
    assert {n: tpa.LAUNCHES[n] - before[n] for n in before} == {
        "paged_attention": 1, "paged_attention_decode": 0,
        "paged_attention_prefill": 1}
    ref = tpa.paged_attention_reference(*args, mask_mode=mode, **kw)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL,
                               msg=lambda m: f"{msg} mode {mode}: {m}")
    assert float(got[4].abs().max()) == 0.0
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
@pytest.mark.parametrize("BT", [8, 16, 64])
def test_cuda_prefill_route_matches_plain_version(cuda_device, kv, Dh, BT):
    """The prefill route (3xTF32 on the tensor cores) against the plain
    version for both q kinds and every mask mode: split tables (3
    splits, merged by the merge pass), short rows whose later splits are
    empty, holes, and an all-hole row that comes out exactly 0."""
    rng = np.random.RandomState(Dh * 100 + BT + 7)
    for q_dtype in ("f32", "bf16"):
        args, kw = _prefill_rows(rng, kv, q_dtype, Dh, BT, cuda_device)
        for mode in (tpa.MASK_NONE, tpa.MASK_CAUSAL, tpa.MASK_STRICT):
            _check_prefill(args, kw, mode, q_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
def test_cuda_prefill_route_wide_table(cuda_device, kv):
    """A table of 72 blocks has 9 splits, each writing its partial for
    the merge pass; a chunk of 100 rows spans two query tiles."""
    rng = np.random.RandomState(72)
    args, kw = _prefill_rows(rng, kv, "f32", 64, 16, cuda_device, C=100,
                             H=4, MB=72)
    assert tpa.num_splits(72) == 9
    for mode in (tpa.MASK_NONE, tpa.MASK_CAUSAL, tpa.MASK_STRICT):
        _check_prefill(args, kw, mode)


@pytest.mark.gpu
def test_cuda_prefill_route_bf16_chunk(cuda_device):
    """GPT-2's default compute type: a bf16 q chunk over a bf16 pool at
    the serving shape (H=12, Dh=64, BT=16, MB=64, C=64)."""
    rng = np.random.RandomState(16)
    args, kw = _prefill_rows(rng, "bf16", "bf16", 64, 16, cuda_device,
                             C=64, H=12, MB=64)
    assert args[0].dtype == args[1].dtype == torch.bfloat16
    for mode in (tpa.MASK_CAUSAL, tpa.MASK_NONE):
        _check_prefill(args, kw, mode)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
def test_cuda_prefill_route_batched_equals_single_bitwise(cuda_device, kv):
    """At the serving shape (H=12, Dh=64, BT=16, MB=64: 8 splits, two key
    tiles each) each chunk computed alone gives the bits it gets in a batch
    of 7 chunks of other starts, a repeat gives the same bits, and the
    first 8 rows of a 64-row chunk equal the same rows sent as an 8-row
    chunk (the engine's chunk buckets)."""
    rng = np.random.RandomState(78)
    (q, k, v, tables, starts), kw = _prefill_rows(rng, kv, "f32", 64, 16,
                                                  cuda_device, C=64, H=12,
                                                  MB=64)
    batch = tpa.paged_prefill_attention(q, k, v, tables, starts, **kw)
    again = tpa.paged_prefill_attention(q, k, v, tables, starts, **kw)
    short = tpa.paged_prefill_attention(q[:, :8].contiguous(), k, v,
                                        tables, starts, **kw)
    torch.cuda.synchronize()
    assert torch.equal(batch, again)
    assert torch.equal(short, batch[:, :8])
    for b in range(q.shape[0]):
        alone = tpa.paged_prefill_attention(
            q[b:b + 1].contiguous(), k, v, tables[b:b + 1].contiguous(),
            starts[b:b + 1].contiguous(), **kw)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], batch[b]), f"row {b}"
    torch.testing.assert_close(
        batch, tpa.paged_attention_reference(q, k, v, tables, starts, **kw),
        rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    """Both routes (a decode row, C = 1, and a chunk, C = 37) refuse the
    same operands, before any launch."""
    for C in (1, 37):
        rng = np.random.RandomState(0)
        (q, k, v, tables, starts), _ = _card_case(rng, "f32", "f32", C, 4,
                                                  cuda_device)
        before = dict(tpa.LAUNCHES)
        with pytest.raises(ValueError, match="head_dim"):
            tpa.paged_prefill_attention(q[..., :48].contiguous(),
                                        k[..., :48].contiguous(),
                                        v[..., :48].contiguous(), tables,
                                        starts)
        strided = q.transpose(0, 2).contiguous().transpose(0, 2)
        assert strided.shape == q.shape and not strided.is_contiguous()
        with pytest.raises(ValueError, match="contiguous"):
            tpa.paged_prefill_attention(strided, k, v, tables, starts)
        with pytest.raises(ValueError, match="int32"):
            tpa.paged_prefill_attention(q, k, v, tables.long(), starts)
        nb = k.shape[0] - 1
        shifted = k.flatten()[1:1 + nb * 16 * 12 * 64].view(nb, 16, 12, 64)
        with pytest.raises(ValueError, match="aligned"):
            tpa.paged_prefill_attention(q, shifted, shifted, tables, starts)
        assert tpa.LAUNCHES == before


_TINY = TransformerConfig(vocab_size=61, num_layers=2, num_heads=2,
                          d_model=32, d_ff=64, max_len=64,
                          dtype=torch.float32)


@pytest.mark.gpu
def test_kernel_engine_matches_gather_engine_and_batched_equals_single(
        cuda_device):
    model = init_gpt2_(Transformer(_TINY, device=cuda_device),
                       torch.Generator(device=cuda_device).manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(10.0)   # spread the logits so the streams vary

    def engine(impl):
        ad = TransformerAdapter(_TINY, model, block_tokens=8, attn_impl=impl,
                                device=cuda_device)
        return InferenceEngine(ad, max_batch=8, prefill_chunk=5,
                               replica_id=impl).start()

    k, g = engine("kernel"), engine("gather")
    assert k.attn_impl == "kernel"
    try:
        prompts = [np.random.RandomState(n).randint(0, 61, (n,)).tolist()
                   for n in (7, 8, 9, 16, 17, 3, 30, 41)]
        before = dict(tpa.LAUNCHES)
        singles = [k.generate(p, max_new_tokens=6) for p in prompts]
        assert all(tpa.LAUNCHES[n] > before[n] for n in before)
        assert singles == [g.generate(p, max_new_tokens=6) for p in prompts]
        results = [None] * len(prompts)

        def run(i):
            results[i] = k.generate(prompts[i], max_new_tokens=6)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert results == singles
    finally:
        k.stop()
        g.stop()


from horovod_tpu_torch.serve import Request  # noqa: E402
from horovod_tpu_torch.serve import sampling as tsm  # noqa: E402


@pytest.mark.gpu
def test_cuda_sampler_follows_the_filtered_distribution(cuda_device):
    """The device draw on the card, fed by ``pack_params`` as the engine
    feeds it: the noise hashed on the card is the CPU's (to f64
    rounding of the logs), and 20000 draws from fixed keys over a
    filtered 64-token distribution pass a chi-square against
    ``filtered_probs`` (deterministic once the keys are fixed)."""
    rng = np.random.RandomState(11)
    x = (rng.randn(64) * 1.5).astype(np.float32)
    temp, top_k, top_p = 0.8, 40, 0.95
    N = 20000
    keys = np.stack([tsm.seq_key(2024, i) for i in range(N)])
    packed = torch.from_numpy(tsm.pack_params(
        keys, np.full(N, 9), np.full(N, temp), np.full(N, top_k),
        np.full(N, top_p))).to(cuda_device)
    words = packed[:, :2].long()
    torch.testing.assert_close(tsm.gumbel_noise(words, 64).cpu(),
                               tsm.gumbel_noise(words.cpu(), 64),
                               rtol=1e-12, atol=1e-12)
    out = tsm.sample_batched(
        torch.from_numpy(x).to(cuda_device)[None].expand(N, 64), packed)
    assert out.device.type == "cuda"
    counts = np.bincount(out.cpu().numpy(), minlength=64)
    p = tsm.filtered_probs(x, temp, top_k, top_p)
    expected = p * N
    live = expected > 0
    chi2 = float(((counts[live] - expected[live]) ** 2
                  / expected[live]).sum())
    df = int(live.sum()) - 1
    assert counts[~live].sum() == 0
    assert chi2 < df + 4 * (2 * df) ** 0.5 + 11, (chi2, df)


@pytest.mark.gpu
def test_sampled_decode_on_the_kernel_equals_the_gather_step(cuda_device):
    """One sampled decode step through the paged kernels gives the gather
    step's tokens for the same keys and pool, and a row's token does not
    depend on the other rows; a sampled request on a kernel engine
    launches the kernels and replays with its seed."""
    model = init_gpt2_(Transformer(_TINY, device=cuda_device),
                       torch.Generator(device=cuda_device).manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(10.0)
    ads = {impl: TransformerAdapter(_TINY, model, block_tokens=8,
                                    attn_impl=impl, device=cuda_device)
           for impl in ("kernel", "gather")}
    B, MB = 4, ads["kernel"].max_blocks_per_seq
    rng = np.random.RandomState(5)
    lens = np.array([9, 17, 3, 30])
    tables = np.full((B, MB), 4 * MB, np.int64)
    for b in range(B):
        tables[b, :lens[b] // 8 + 1] = b * MB + np.arange(lens[b] // 8 + 1)
    keys = np.stack([tsm.seq_key(7, b) for b in range(B)])
    args = (rng.randint(0, 61, B), lens, tables, keys,
            np.full(B, 0.9, np.float32), np.full(B, 20), np.full(B, 0.9))
    out = {}
    for impl, ad in ads.items():
        pool = ad.init_paged_cache(4 * MB, B)
        g = torch.Generator(device=cuda_device).manual_seed(1)
        for name in ("k", "v"):   # the same random K/V in both pools
            pool[name].copy_(torch.randn(pool[name].shape, generator=g,
                                         device=cuda_device))
        before = dict(tpa.LAUNCHES)
        _, toks = ad.decode_paged_sampled(pool, *args)
        if impl == "kernel":
            assert tpa.LAUNCHES["paged_attention_decode"] == \
                before["paged_attention_decode"] + _TINY.num_layers
        out[impl] = toks
        # Row 1 alone (the others inactive) draws the same token.
        lone = [a.copy() for a in args]
        for a in (lone[0], lone[1]):
            a[[0, 2, 3]] = 0
        lone[2][[0, 2, 3]] = 4 * MB
        pool2 = ad.init_paged_cache(4 * MB, B)
        pool2["k"].copy_(pool["k"])
        pool2["v"].copy_(pool["v"])
        _, single = ad.decode_paged_sampled(pool2, *lone)
        assert single[1] == toks[1]
    assert out["kernel"].tolist() == out["gather"].tolist()
    eng = InferenceEngine(ads["kernel"], max_batch=4, prefill_chunk=5,
                          replica_id="kernel").start()
    try:
        before = dict(tpa.LAUNCHES)
        r = Request(np.arange(11).tolist(), max_new_tokens=6,
                    temperature=0.8, top_k=20, seed=3, n=2)
        eng.batcher.submit(r)
        first = r.result(timeout=120)
        assert all(tpa.LAUNCHES[n] > before[n] for n in before)
        assert all(len(s) == 6 for s in r.samples)
        assert eng.generate(np.arange(11).tolist(), max_new_tokens=6,
                            temperature=0.8, top_k=20, seed=3) == first
        assert eng.kv_stats()["seq_forks"] == 1
    finally:
        eng.stop()


@pytest.mark.gpu
def test_greedy_spec_on_the_kernels_equals_greedy(cuda_device):
    """Speculative decoding on the card (a 1-layer draft, k = 4): the
    verify chunk runs the prefill route from mid-block starts, the draft
    the decode route, and the greedy tokens equal plain greedy's."""
    model = init_gpt2_(Transformer(_TINY, device=cuda_device),
                       torch.Generator(device=cuda_device).manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(10.0)
    ad = TransformerAdapter(_TINY, model, block_tokens=8, device=cuda_device,
                            draft_layers=1)
    prompts = [np.random.RandomState(n).randint(0, 61, (n,)).tolist()
               for n in (7, 8, 9, 16)]
    plain = InferenceEngine(ad, max_batch=4, prefill_chunk=5,
                            replica_id="plain").start()
    try:
        want = [plain.generate(p, max_new_tokens=10) for p in prompts]
    finally:
        plain.stop()
    spec = InferenceEngine(ad, max_batch=4, prefill_chunk=5, spec_k=4,
                           replica_id="spec").start()
    try:
        before = dict(tpa.LAUNCHES)
        assert [spec.generate(p, max_new_tokens=10) for p in prompts] == want
        assert tpa.LAUNCHES["paged_attention_prefill"] - \
            before["paged_attention_prefill"] >= spec.spec_steps
        assert spec.kv_stats()["used"] == 0
    finally:
        spec.stop()


@pytest.mark.gpu
def test_aligned_draft_spec_on_the_kernels_accepts_and_equals_greedy(
        cuda_device):
    """The draft agrees with its target when block 1 (above the 1-layer
    draft) has zero output projections: greedy spec on the card then
    accepts drafts (accepted positions, the bonus token, later decode
    steps over K/V that verify wrote) and still emits plain greedy's
    tokens, leaking no block reference."""
    model = init_gpt2_(Transformer(_TINY, device=cuda_device),
                       torch.Generator(device=cuda_device).manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(10.0)
        blk = model.blocks[1]
        for p in (blk.attn.proj.kernel, blk.attn.proj.bias, blk.fc2.kernel,
                  blk.fc2.bias):
            p.zero_()
    ad = TransformerAdapter(_TINY, model, block_tokens=8, device=cuda_device,
                            draft_layers=1)
    prompts = [np.random.RandomState(n).randint(0, 61, (n,)).tolist()
               for n in (7, 8, 9, 16)]
    plain = InferenceEngine(ad, max_batch=4, prefill_chunk=5,
                            replica_id="plain").start()
    try:
        want = [plain.generate(p, max_new_tokens=12) for p in prompts]
    finally:
        plain.stop()
    spec = InferenceEngine(ad, max_batch=4, prefill_chunk=5, spec_k=4,
                           metrics=ServeMetrics(), replica_id="spec").start()
    try:
        before = dict(tpa.LAUNCHES)
        reqs = [Request(p, max_new_tokens=12) for p in prompts]
        for r in reqs:
            spec.batcher.submit(r)
        assert [r.result(timeout=120) for r in reqs] == want
        assert spec.metrics.snapshot()["spec"]["accepted"] > 0
        assert tpa.LAUNCHES["paged_attention_prefill"] - \
            before["paged_attention_prefill"] == 2 * (spec.prefill_steps
                                                      + spec.spec_steps)
        assert tpa.LAUNCHES["paged_attention_decode"] - \
            before["paged_attention_decode"] == \
            2 * (spec.steps - spec.spec_steps) + spec.draft_steps
        assert spec.kv_stats()["used"] == 0
    finally:
        spec.stop()


# ---------------------------------------------------------------------------
# FlashAttention-2 kernels (entry points in csrc/flash_attention.cu; bf16
# on wgmma in csrc/flash_attention_fwd_sm90.cu and
# csrc/flash_attention_bwd_sm90.cu, f32 on 3xTF32 mma.sync in
# csrc/flash_attention_fwd_tf32_sm90.cu and
# csrc/flash_attention_bwd_tf32_sm90.cu) against their plain versions: f32
# forward 2e-4 / 2e-5 and gradients 2e-3 / 2e-4 (the JAX package's flash
# tolerances, tests/test_flash.py).  In bf16 both sides sum in f32 and
# round the output once: 2 bf16 ulps (rtol 2**-6) and an atol of 1e-3
# times the plain output's largest magnitude; the bf16 output may also
# move by the rounding of P to bf16 before P.V, the bf16 gradients by the
# rounding of P and dS before the second products
# (tfl.attention_fwd_rounding_bound, tfl.attention_bwd_rounding_bound,
# element by element).  lse is f32 on both sides, at the f32 tolerance.
# ---------------------------------------------------------------------------

from horovod_tpu_torch.parallel import flash as tfl  # noqa: E402

_TOL = {torch.float32: ((2e-4, 2e-5), (2e-3, 2e-4)),
        torch.bfloat16: ((2**-6, 1e-3), (2**-6, 1e-3))}


def _assert_close(got, want, rtol, atol, bound=0.0, msg=""):
    """|got - want| <= atol + rtol·|want| + bound, atol scaled by
    max|want| for bf16."""
    if got.dtype == torch.bfloat16:
        atol *= float(want.float().abs().max())
    diff = (got.float() - want.float()).abs()
    tol = atol + rtol * want.float().abs() + bound
    assert bool((diff <= tol).all()), \
        f"{msg}: max excess {float((diff - tol).max()):.3e}"


def _check_fwd(q, k, v, mode, scale, dtype):
    """The forward kernel against its plain version, and twice with the
    same bits; counts one launch of each run on its route.  Returns
    ``(out, lse)``."""
    n0 = dict(tfl.LAUNCHES)
    out, lse = tfl.flash_fwd(q, k, v, mode, scale)
    again = tfl.flash_fwd(q, k, v, mode, scale)
    kw = dict(mask_mode=mode, scale=scale)
    ref_out, ref_lse = tfl.attention_fwd_reference(q, k, v, **kw)
    bound = (tfl.attention_fwd_rounding_bound(q, k, v, **kw)
             if dtype == torch.bfloat16 else 0.0)
    torch.cuda.synchronize()
    (frt, fat), _ = _TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    _assert_close(out, ref_out, frt, fat, bound, msg=f"out mode {mode}")
    torch.testing.assert_close(lse, ref_lse, rtol=2e-4, atol=2e-5)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1]), \
        "forward not bit-identical"
    wg = 2 if dtype == torch.bfloat16 else 0
    assert tfl.LAUNCHES["flash_fwd"] == n0["flash_fwd"] + 2
    assert tfl.LAUNCHES["flash_fwd_wgmma"] == n0["flash_fwd_wgmma"] + wg
    assert tfl.LAUNCHES["flash_fwd_tf32x3"] == \
        n0["flash_fwd_tf32x3"] + 2 - wg
    if mode == tfl.MASK_STRICT:   # row 0 sees no key
        assert float(out[:, 0].float().abs().max()) == 0.0
        assert torch.all(lse[:, :, 0] == -1e30 / 2)
    return out, lse


def _check_bwd(q, k, v, do, lse, delta, mode, scale, dtype):
    """Both backward kernels against their plain versions, and twice
    with the same bits, each run on its dtype's route (bf16: wgmma, f32:
    split-precision TF32); returns the gradients."""
    n0 = dict(tfl.LAUNCHES)
    got = tfl.flash_bwd(q, k, v, do, lse, delta, mode, scale)
    kw = dict(mask_mode=mode, scale=scale)
    want = (tfl.attention_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
            *tfl.attention_bwd_dkv_reference(q, k, v, do, lse, delta, **kw))
    bounds = (tfl.attention_bwd_rounding_bound(q, k, v, do, lse, delta, **kw)
              if dtype == torch.bfloat16 else (0.0,) * 3)
    again = tfl.flash_bwd(q, k, v, do, lse, delta, mode, scale)
    torch.cuda.synchronize()
    _, (grt, gat) = _TOL[dtype]
    for g, w, x, a, name in zip(got, want, bounds, again, "qkv"):
        assert g.dtype == dtype
        _assert_close(g, w, grt, gat, x, msg=f"d{name} mode {mode}")
        assert torch.equal(g, a), f"d{name} not bit-identical"
    on, off = ("wgmma", "tf32x3") if dtype == torch.bfloat16 \
        else ("tf32x3", "wgmma")
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert tfl.LAUNCHES[kernel] == n0[kernel] + 2
        assert tfl.LAUNCHES[f"{kernel}_{on}"] == n0[f"{kernel}_{on}"] + 2
        assert tfl.LAUNCHES[f"{kernel}_{off}"] == n0[f"{kernel}_{off}"]
    return got


def _flash_inputs(rng, shape, dtype, dev):
    def mk():
        return torch.from_numpy(
            (rng.randn(*shape) * 0.5).astype(np.float32)).to(dev, dtype)
    return mk(), mk(), mk(), mk()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 2, 16), (2, 128, 4, 32),
                                   (1, 96, 3, 64), (1, 80, 2, 128),
                                   (2, 256, 2, 64)])
def test_flash_kernels_match_plain_versions(cuda_device, dtype, shape):
    rng = np.random.RandomState(sum(shape))
    q, k, v, do = _flash_inputs(rng, shape, dtype, cuda_device)
    scale = 1.0 / np.sqrt(shape[-1])
    for mode in (tfl.MASK_NONE, tfl.MASK_CAUSAL, tfl.MASK_STRICT):
        out, lse = _check_fwd(q, k, v, mode, scale, dtype)
        n0 = dict(tfl.LAUNCHES)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        got = _check_bwd(q, k, v, do, lse, delta, mode, scale, dtype)
        for name in ("flash_fwd", "flash_fwd_wgmma", "flash_fwd_tf32x3"):
            assert tfl.LAUNCHES[name] == n0[name]
        assert tfl.LAUNCHES["flash_bwd_dq"] == n0["flash_bwd_dq"] + 2
        assert tfl.LAUNCHES["flash_bwd_dkv"] == n0["flash_bwd_dkv"] + 2
        wg = 2 if dtype == torch.bfloat16 else 0
        assert tfl.LAUNCHES["flash_bwd_dq_wgmma"] == \
            n0["flash_bwd_dq_wgmma"] + wg
        assert tfl.LAUNCHES["flash_bwd_dkv_wgmma"] == \
            n0["flash_bwd_dkv_wgmma"] + wg
        assert tfl.LAUNCHES["flash_bwd_dq_tf32x3"] == \
            n0["flash_bwd_dq_tf32x3"] + 2 - wg
        assert tfl.LAUNCHES["flash_bwd_dkv_tf32x3"] == \
            n0["flash_bwd_dkv_tf32x3"] + 2 - wg
        if mode == tfl.MASK_STRICT:   # row 0 sees no key
            assert float(got[0][:, 0].float().abs().max()) == 0.0


@pytest.mark.gpu
def test_flash_kernels_read_strided_qkv_and_mixed_dtypes(cuda_device):
    """q/k/v sliced out of one fused [B, S, 3, H, D] projection are read
    in place; the lse variant's out_dtype=f32 over bf16 inputs matches
    the plain version; autograd runs the backward kernels."""
    rng = np.random.RandomState(11)
    B, S, H, D = 2, 256, 4, 64
    qkv = torch.from_numpy(rng.randn(B, S, 3, H, D).astype(np.float32)
                           * 0.5).to(cuda_device).requires_grad_()
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = tfl.flash_attention(q, k, v, causal=True)
    (out * out.cos()).sum().backward()
    g_kernel = qkv.grad.clone()
    qkv_cpu = qkv.detach().cpu().requires_grad_()
    ref = tfl.flash_attention(*qkv_cpu.unbind(2), causal=True)
    (ref * ref.cos()).sum().backward()
    torch.testing.assert_close(out.detach().cpu(), ref.detach(), rtol=2e-4,
                               atol=2e-5)
    torch.testing.assert_close(g_kernel.cpu(), qkv_cpu.grad, rtol=2e-3,
                               atol=2e-4)
    qb, kb, vb = (t.detach().bfloat16().requires_grad_() for t in (q, k, v))
    o32, lse = tfl.flash_attention_lse(qb, kb, vb, mask_mode=tfl.MASK_STRICT,
                                       out_dtype=torch.float32)
    assert o32.dtype == torch.float32
    ro, rl = tfl.attention_fwd_reference(qb.float(), kb, vb,
                                         mask_mode=tfl.MASK_STRICT)
    torch.testing.assert_close(o32, ro, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(lse, rl, rtol=2e-4, atol=2e-5)
    (o32.sum() + lse.sum()).backward()
    assert qb.grad.dtype == torch.bfloat16 and torch.isfinite(
        qb.grad.float()).all()


def _check_fused_qkv_backward(dev, S, dtype):
    """q/k/v as strided views of one fused [B, S, 3, H, D] projection
    through the backward pair of ``dtype``'s route, in every mask mode,
    against the plain versions with bit-identical repeats."""
    rng = np.random.RandomState(S)
    B, H, D = 2, 4, 64
    qkv = torch.from_numpy((rng.randn(B, S, 3, H, D) * 0.5).astype(
        np.float32)).to(dev, dtype)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    do = torch.from_numpy((rng.randn(B, S, H, D) * 0.5).astype(
        np.float32)).to(dev, dtype)
    scale = 1.0 / np.sqrt(D)
    for mode in (tfl.MASK_NONE, tfl.MASK_CAUSAL, tfl.MASK_STRICT):
        out, lse = tfl.flash_fwd(q, k, v, mode, scale)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        dq, _, _ = _check_bwd(q, k, v, do, lse, delta, mode, scale, dtype)
        if mode == tfl.MASK_STRICT:
            assert float(dq[:, 0].float().abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 80, 96, 256])
def test_bf16_backward_reads_fused_qkv_views(cuda_device, S):
    """The main path's layout: bf16 q/k/v as strided views of one fused
    [B, S, 3, H, D] projection, through the wgmma backward pair, in every
    mask mode (S past a multiple of the 64-row tile, and S = 8 below
    one), against the plain versions with bit-identical repeats."""
    _check_fused_qkv_backward(cuda_device, S, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 80, 96])
def test_f32_backward_reads_fused_qkv_views(cuda_device, S):
    """An f32 model's layout: f32 q/k/v as strided views of one fused
    projection, through the split-precision TF32 backward pair, in every
    mask mode (S = 8 below one 64-row tile, 80 and 96 past one), at the
    fixed f32 gradient tolerance with bit-identical repeats."""
    _check_fused_qkv_backward(cuda_device, S, torch.float32)


@pytest.mark.gpu
def test_lse_out_dtype_f32_backward_takes_the_tf32x3_pair(cuda_device):
    """``flash_attention_lse(out_dtype=f32)`` over bf16 inputs (ring
    attention's per-hop partial): the f32 output's cotangent sends the
    backward to the split-precision TF32 pair, whose bf16 gradients
    match the plain path's on the CPU."""
    rng = np.random.RandomState(12)
    B, S, H, D = 2, 96, 3, 64
    ins = [torch.from_numpy((rng.randn(B, S, H, D) * 0.5).astype(
        np.float32)).bfloat16() for _ in range(3)]
    w = torch.from_numpy(rng.randn(B, H, S).astype(np.float32))
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        q, k, v = (t.to(dev).requires_grad_() for t in ins)
        n0 = dict(tfl.LAUNCHES)
        o, lse = tfl.flash_attention_lse(q, k, v, mask_mode=tfl.MASK_CAUSAL,
                                         out_dtype=torch.float32)
        (o * o.cos()).sum().add((lse * w.to(dev)).sum()).backward()
        n = {key: tfl.LAUNCHES[key] - n0[key] for key in n0}
        if dev.type == "cuda":
            assert n["flash_bwd_dq_tf32x3"] == n["flash_bwd_dkv_tf32x3"] == 1
            assert n["flash_bwd_dq_wgmma"] == n["flash_bwd_dkv_wgmma"] == 0
        else:
            assert not any(n.values())
        grads.append([t.grad for t in (q, k, v)])
    torch.cuda.synchronize()
    (rt, at), _ = _TOL[torch.bfloat16]
    for g, w_, name in zip(*grads, "qkv"):
        assert g.dtype == torch.bfloat16
        _assert_close(g.cpu(), w_, rt, at, msg=f"d{name}")


@pytest.mark.gpu
def test_bf16_backward_reads_head_major_views(cuda_device):
    """[B, H, S, D] tensors viewed as [B, S, H, D] (the head stride above
    the sequence stride) go to the wgmma pair as they lie."""
    rng = np.random.RandomState(5)
    B, H, S, D = 2, 3, 80, 64
    q, k, v, do = (torch.from_numpy((rng.randn(B, H, S, D) * 0.5).astype(
        np.float32)).to(cuda_device, torch.bfloat16).transpose(1, 2)
        for _ in range(4))
    assert q.stride(2) > q.stride(1)
    scale = 1.0 / np.sqrt(D)
    for mode in (tfl.MASK_NONE, tfl.MASK_CAUSAL):
        out, lse = tfl.flash_fwd(q, k, v, mode, scale)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        _check_bwd(q, k, v, do, lse, delta, mode, scale, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 80, 96, 256])
def test_bf16_forward_reads_fused_qkv_views(cuda_device, S):
    """The main path's layout: bf16 q/k/v as strided views of one fused
    [B, S, 3, H, D] projection, through the wgmma forward, in every mask
    mode (S past a multiple of the 64-row tile, and S = 8 below one),
    against the plain version with bit-identical repeats."""
    rng = np.random.RandomState(100 + S)
    B, H, D = 2, 4, 64
    qkv = torch.from_numpy((rng.randn(B, S, 3, H, D) * 0.5).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    for mode in (tfl.MASK_NONE, tfl.MASK_CAUSAL, tfl.MASK_STRICT):
        _check_fwd(q, k, v, mode, 1.0 / np.sqrt(D), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 80, 96])
def test_f32_forward_reads_fused_qkv_views(cuda_device, S):
    """An f32 model's layout: f32 q/k/v as strided views of one fused
    [B, S, 3, H, D] projection, through the split-precision TF32 forward,
    in every mask mode (S = 8 below one 64-row tile, 80 and 96 past one),
    at the fixed f32 forward tolerance with bit-identical repeats."""
    rng = np.random.RandomState(200 + S)
    B, H, D = 2, 4, 64
    qkv = torch.from_numpy((rng.randn(B, S, 3, H, D) * 0.5).astype(
        np.float32)).to(cuda_device)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    for mode in (tfl.MASK_NONE, tfl.MASK_CAUSAL, tfl.MASK_STRICT):
        _check_fwd(q, k, v, mode, 1.0 / np.sqrt(D), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_f32_forward_matches_plain_version_past_one_tile(cuda_device, D):
    """The f32 forward (128 query rows a block at D <= 64, 64 at D = 128)
    holds the plain version in every mask mode at S past one 128-row
    tile."""
    rng = np.random.RandomState(300 + D)
    q, k, v, _ = _flash_inputs(rng, (2, 200, 3, D), torch.float32,
                               cuda_device)
    scale = 1.0 / np.sqrt(D)
    for mode in (tfl.MASK_NONE, tfl.MASK_CAUSAL, tfl.MASK_STRICT):
        want = tfl.attention_fwd_reference(q, k, v, mask_mode=mode,
                                           scale=scale)
        out, lse = tfl.flash_fwd(q, k, v, mode, scale)
        torch.cuda.synchronize()
        _assert_close(out, want[0], 2e-4, 2e-5, msg=f"mode {mode}")
        torch.testing.assert_close(lse, want[1], rtol=2e-4, atol=2e-5)


@pytest.mark.gpu
def test_bf16_forward_reads_head_major_views(cuda_device):
    """[B, H, S, D] tensors viewed as [B, S, H, D] (the head stride above
    the sequence stride) go to the wgmma forward as they lie."""
    rng = np.random.RandomState(6)
    B, H, S, D = 2, 3, 80, 64
    q, k, v = (torch.from_numpy((rng.randn(B, H, S, D) * 0.5).astype(
        np.float32)).to(cuda_device, torch.bfloat16).transpose(1, 2)
        for _ in range(3))
    assert q.stride(2) > q.stride(1)
    for mode in (tfl.MASK_NONE, tfl.MASK_CAUSAL, tfl.MASK_STRICT):
        _check_fwd(q, k, v, mode, 1.0 / np.sqrt(D), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mode", [((32, 128, 16, 64), 0),
                                        ((4, 1024, 12, 64), 1)])
def test_bf16_forward_is_deterministic_at_the_main_path_shapes(
        cuda_device, shape, mode):
    """BERT-large's and GPT-2's forward shapes: two runs give the same out
    and lse bits (no atomics, a fixed order of sums), both within the
    plain version's tolerance."""
    rng = np.random.RandomState(sum(shape))
    q, k, v, _ = _flash_inputs(rng, shape, torch.bfloat16, cuda_device)
    _check_fwd(q, k, v, mode, 1.0 / np.sqrt(shape[-1]), torch.bfloat16)


@pytest.mark.gpu
def test_flash_wrapper_refuses_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((1, 64, 2, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tfl.flash_attention(q, q, q)
    h = q[..., :32].half()
    with pytest.raises(ValueError, match="dtype"):
        tfl.flash_attention(h, h, h)


@pytest.mark.gpu
def test_nccl_world_of_one_trains_through_the_optimizer(cuda_device):
    """``hvd.init()`` on a card forms a one-member NCCL group, and
    ``DistributedOptimizer`` reduces through it: after one boundary the
    parameters equal a plain AdamW step on the averaged gradients."""
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        _optimizer_step_through_nccl(hvd, cuda_device)
    finally:
        hvd.shutdown()


def _optimizer_step_through_nccl(hvd, cuda_device):
    assert hvd.nccl_built() and hvd.cuda_built() and not hvd.gloo_enabled()
    assert torch.distributed.get_backend() == "nccl"
    assert hvd.size() == 1 and hvd.device().type == "cuda"
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(300, device=cuda_device))
    ref = torch.nn.Parameter(w.detach().clone())
    opt = hvd.DistributedOptimizer(torch.optim.AdamW([w], lr=0.1),
                                   backward_passes_per_step=2)
    plain = torch.optim.AdamW([ref], lr=0.1)
    g1, g2 = torch.randn(300, device=cuda_device), torch.randn(
        300, device=cuda_device)
    w.grad = g1.clone()
    assert opt.step() is None
    w.grad = g2.clone()
    opt.step()
    ref.grad = (g1 + g2) / 2
    plain.step()
    torch.testing.assert_close(w, ref, rtol=1e-6, atol=1e-7)
    out = hvd.allreduce(torch.arange(4.0, device=cuda_device), op=hvd.Sum)
    torch.testing.assert_close(out, torch.arange(4.0, device=cuda_device))


@pytest.mark.gpu
def test_remat_runs_the_forward_kernel_twice_per_block(cuda_device):
    """With ``remat`` the backward recomputes each block: the forward
    kernel launches twice per layer and micro-batch, the backward
    kernels once, all on their f32 route; the gradients equal the run
    without remat."""
    import dataclasses
    from horovod_tpu_torch.models import lm_loss
    cfg = dataclasses.replace(_TINY, causal=False, attention_impl="flash")
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, 61, (2, 64))).to(cuda_device)
    grads = []
    for remat in (False, True):
        model = init_gpt2_(
            Transformer(dataclasses.replace(cfg, remat=remat),
                        device=cuda_device),
            torch.Generator(device=cuda_device).manual_seed(0))
        n0 = dict(tfl.LAUNCHES)
        loss = lm_loss(model(tokens), tokens)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
        torch.cuda.synchronize()
        got = {k: tfl.LAUNCHES[k] - n0[k] for k in n0}
        L = cfg.num_layers
        assert got == {"flash_fwd": L * (2 if remat else 1),
                       "flash_bwd_dq": L, "flash_bwd_dkv": L,
                       "flash_fwd_wgmma": 0,      # an f32 model
                       "flash_bwd_dq_wgmma": 0,
                       "flash_bwd_dkv_wgmma": 0,
                       "flash_fwd_tf32x3": L * (2 if remat else 1),
                       "flash_bwd_dq_tf32x3": L,
                       "flash_bwd_dkv_tf32x3": L}, got
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# -- the ResNet path (chip_smoke.py phase 6's checks) -------------------------

@pytest.mark.gpu
def test_s2d_stem_equals_the_naive_stem_on_the_card(cuda_device):
    from horovod_tpu_torch.models import resnet as tr
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 224, 224, 3)
                         .astype(np.float32)).to(cuda_device)
    naive = tr.NaiveStem(3, 64, dtype=torch.float32, device=cuda_device)
    naive.reset_parameters(torch.Generator(cuda_device).manual_seed(1))
    s2d = tr.SpaceToDepthStem(3, 64, dtype=torch.float32, device=cuda_device)
    s2d.load_state_dict(naive.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(s2d(x), naive(x), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_max_pool_eq_grad_on_the_card(cuda_device):
    """Tie-free: the backward equals the naive pool's; every window
    tied: the gradient's sum is kept."""
    from horovod_tpu_torch.models import resnet as tr
    rng = np.random.RandomState(2)
    shape = (4, 112, 112, 64)
    g = torch.from_numpy(rng.rand(4, 56, 56, 64).astype(np.float32)).to(
        cuda_device)
    x = torch.from_numpy(rng.permutation(int(np.prod(shape))).reshape(shape)
                         .astype(np.float32)).to(cuda_device)
    grads = []
    for xp, pool in ((x, tr.max_pool_eq_grad), (x, tr.max_pool_3x3s2),
                     (torch.ones_like(x), tr.max_pool_eq_grad)):
        xg = xp.clone().requires_grad_()
        (pool(xg) * g).sum().backward()
        grads.append(xg.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(grads[2].double().sum()),
                               float(g.double().sum()), rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("fast_stem", [False, True])
def test_small_resnet_step_on_the_card_equals_the_cpu(cuda_device,
                                                      fast_stem):
    """f32 logits, loss and new statistics within 2e-4 / 2e-4, gradients
    within 2e-3 / 2e-4 of the same step on the CPU."""
    from horovod_tpu_torch.models import resnet as tr
    kw = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8,
              dtype=torch.float32, s2d_stem=fast_stem, eq_pool_grad=fast_stem)
    ref = tr.init_kernels_(tr.ResNet(**kw, device="cpu"),
                           torch.Generator().manual_seed(4))
    mine = tr.ResNet(**kw, device=cuda_device)
    mine.load_state_dict(ref.state_dict())
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (4,)))
    outs = []
    for m, dev in ((ref, "cpu"), (mine, cuda_device)):
        logits = m(x.to(dev), train=True)
        loss = torch.nn.functional.cross_entropy(logits, y.to(dev))
        loss.backward()
        outs.append((logits.cpu(), loss.cpu(),
                     {k: v.cpu() for k, v in m.named_buffers()},
                     {k: p.grad.cpu() for k, p in m.named_parameters()}))
    (l0, s0, b0, g0), (l1, s1, b1, g1) = outs
    torch.testing.assert_close(l1, l0, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s1, s0, rtol=2e-4, atol=2e-4)
    for k in b0:
        torch.testing.assert_close(b1[k], b0[k], rtol=2e-4, atol=2e-4)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=2e-3, atol=2e-4)


@pytest.mark.gpu
def test_sync_bn_resnet50_trains_through_nccl(cuda_device):
    """Two bf16 synchronized-batch-norm steps of ResNet-50 in an NCCL
    world of one: finite losses, finite gradients, and one statistics
    allreduce forward and one backward per batch norm (53) a step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import sync_batch_norm as sbn
    from horovod_tpu_torch.examples import synthetic_benchmark as sb
    n0 = dict(sbn.STATS_ALLREDUCES)
    try:
        model, step = sb.build(sb.parse_args(
            ["--batch-size", "8", "--image-size", "64", "--fast-stem"]))
        assert torch.distributed.get_backend() == "nccl"
        losses = [float(step()) for _ in range(2)]
        assert all(bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())
    finally:
        hvd.shutdown()
    assert np.all(np.isfinite(losses))
    assert {k: sbn.STATS_ALLREDUCES[k] - n0[k] for k in n0} == {
        "forward": 106, "backward": 106}


# -- the collective API over NCCL in a world of one --------------------------

COLLECTIVE_DTYPES = [torch.float32, torch.bfloat16, torch.float16,
                     torch.int32, torch.int64, torch.bool]


@pytest.fixture()
def nccl_world(cuda_device):
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        assert torch.distributed.get_backend() == "nccl"
        yield hvd
    finally:
        hvd.shutdown()


def _same(got, want):
    assert got.is_cuda and got.dtype == want.dtype
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", COLLECTIVE_DTYPES, ids=str)
def test_nccl_collectives_in_a_world_of_one(nccl_world, cuda_device, dtype):
    """Every new op on a CUDA tensor gives what a world of one must: its
    input (scaled for the reductions), on the card."""
    hvd = nccl_world
    ps = hvd.add_process_set([0])
    assert hvd.partition_process_sets(1)[0] is ps
    x = (torch.arange(15, device=cuda_device).reshape(5, 3) % 4).to(dtype)
    _same(hvd.allgather(x), x)
    _same(hvd.allgather(x[:0], process_set=ps), x[:0])
    _same(hvd.grouped_allgather([x, x[:2]])[1], x[:2])
    _same(hvd.alltoall(x, process_set=ps), x)
    out, recv = hvd.alltoall(x, splits=[5])
    _same(out, x)
    _same(recv, torch.tensor([5], dtype=torch.int32))
    t = x.clone()
    assert hvd.broadcast_(t, 0, process_set=ps) is t
    _same(t, x)
    h = hvd.broadcast_async(x, 0)
    hvd.poll(h)
    _same(hvd.synchronize(h), x)
    with pytest.raises(ValueError, match="already-synchronized"):
        hvd.synchronize(h)
    if dtype == torch.bool:
        _same(hvd.allreduce(x, op=hvd.Sum), x.to(torch.int32))  # counts
        with pytest.raises(TypeError):
            hvd.reducescatter(x)
        return
    want = x * 3
    for op in (hvd.Sum, hvd.Average):
        _same(hvd.reducescatter(x, op=op, postscale_factor=3.0,
                                process_set=ps), want.to(dtype))
        t = x.clone()
        assert hvd.allreduce_(t, op=op, postscale_factor=3.0) is t
        _same(t, want.to(dtype))
    _same(hvd.synchronize(hvd.reducescatter_async(x)), x)
    ts = [x.clone(), x[:1].clone()]
    h = hvd.grouped_allreduce_async_(ts, op=hvd.Sum, process_set=ps)
    outs = hvd.synchronize(h)
    assert outs[0] is ts[0]
    _same(outs[1], x[:1])


@pytest.mark.gpu
def test_nccl_object_helpers_keep_their_bytes_on_the_card(
        nccl_world, monkeypatch):
    hvd = nccl_world
    from horovod_tpu_torch import functions
    seen = []
    real = functions._ops.broadcast

    def spy(t, *args, **kwargs):
        seen.append(t.device.type)
        return real(t, *args, **kwargs)

    monkeypatch.setattr(functions._ops, "broadcast", spy)
    obj = {"a": [1, 2.5, None], "b": {"c": (3, "d")}}
    assert hvd.broadcast_object(obj) == obj
    assert hvd.broadcast_object_fn(root_rank=0)(obj) == obj
    assert seen == ["cuda"] * 4          # size and payload, twice
    assert hvd.allgather_object(obj) == [obj]


@pytest.mark.gpu
def test_nccl_sparse_allreduce_and_optimizer_over_a_set(nccl_world,
                                                        cuda_device):
    hvd = nccl_world
    dense = torch.zeros(6, 4, device=cuda_device)
    dense[[0, 2, 5], [1, 1, 3]] = torch.tensor([1.5, -2.0, 4.0],
                                               device=cuda_device)
    ps = hvd.add_process_set([0])
    out = hvd.sparse_allreduce(dense.to_sparse(), op=hvd.Average,
                               process_set=ps)
    assert out.is_sparse and out.is_cuda
    _same(hvd.densify_if_sparse(out), dense)
    w = torch.nn.Parameter(torch.ones(4, device=cuda_device))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.5),
                                   process_set=ps)
    w.grad = torch.arange(4.0, device=cuda_device)
    opt.step()
    _same(w.detach(), 1 - 0.5 * torch.arange(4.0, device=cuda_device))


@pytest.mark.gpu
def test_a_cuda_tensor_in_a_gloo_world_raises(cuda_device):
    """Gloo takes some CUDA tensors; the port refuses them rather than
    move a card's collective through the host."""
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        x = torch.ones(4, device=cuda_device)
        for call in (lambda: hvd.allreduce(x), lambda: hvd.allgather(x),
                     lambda: hvd.broadcast(x, 0),
                     lambda: hvd.reducescatter(x)):
            with pytest.raises(RuntimeError, match="nccl"):
                call()
    finally:
        hvd.shutdown()


# -- Adasum and the gradient layer (chip_smoke.py phase 8's checks) -----------

@pytest.mark.gpu
def test_adasum_combine_on_the_card_matches_the_float64_model(cuda_device):
    """``pair_combine`` and the tree of 4 correlated ranks on CUDA
    tensors, f32 (f32 and f64 islands) and bf16, against the float64
    model on the CPU at phase 8's tolerances, at small shapes; a plain
    Sum and a combine without the factor 2 fail the same check."""
    import chip_smoke
    failures, lines = chip_smoke.adasum_checks(
        torch, cuda_device, {"[257, 64]": (257, 64), "[64, 256]": (64, 256)})
    assert not failures, "\n".join(lines)


@pytest.mark.gpu
def test_nccl_adasum_and_the_gradient_layer_in_a_world_of_one(nccl_world,
                                                              cuda_device):
    """In a world of one, Adasum gives its input on the card in every
    form; ``DistributedOptimizer(op=Adasum)``,
    ``PartialDistributedOptimizer`` and ``adasum_delta_step`` step as a
    plain SGD step (the delta step within rounding), and
    ``value_and_grad`` gives autograd's gradients."""
    hvd = nccl_world
    x = torch.randn(50, 3, device=cuda_device)
    _same(hvd.allreduce(x, op=hvd.Adasum), x)
    _same(hvd.allreduce(x.bfloat16(), op=hvd.Adasum), x.bfloat16())
    _same(hvd.grouped_allreduce([x, x[:2]], op=hvd.Adasum)[1], x[:2])
    t = x.clone()
    assert hvd.allreduce_(t, op=hvd.Adasum) is t
    _same(t, x)
    _same(hvd.synchronize(hvd.allreduce_async(x, op=hvd.Adasum)), x)
    model = torch.nn.Linear(3, 2, device=cuda_device)
    start = [p.detach().clone() for p in model.parameters()]
    g = [torch.randn_like(p) for p in model.parameters()]
    want = [p - 0.5 * q for p, q in zip(start, g)]
    for make in (
            lambda sgd: hvd.DistributedOptimizer(sgd, op=hvd.Adasum),
            lambda sgd: hvd.PartialDistributedOptimizer(
                sgd, lambda name, p: name == "1"),
            lambda sgd: sgd):
        with torch.no_grad():
            for p, s in zip(model.parameters(), start):
                p.copy_(s)
        sgd = torch.optim.SGD(model.parameters(), lr=0.5)
        opt = make(sgd)
        for p, q in zip(model.parameters(), g):
            p.grad = q.clone()
        if opt is sgd:
            hvd.adasum_delta_step(sgd)
        else:
            opt.step()
        for p, w in zip(model.parameters(), want):
            assert p.is_cuda
            torch.testing.assert_close(p.detach(), w, rtol=1e-6, atol=1e-6)

    def loss(params, xb):
        return (torch.func.functional_call(model, params, (xb,)) ** 2).mean()

    params = dict(model.named_parameters())
    value, grads = hvd.value_and_grad(loss)(params, x)
    model.zero_grad()
    loss(params, x).backward()
    for k, p in params.items():
        assert grads[k].is_cuda
        torch.testing.assert_close(grads[k], p.grad)


@pytest.mark.gpu
def test_gpt2_adasum_example_trains_on_the_card(cuda_device):
    """The example at its TINY size (f32, flash attention: the 3xTF32
    kernels), 4 steps over NCCL in a world of one: the loss falls and
    each flash kernel launched once per layer and step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import gpt2_adasum as ga
    n0 = dict(tfl.LAUNCHES)
    try:
        losses, _ = ga.main(["--size", "tiny", "--steps", "4",
                             "--attention", "flash", "--seq-len", "64"])
    finally:
        hvd.shutdown()
    got = {k: tfl.LAUNCHES[k] - n0[k] for k in n0}
    L = ga.TINY.num_layers
    assert losses[-1] < losses[0]
    assert got["flash_fwd_tf32x3"] == got["flash_bwd_dq_tf32x3"] == \
        got["flash_bwd_dkv_tf32x3"] == 4 * L, got


# -- The eager engine on the card (chip_smoke.py phase 9's checks) -----------

@pytest.mark.gpu
def test_nccl_allreduce_writes_its_timeline(nccl_world, cuda_device,
                                            tmp_path):
    """One NCCL allreduce through the engine: its NEGOTIATE and op spans
    (host enqueue), every B with its E, no event dropped."""
    import json
    hvd = nccl_world
    path = tmp_path / "timeline.json"
    eng = hvd.core._state.engine
    n = eng.dispatches
    hvd.start_timeline(str(path))
    out = hvd.allreduce(torch.ones(8, device=cuda_device), name="tl.grad",
                        op=hvd.Sum)
    hvd.stop_timeline()
    _same(out, torch.ones(8, device=cuda_device))
    assert eng.dispatches == n + 1
    events = json.load(open(path))
    spans = [(e["name"], e["ph"]) for e in events if e.get("tid") == "tl.grad"]
    assert spans == [("NEGOTIATE_ALLREDUCE", "B"), ("0", "i"),
                     ("NEGOTIATE_ALLREDUCE", "E"), ("ALLREDUCE", "B"),
                     ("ALLREDUCE", "E")]
    assert events[-1]["args"] == {"dropped": 0}


@pytest.mark.gpu
def test_join_and_hierarchical_allreduce_in_a_world_of_one(nccl_world,
                                                           cuda_device):
    hvd = nccl_world
    assert hvd.join() == 0
    x = torch.randn(1001, device=cuda_device)
    _same(hvd.hierarchical_allreduce(x, local_size=1),
          hvd.allreduce(x, op=hvd.Sum))
    with pytest.raises(ValueError, match="SUM and AVERAGE"):
        hvd.hierarchical_allreduce(x, op=hvd.Max, local_size=1)


@pytest.mark.gpu
def test_a_distributed_optimizer_step_is_one_engine_dispatch(nccl_world,
                                                             cuda_device):
    """The optimizer's one fusion bucket (every f32 gradient, below the
    threshold) is one engine dispatch, under the bucket's name."""
    hvd = nccl_world
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 4)).to(cuda_device)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    model(torch.randn(5, 8, device=cuda_device)).sum().backward()
    eng = hvd.core._state.engine
    n = eng.dispatches
    opt.step()
    assert eng.dispatches == n + 1
    assert all(torch.isfinite(p).all() for p in model.parameters())


# ---------------------------------------------------------------------------
# Sequence parallelism on the card (chip_smoke.py phase 10): the f32 hop
# kernels at a 2- and a 4-card ring's hop shapes, and the ring's own hop
# code over virtual shards against flash attention over the whole
# sequence, at the f32 flash tolerances.
# ---------------------------------------------------------------------------

from horovod_tpu_torch.parallel import ring as tring  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("s_local", [2048, 4096])
@pytest.mark.parametrize("mode", [tfl.MASK_STRICT, tfl.MASK_NONE])
def test_f32_hop_kernels_at_the_ring_hop_shape(cuda_device, mode, s_local):
    """A 4- and a 2-card ring's hop at GPT-2 small, 8192 tokens:
    [1, 2048 | 4096, 12, 64] f32 (the 3xTF32 route), STRICT (the striped
    ring's off-diagonal hops) and NONE."""
    rng = np.random.RandomState(21 + mode)
    shape = (1, s_local, 12, 64)
    q, k, v, do = _flash_inputs(rng, shape, torch.float32, cuda_device)
    scale = 1.0 / np.sqrt(shape[-1])
    out, lse = _check_fwd(q, k, v, mode, scale, torch.float32)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    _check_bwd(q, k, v, do, lse, delta, mode, scale, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("striped", [False, True])
def test_virtual_ring_matches_flash_attention(cuda_device, striped):
    """4 virtual shards of [1, 512, 4, 64] f32 through the ring's own hop
    code (``ring.virtual_ring_flash_attention``, phase 10 (b)): the
    merged output and dq, dk, dv against flash_attention over the whole
    sequence; each hop ran the 3xTF32 kernels, by the wrappers' counts
    n(n+1)/2 hops contiguous (n(n-1)/2 NONE, n CAUSAL), n² striped
    (n(n+1)/2 CAUSAL, n(n-1)/2 STRICT)."""
    rng = np.random.RandomState(5 + striped)
    q0, k0, v0, do = _flash_inputs(rng, (1, 512, 4, 64), torch.float32,
                                   cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q0, k0, v0)]
    want = tfl.flash_attention(*leaves, causal=True)
    want_g = torch.autograd.grad(want, leaves, do)
    leaves = [t.clone().requires_grad_() for t in (q0, k0, v0)]
    n0, m0 = dict(tfl.LAUNCHES), dict(tfl.LAUNCHES_BY_MODE)
    out = tring.virtual_ring_flash_attention(*leaves, 4, causal=True,
                                             striped=striped)
    got_g = torch.autograd.grad(out, leaves, do)
    (frt, fat), (grt, gat) = _TOL[torch.float32]
    _assert_close(out.detach(), want.detach(), frt, fat, msg="out")
    for g, w, name in zip(got_g, want_g, "qkv"):
        _assert_close(g, w, grt, gat, msg=f"d{name}")
    modes = {"none": 0, "causal": 10, "strict": 6} if striped else \
        {"none": 6, "causal": 4, "strict": 0}
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert tfl.LAUNCHES[f"{kernel}_tf32x3"] == \
            n0[f"{kernel}_tf32x3"] + sum(modes.values())
        for m, c in modes.items():
            assert tfl.LAUNCHES_BY_MODE[f"{kernel}_tf32x3_{m}"] == \
                m0[f"{kernel}_tf32x3_{m}"] + c
        assert tfl.LAUNCHES[f"{kernel}_wgmma"] == n0[f"{kernel}_wgmma"]


@pytest.mark.gpu
def test_ring_and_ulysses_gpt2_in_a_world_of_one(nccl_world, cuda_device):
    """A world of one over NCCL: the ring is one CAUSAL hop on the f32
    route, Ulysses the bf16 wgmma kernels; both give plain flash
    attention's logits within the bf16 flash tolerance."""
    from horovod_tpu_torch.models import create_gpt2
    toks = torch.as_tensor(np.random.RandomState(2).randint(
        0, 97, (1, 256)), device=cuda_device)
    kw = dict(num_layers=2, num_heads=4, d_model=256, d_ff=512,
              vocab_size=97, max_len=256, attention_impl="flash",
              dtype=torch.bfloat16)
    with torch.no_grad():
        want = create_gpt2("small", device=cuda_device, seed=3, **kw)(toks)
    for sp, route in (("ring", "tf32x3"), ("ulysses", "wgmma")):
        model = create_gpt2("small", device=cuda_device, seed=3,
                            seq_parallel=sp, **kw)
        n0 = dict(tfl.LAUNCHES)
        logits = model(toks)
        logits.float().sum().backward()
        torch.testing.assert_close(logits, want, rtol=0.1, atol=0.05)
        for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert tfl.LAUNCHES[f"{kernel}_{route}"] == \
                n0[f"{kernel}_{route}"] + 2


@pytest.mark.gpu
def test_moe_ffn_on_the_card_matches_the_cpu(cuda_device):
    """``expert_parallel_ffn(axis_name=None)`` on the card against the
    same call on the CPU, with claims dropped: the output, aux loss,
    dropped share and gradients, f32, at the JAX MoE tolerance."""
    from horovod_tpu_torch.parallel import moe
    rng = np.random.RandomState(4)
    arrays = [rng.randn(256, 64), rng.randn(64, 8) * 2.0,
              rng.randn(8, 64, 128) * 0.1, rng.randn(8, 128, 64) * 0.1]
    w = torch.from_numpy(rng.randn(256, 64).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        leaves = [torch.from_numpy(a.astype(np.float32)).to(dev)
                  .requires_grad_() for a in arrays]
        res = moe.expert_parallel_ffn(*leaves, axis_name=None, top_k=2,
                                      capacity_factor=0.75)
        (torch.sum(res.out * w.to(dev)) + res.aux_loss).backward()
        out[str(dev)] = [res.out, res.aux_loss, res.dropped_frac] + \
            [t.grad for t in leaves]
    assert float(out["cpu"][2]) > 0.0
    for got, want in zip(out[str(cuda_device)], out["cpu"]):
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_moe_gpt2_in_a_world_of_one(nccl_world, cuda_device):
    """An expert-sharded MoE GPT-2 (dp 1 × ep 1) over NCCL: f32 flash
    logits equal dense attention's within 2e-3 with every token on all
    experts (a top-2 choice would flip at a near-tie between the two
    attentions), and a bf16 step through
    ``DistributedOptimizer(reduce_axes=("dp", "ep"))`` launches each
    wgmma kernel once per block and records one aux loss per MoE
    block."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import create_gpt2, lm_loss
    from horovod_tpu_torch.parallel import make_mesh
    make_mesh({"dp": 1, "ep": 1})
    kw = dict(num_layers=4, num_heads=4, d_model=256, d_ff=512,
              vocab_size=97, max_len=256, moe_experts=8, expert_axis="ep")
    toks = torch.as_tensor(np.random.RandomState(5).randint(
        0, 97, (2, 257)), device=cuda_device)
    with torch.no_grad():
        a, b = (create_gpt2("small", device=cuda_device, seed=4,
                            dtype=torch.float32, attention_impl=impl,
                            **dict(kw, moe_top_k=8))(toks[:, :-1])
                for impl in ("flash", None))
    torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
    model = create_gpt2("small", device=cuda_device, seed=4,
                        attention_impl="flash", **kw)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters(),
                                                     lr=1e-4),
                                   reduce_axes=("dp", "ep"))
    n0 = dict(tfl.LAUNCHES)
    loss = lm_loss(model(toks[:, :-1]), toks[:, 1:]) + \
        0.01 * sum(model.aux_losses)
    loss.backward()
    opt.step()
    assert len(model.aux_losses) == 2 and torch.isfinite(loss)
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert tfl.LAUNCHES[f"{kernel}_wgmma"] == n0[f"{kernel}_wgmma"] + 4


@pytest.mark.gpu
def test_pipeline_tensor_and_dryrun_steps_in_a_world_of_one(nccl_world,
                                                            cuda_device):
    """A one-stage ``gpipe_spmd`` and a one-shard
    ``column_row_parallel_mlp`` on the card equal their plain
    computations (outputs and gradients), and phases 3-5 of
    ``dryrun_multichip`` run over NCCL."""
    from horovod_tpu_torch import entry
    from horovod_tpu_torch.parallel import make_mesh, pipeline, tensor
    make_mesh({"pp": 1})
    make_mesh({"tp": 1})
    rng = np.random.RandomState(6)
    w = torch.from_numpy((rng.randn(1, 32, 32) * 0.3).astype(np.float32)
                         ).to(cuda_device).requires_grad_()
    xs = torch.from_numpy(rng.randn(4, 2, 32).astype(np.float32)).to(
        cuda_device)
    ys = pipeline.gpipe_spmd(lambda p, x: torch.tanh(x @ p[0]), w, xs)
    ys.square().mean().backward()
    w2 = w.detach().clone().requires_grad_()
    want = torch.tanh(xs @ w2[0])
    want.square().mean().backward()
    torch.testing.assert_close(ys, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-4, atol=1e-6)
    x = torch.from_numpy(rng.randn(64, 32).astype(np.float32)).to(
        cuda_device).requires_grad_()
    c = torch.from_numpy((rng.randn(32, 128) * 0.1).astype(np.float32)).to(
        cuda_device).requires_grad_()
    r = torch.from_numpy((rng.randn(128, 32) * 0.1).astype(np.float32)).to(
        cuda_device).requires_grad_()
    y = tensor.column_row_parallel_mlp(x, c, r)
    g = torch.autograd.grad(y.sum(), (x, c, r))
    want = tensor.gelu(x @ c) @ r
    gw = torch.autograd.grad(want.sum(), (x, c, r))
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-5)
    for a, b in zip(g, gw):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    for step in (entry.dryrun_moe_step, entry.dryrun_pp_step,
                 entry.dryrun_tp_step):
        assert np.isfinite(step()[0])


ELASTIC_NCCL_WORKER = '''
import gc, weakref
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd

hvd.init()
first = weakref.ref(dist.group.WORLD)
model = torch.nn.Linear(8, 8, device=hvd.device())
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
state = hvd.elastic.TorchState(model, opt, batch=0)
raised = []


@hvd.elastic.run
def train(state):
    while state.batch < 6:
        opt.zero_grad()
        model(torch.ones(4, 8, device=hvd.device())).sum().backward()
        opt.step()
        state.batch += 1
        state.commit()
        if state.batch == 3 and not raised:
            raised.append(1)
            raise hvd.HorovodInternalError("simulated fault")


train(state)
gc.collect()
print(f"RESET DONE batches={state.batch} old_group_freed={first() is None} "
      f"world={dist.get_backend()}", flush=True)
'''


@pytest.mark.gpu
def test_elastic_in_place_reset_aborts_and_frees_the_nccl_group(
        cuda_device, tmp_path):
    """An in-place reset of an elastic NCCL world through the port's
    launcher: ``shutdown`` aborts the communicators, the old group is
    freed, and the new world trains on."""
    import os
    import subprocess
    import sys
    disc = tmp_path / "discover.sh"
    disc.write_text("#!/bin/sh\necho localhost:1\n")
    disc.chmod(0o755)
    worker = tmp_path / "worker.py"
    worker.write_text(ELASTIC_NCCL_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "--min-np", "1", "--max-np", "1", "--host-discovery-script",
         str(disc), sys.executable, str(worker)],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "RESET DONE batches=6 old_group_freed=True world=nccl" in \
        proc.stdout, proc.stdout[-3000:]


# -- the request surface on the kernels ----------------------------------------

def _surface_model(dev, seed=0, spread=True):
    model = init_gpt2_(Transformer(_TINY, device=dev),
                       torch.Generator(device=dev).manual_seed(seed))
    if spread:
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(10.0)   # spread the logits so the streams vary
    return model


def _prefilled(ad, prompts, nb=24):
    """``prompts`` prefilled into a fresh pool of ``ad``, blocks dealt in
    order; returns the pool and the tables."""
    tables, nxt = [], 0
    for p in prompts:
        need = -(-(len(p) + 2) // ad.block_tokens)
        tables.append(list(range(nxt, nxt + need)))
        nxt += need
    pool = ad.init_paged_cache(nb, 4)
    pool, _ = ad.prefill_chunk(pool, prompts, [0] * len(prompts), tables)
    return pool, tables


@pytest.mark.gpu
def test_score_and_decode_logits_on_the_kernels_match_the_plain_route(
        cuda_device):
    """``score_logits`` runs one chunk, the prefill route once per layer
    (the decode route for a single token), and ``decode_paged_logits``
    the decode route once per layer; both
    agree with the plain route on the card (at GPT-2's init scale: the
    tolerance is the paged one)."""
    model = _surface_model(cuda_device, spread=False)
    kad, gad = (TransformerAdapter(_TINY, model, block_tokens=8,
                                   attn_impl=impl, device=cuda_device)
                for impl in ("kernel", "gather"))
    L = _TINY.num_layers
    for n in (1, 8, 29, _TINY.max_len):
        toks = np.random.RandomState(n).randint(0, 61, (n,)).tolist()
        before = dict(tpa.LAUNCHES)
        got = kad.score_logits(toks)
        # One query row takes the decode route, a longer chunk prefill.
        route = "decode" if n == 1 else "prefill"
        assert tpa.LAUNCHES[f"paged_attention_{route}"] - \
            before[f"paged_attention_{route}"] == L
        assert tpa.LAUNCHES["paged_attention"] - \
            before["paged_attention"] == L
        np.testing.assert_allclose(got, gad.score_logits(toks), rtol=RTOL,
                                   atol=ATOL)
    prompts = [np.random.RandomState(n).randint(0, 61, (n,)).tolist()
               for n in (7, 8, 17)]
    kpool, tables = _prefilled(kad, prompts)
    gpool, _ = _prefilled(gad, prompts)
    tab = np.full((4, kad.max_blocks_per_seq), 24)
    for i, t in enumerate(tables):
        tab[i, :len(t)] = t
    tokens = np.array([3, 5, 7, 0])
    positions = np.array([len(p) for p in prompts] + [0])
    before = tpa.LAUNCHES["paged_attention_decode"]
    _, got = kad.decode_paged_logits(kpool, tokens, positions, tab)
    assert tpa.LAUNCHES["paged_attention_decode"] - before == L
    _, want = gad.decode_paged_logits(gpool, tokens, positions, tab)
    np.testing.assert_allclose(got[:3], want[:3], rtol=RTOL, atol=ATOL)
    _, greedy = kad.decode_paged(kpool, tokens, positions, tab)
    assert list(greedy[:3]) == list(got[:3].argmax(-1))


@pytest.mark.gpu
def test_warmup_builds_the_kernels_and_leaves_the_pool_empty(cuda_device):
    """Warmup runs both routes (the library is built and loaded before
    the loop serves), allocates no block, and the first request after
    it answers as a cold engine does."""
    from horovod_tpu_torch.csrc import build
    model = _surface_model(cuda_device, seed=1)

    def engine(warm):
        ad = TransformerAdapter(_TINY, model, block_tokens=8,
                                device=cuda_device)
        return InferenceEngine(ad, max_batch=4, prefill_chunk=16,
                               warmup=warm, metrics=ServeMetrics(),
                               replica_id=f"warm-{warm}")

    warm = engine(True)
    before = dict(tpa.LAUNCHES)
    warm.start()
    try:
        assert warm.warmup_runs == 1 and warm.last_warmup_ms > 0
        assert build._lib is not None
        for route in ("paged_attention_decode", "paged_attention_prefill"):
            assert tpa.LAUNCHES[route] > before[route], route
        stats = warm.kv_stats()
        assert stats["used"] == 0 and stats["retained"] == 0
        cold = engine(False).start()
        try:
            prompt = list(range(5, 30))
            assert warm.generate(prompt, max_new_tokens=6) == \
                cold.generate(prompt, max_new_tokens=6)
        finally:
            cold.stop()
    finally:
        warm.stop()


@pytest.mark.gpu
def test_two_model_decode_step_leaves_the_other_models_blocks_untouched(
        cuda_device):
    """One pool, two models: a decode step of model A over its row (the
    other rows all holes) changes no block of model B's sequence, and
    the engine serving both at once answers each as a one-model engine
    does."""
    base = _surface_model(cuda_device, seed=2)
    variant = _surface_model(cuda_device, seed=3)
    ad_a, ad_b = (TransformerAdapter(_TINY, m, block_tokens=8,
                                     device=cuda_device)
                  for m in (base, variant))
    pa_, pb_ = [1, 2, 3, 4, 5, 6, 7, 8, 9], [9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 3]
    pool = ad_a.init_paged_cache(24, 4)
    pool, _ = ad_a.prefill_chunk(pool, [pa_], [0], [[0, 1]])
    pool, _ = ad_b.prefill_chunk(pool, [pb_], [0], [[2, 3]])
    tab = np.full((4, ad_a.max_blocks_per_seq), 24)
    tab[0, :2] = [0, 1]
    snap = {k: v[:, 2:4].clone() for k, v in pool.items()}
    pool, _ = ad_a.decode_paged_logits(pool, np.array([4, 0, 0, 0]),
                                       np.array([len(pa_), 0, 0, 0]), tab)
    for k, v in pool.items():
        assert torch.equal(v[:, 2:4], snap[k]), k
    eng = InferenceEngine(ad_a, max_batch=4, prefill_chunk=5,
                          metrics=ServeMetrics())
    eng.add_model("variant", ad_b)
    alone = [InferenceEngine(ad, max_batch=4, prefill_chunk=5,
                             metrics=ServeMetrics()).start()
             for ad in (ad_a, ad_b)]
    eng.start()
    try:
        reqs = [Request(p, max_new_tokens=6, model=m)
                for p in (pa_, pb_) for m in (None, "variant")]
        for r in reqs:
            eng.batcher.submit(r)
        got = [r.result(timeout=120) for r in reqs]
        want = [alone[m is not None].generate(p, max_new_tokens=6)
                for p in (pa_, pb_) for m in (None, "variant")]
        assert got == want
        assert eng.kv_stats()["used"] == 0
    finally:
        eng.stop()
        for e in alone:
            e.stop()


def _card_endpoint(model, dev, rid):
    from horovod_tpu_torch.serve import (Replica, ReplicaScheduler,
                                         ServeServer)
    eng = InferenceEngine(TransformerAdapter(_TINY, model, block_tokens=8,
                                             device=dev),
                          max_batch=4, prefill_chunk=16,
                          metrics=ServeMetrics(), replica_id=rid)
    srv = ServeServer(ReplicaScheduler([Replica(rid, None, eng)]))
    return srv, srv.start(port=0, host="127.0.0.1")


def _route_post(port, payload, headers=None):
    import http.client
    import json
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/generate", json.dumps(payload).encode(),
                     dict({"Content-Type": "application/json"},
                          **(headers or {})))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.mark.gpu
def test_router_over_two_card_endpoints_answers_as_one_engine(cuda_device):
    """The port's router in front of two endpoints on the card: every
    greedy and seeded answer equals a single engine's on the card,
    whichever endpoint served it."""
    from horovod_tpu_torch.serve import Router, RouterConfig, RouterServer
    model = _surface_model(cuda_device, seed=4)
    servers = [_card_endpoint(model, cuda_device, f"card-{i}")
               for i in range(2)]
    eps = [f"127.0.0.1:{port}" for _, port in servers]
    router = Router(eps, config=RouterConfig(block_tokens=8))
    rsrv = RouterServer(router)
    rport = rsrv.start(port=0, host="127.0.0.1")
    ref = InferenceEngine(TransformerAdapter(_TINY, model, block_tokens=8,
                                             device=cuda_device),
                          max_batch=4, prefill_chunk=16,
                          metrics=ServeMetrics()).start()
    try:
        rng = np.random.RandomState(8)
        served = set()
        for i in range(12):
            p = rng.randint(0, 61, (int(rng.randint(5, 40)),)).tolist()
            body = {"tokens": p, "max_new_tokens": 6}
            if i % 2:
                body.update(temperature=0.8, top_k=20, seed=i)
            status, out = _route_post(rport, body)
            assert status == 200, out
            r = Request(p, max_new_tokens=6,
                        **({} if i % 2 == 0 else
                           dict(temperature=0.8, top_k=20, seed=i)))
            ref.batcher.submit(r)
            assert out["tokens"] == r.result(timeout=120), i
            served.add(out["replica"])
        assert served == {"card-0", "card-1"}
        assert router.metrics.snapshot()["requests"]["ok"] == 12
    finally:
        ref.stop()
        rsrv.stop()
        for srv, _ in servers:
            srv.stop()


@pytest.mark.gpu
def test_traced_request_tree_reaches_the_engine_on_the_card(cuda_device):
    """A request traced through the router and a card endpoint: the
    tracer's tree holds the router's root, its route span and the
    endpoint's request span under it, with the endpoint's queue-wait,
    prefill-chunk and decode spans under that, and the kernels ran for
    it."""
    import time
    from horovod_tpu_torch.obs import tracing as tr
    from horovod_tpu_torch.serve import Router, RouterConfig, RouterServer
    tracer = tr.install(tr.Tracer(sample=1.0))
    model = _surface_model(cuda_device, seed=5)
    srv, port = _card_endpoint(model, cuda_device, "card-0")
    rsrv = RouterServer(Router([f"127.0.0.1:{port}"],
                               config=RouterConfig(block_tokens=8)))
    rport = rsrv.start(port=0, host="127.0.0.1")
    try:
        before = dict(tpa.LAUNCHES)
        status, _ = _route_post(rport, {"tokens": list(range(3, 40)),
                                        "max_new_tokens": 5},
                                {"X-Trace-Id": "feedfacefeedface"})
        assert status == 200
        for route in ("paged_attention_decode", "paged_attention_prefill"):
            assert tpa.LAUNCHES[route] > before[route], route
        deadline = time.monotonic() + 30
        while True:
            (item,) = [t for t in tracer.recent_traces()
                       if t["trace_id"] == "feedfacefeedface"]
            names = []

            def walk(n, depth):
                names.append((depth, n["name"], n["proc"]))
                for c in n["children"]:
                    walk(c, depth + 1)
            for n in item["tree"]:
                walk(n, 0)
            if any(x[1] == "decode" for x in names) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
        (root,) = item["tree"]
        assert (root["name"], root["proc"]) == ("http-handle", "router")
        # The endpoint's root continues the router's (X-Parent-Span is
        # the router's root span), beside the router's route span.
        assert {(d, n, p) for d, n, p in names} >= {
            (1, "route", "router"), (1, "http-handle", "server"),
            (2, "queue-wait", "card-0"), (2, "prefill-chunk", "card-0"),
            (2, "decode", "card-0")}
    finally:
        rsrv.stop()
        srv.stop()
        tr.uninstall()


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["native", "int8", "fp8"])
def test_tier_round_trip_on_card_pools(cuda_device, kv):
    """A block of a card pool copied out by ``make_block_io``, through the
    tier codec and back into another block is bit-equal in every leaf
    (scale rows included); a tiered engine on the card, swapping under
    pool pressure, answers as an untiered one and holds more requests."""
    from horovod_tpu_torch.serve import Request, TierConfig
    from horovod_tpu_torch.serve.tiering import (make_block_io,
                                                 pack_payload,
                                                 unpack_payload)
    model = _surface_model(cuda_device, seed=5)

    def engine(**kw):
        ad = TransformerAdapter(_TINY, model, block_tokens=8, kv_dtype=kv,
                                device=cuda_device)
        return InferenceEngine(ad, max_batch=8, prefill_chunk=16,
                               num_blocks=8, metrics=ServeMetrics(), **kw)

    eng = engine(tiering=TierConfig(oversub=4.0, quantum=2))
    eng._cache, _ = eng.adapter.prefill_chunk(
        eng._cache, [list(range(3, 20))], [0], [[0, 1, 2]])
    extract, insert = make_block_io(eng)
    before = extract(1)
    insert(5, unpack_payload(pack_payload(before)))
    for key, a in eng._cache.items():
        assert a.is_cuda
        assert torch.equal(a[:, 5], a[:, 1]), key
        assert torch.equal(a[:, 1].cpu(), before[key]), key
    prompts = [np.random.RandomState(60 + i).randint(0, 61, (10,)).tolist()
               for i in range(6)]
    base, tiered = engine().start(), engine(
        tiering=TierConfig(oversub=4.0, quantum=2)).start()
    try:
        want = [base.generate(p, max_new_tokens=12) for p in prompts]
        reqs = [Request(p, max_new_tokens=12) for p in prompts]
        for r in reqs:
            tiered.batcher.submit(r)
        assert [r.result(timeout=120) for r in reqs] == want
        st = tiered.kv_stats()["tier"]
        assert st["inflight_peak"] > 2   # untiered: 2 lifetimes of 3 blocks
        assert st["spill_bytes"] > 0 and st["promote_bytes"] > 0
    finally:
        base.stop()
        tiered.stop()


@pytest.mark.gpu
@pytest.mark.parametrize("plen", [23, 24, 25, 56])
def test_sp_prefill_on_the_card_matches_single_rank(cuda_device, plen):
    """SP prefill over 4 emulated ranks on the card gives single-rank
    prefill's tokens (decode over the handed-off blocks on the decode
    route), and ``sp_prefill_chunk`` on the card agrees with the CPU's
    (logits 2e-3 / 2e-3, written K/V 2e-4 / 2e-5)."""
    model = _surface_model(cuda_device, seed=6)
    prompt = np.random.RandomState(plen).randint(0, 61, (plen,)).tolist()

    def run(**kw):
        ad = TransformerAdapter(_TINY, model, block_tokens=8,
                                device=cuda_device)
        eng = InferenceEngine(ad, max_batch=8, prefill_chunk=5,
                              prefix_cache=False, metrics=ServeMetrics(),
                              **kw).start()
        try:
            return eng.generate(prompt, max_new_tokens=6), eng.kv_stats()
        finally:
            eng.stop()

    want, _ = run()
    before = tpa.LAUNCHES["paged_attention_decode"]
    got, stats = run(sp_ranks=4, sp_min_tokens=16)
    assert got == want
    assert stats["sp"]["jobs"] == 1 and stats["sp"]["sp_tokens"] == plen
    assert tpa.LAUNCHES["paged_attention_decode"] > before
    cpu_model = _surface_model(torch.device("cpu"), seed=6)
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    kad = TransformerAdapter(_TINY, model, block_tokens=8,
                             device=cuda_device)
    cad = TransformerAdapter(_TINY, cpu_model, block_tokens=8,
                             device="cpu")
    rng = np.random.RandomState(plen)
    hop = torch.from_numpy(rng.randn(2, 16, 2, 16).astype(np.float32))
    kpool, cpool = kad.sp_pool(8), cad.sp_pool(8)
    chunk = prompt[:6]
    kpool, klog = kad.sp_prefill_chunk(kpool, chunk, 21, 16, [3, 1, 5],
                                       hop_k=hop, hop_v=hop, hop_len=16)
    cpool, clog = cad.sp_prefill_chunk(cpool, chunk, 21, 16, [3, 1, 5],
                                       hop_k=hop, hop_v=hop, hop_len=16)
    np.testing.assert_allclose(klog, clog, rtol=2e-3, atol=2e-3)
    for key in cpool:
        np.testing.assert_allclose(kpool[key].cpu().numpy(),
                                   cpool[key].numpy(), rtol=2e-4, atol=2e-5)
