"""Tests of the port that need an NVIDIA card (marker ``gpu``).

They skip without a card, deciding inside a fixture.  The card's machine
has no JAX, so this file imports none and is run there without the
repository's ``conftest.py`` (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The CUDA paged-attention kernel is held against its plain version
(rtol 2e-4 / atol 2e-5, the JAX package's paged-attention tolerance) in
every mask mode, for f32/bf16/int8/fp8 pools and f32/bf16 queries, with
an all-hole row, a poisoned never-mapped block, and tables wide enough to
be split; the engine's kernel path gives the gather path's tokens and
batched == single on the card.
"""

import threading

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.models.transformer import init_gpt2_
from horovod_tpu_torch.serve import InferenceEngine, TransformerAdapter
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
    rng = np.random.RandomState(C * 100 + MB)
    for q_dtype in ("f32", "bf16"):
        args, kw = _card_case(rng, kv, q_dtype, C, MB, cuda_device)
        for mode in (tpa.MASK_NONE, tpa.MASK_CAUSAL, tpa.MASK_STRICT):
            before = tpa.LAUNCHES["paged_attention"]
            got = tpa.paged_prefill_attention(*args, mask_mode=mode, **kw)
            torch.cuda.synchronize()
            assert tpa.LAUNCHES["paged_attention"] == before + 1
            ref = tpa.paged_attention_reference(*args, mask_mode=mode, **kw)
            torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
            assert float(got[3].abs().max()) == 0.0


@pytest.mark.gpu
def test_cuda_decode_entry_point(cuda_device):
    rng = np.random.RandomState(3)
    (q, k, v, tables, pos), _ = _card_case(rng, "f32", "f32", 1, 21,
                                           cuda_device)
    got = tpa.paged_decode_attention(q[:, 0].contiguous(), k, v, tables, pos)
    ref = tpa.paged_attention_reference(q[:, 0], k, v, tables, pos)
    assert got.shape == ref.shape == q[:, 0].shape
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    rng = np.random.RandomState(0)
    (q, k, v, tables, starts), _ = _card_case(rng, "f32", "f32", 1, 4,
                                              cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_prefill_attention(q[..., :48].contiguous(),
                                    k[..., :48].contiguous(),
                                    v[..., :48].contiguous(), tables, starts)
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


_TINY = TransformerConfig(vocab_size=61, num_layers=2, num_heads=2,
                          d_model=32, d_ff=64, max_len=64)


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
        before = tpa.LAUNCHES["paged_attention"]
        singles = [k.generate(p, max_new_tokens=6) for p in prompts]
        assert tpa.LAUNCHES["paged_attention"] > before
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
