"""The port's flash attention (its plain versions, on the CPU) against the
JAX package's Pallas kernels run in interpret mode.

Tolerances are the JAX package's own (``tests/test_flash.py``): f32
forward rtol 2e-4 / atol 2e-5, f32 gradients 2e-3 / 2e-4, bf16
0.1 / 0.05.  Inputs are made with numpy from a seed and handed to both.
The CUDA kernels themselves are held against the same plain versions on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import flash as jfl
from horovod_tpu_torch.parallel import flash as tfl

torch.set_num_threads(2)

SHAPE = (2, 64, 2, 16)   # B, S, H, D
FWD, GRAD, BF16 = (2e-4, 2e-5), (2e-3, 2e-4), (0.1, 0.05)


def _inputs(seed, shape=SHAPE, n=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.5).astype(np.float32) for _ in range(n)]


def _t(arrays, dtype=torch.float32, grad=False):
    return [torch.from_numpy(a).to(dtype).requires_grad_(grad)
            for a in arrays]


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol[0], atol=tol[1], err_msg=msg)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_and_gradients_match_jax(causal):
    arrays = _inputs(0)
    jq, jk, jv = map(jnp.asarray, arrays)

    def jloss(q, k, v):
        o = jfl.flash_attention(q, k, v, causal=causal, block_q=32,
                                block_k=32)
        return jnp.sum(o * jnp.cos(o)), o

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(jq, jk, jv)
    q, k, v = _t(arrays, grad=True)
    out = tfl.flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
    (out * out.cos()).sum().backward()
    _close(out.detach(), jout, FWD)
    for t, g, name in zip((q, k, v), jgrads, "qkv"):
        _close(t.grad, g, GRAD, f"d{name}")


def test_uneven_blocks_match_jax():
    arrays = _inputs(1)

    def jloss(q, k, v):
        return jnp.sum(jfl.flash_attention(q, k, v, causal=True, block_q=64,
                                           block_k=32) ** 2)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    q, k, v = _t(arrays, grad=True)
    (tfl.flash_attention(q, k, v, causal=True, block_q=64, block_k=32) ** 2
     ).sum().backward()
    for t, g in zip((q, k, v), jgrads):
        _close(t.grad, g, GRAD)


def test_indivisible_seq_rejected_like_jax():
    x = np.ones((1, 100, 2, 16), np.float32)
    with pytest.raises(ValueError, match="divisible") as jerr:
        jfl.flash_attention(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                            block_q=64, block_k=64)
    t = torch.from_numpy(x)
    with pytest.raises(ValueError, match="divisible") as terr:
        tfl.flash_attention(t, t, t, block_q=64, block_k=64)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="flash_attention_lse requires"):
        tfl.flash_attention_lse(t, t, t, block_q=64, block_k=64)


def test_bf16_matches_jax():
    arrays = _inputs(2)
    jout = jfl.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in arrays), block_q=32, block_k=32)
    out = tfl.flash_attention(*_t(arrays, torch.bfloat16), block_q=32,
                              block_k=32)
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    _close(out.float(), np.asarray(jout, np.float32), BF16)


@pytest.mark.parametrize("mode", [jfl.MASK_NONE, jfl.MASK_CAUSAL,
                                  jfl.MASK_STRICT])
def test_lse_variant_matches_jax_with_an_lse_cotangent(mode):
    """out, lse and the gradients of a loss that reads both (ring
    attention's merge gives lse a nonzero cotangent), in every mask mode;
    STRICT's row 0 sees no key: out 0, lse the floored JAX value, and no
    gradient flows through it."""
    arrays = _inputs(3 + mode)
    w = np.random.RandomState(9).randn(SHAPE[0], SHAPE[2],
                                       SHAPE[1]).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jfl.flash_attention_lse(q, k, v, mask_mode=mode,
                                         block_q=32, block_k=16)
        # lse of a row that sees no key is ~-5e29: keep it out of the sum.
        return jnp.sum(o * jnp.cos(o)) + jnp.sum(
            jnp.where(lse > -1e20, lse, 0.0) * w), (o, lse)

    (_, (jo, jl)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, arrays))
    q, k, v = _t(arrays, grad=True)
    o, lse = tfl.flash_attention_lse(q, k, v, mask_mode=mode, block_q=32,
                                     block_k=16)
    loss = (o * o.cos()).sum() + (torch.where(
        lse > -1e20, lse, torch.zeros_like(lse)) * torch.from_numpy(w)).sum()
    loss.backward()
    assert tuple(lse.shape) == (SHAPE[0], SHAPE[2], SHAPE[1])
    _close(o.detach(), jo, FWD)
    _close(lse.detach(), jl, FWD)
    for t, g, name in zip((q, k, v), jgrads, "qkv"):
        _close(t.grad, g, GRAD, f"d{name}")
    if mode == jfl.MASK_STRICT:
        assert float(o.detach()[:, 0].abs().max()) == 0.0
        assert np.all(np.asarray(jl)[:, :, 0] == np.float32(-5e29))
        assert torch.all(lse[:, :, 0] == np.float32(-5e29))
        assert float(q.grad[:, 0].abs().max()) == 0.0


def test_lse_out_dtype_f32_over_bf16_inputs():
    arrays = _inputs(6)
    jo, jl = jfl.flash_attention_lse(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays),
        mask_mode=jfl.MASK_CAUSAL, block_q=32, block_k=32,
        out_dtype=jnp.float32)
    o, lse = tfl.flash_attention_lse(
        *_t(arrays, torch.bfloat16), mask_mode=tfl.MASK_CAUSAL, block_q=32,
        block_k=32, out_dtype=torch.float32)
    assert o.dtype == torch.float32 and jo.dtype == jnp.float32
    _close(o, jo, FWD)
    _close(lse, jl, FWD)


def test_mask_vocabulary_matches_jax():
    assert (tfl.MASK_NONE, tfl.MASK_CAUSAL, tfl.MASK_STRICT) == \
        (jfl.MASK_NONE, jfl.MASK_CAUSAL, jfl.MASK_STRICT)
    assert tfl.NEG_INF == jfl.NEG_INF
    for mode in (0, 1, 2):
        for q_lo, q_hi, k_lo in ((0, 31, 0), (0, 31, 31), (0, 31, 32),
                                 (32, 63, 0), (0, 0, 0)):
            assert tfl.block_contributes(mode, q_lo, q_hi, k_lo) == \
                bool(jfl.block_contributes(mode, q_lo, q_hi, k_lo))


def test_wrappers_take_only_cpu_or_cuda_tensors():
    t = torch.zeros((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfl.flash_fwd(t, t, t, tfl.MASK_NONE, 0.25)
