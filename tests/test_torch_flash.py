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


def _bhsd(x, dtype):
    """[B, S, H, D] numpy → JAX's [B·H, S, D] layout."""
    B, S, H, D = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D), dtype)


def _bshd(x, B, H):
    """JAX's [B·H, S, ...] → the port's layout: [B, S, H, D] for a tensor
    of rows, [B, H, S] for lse / delta."""
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        return torch.from_numpy(x.reshape(B, H, -1).copy())
    return torch.from_numpy(x.reshape(B, H, *x.shape[1:]).transpose(0, 2, 1, 3)
                            .copy())


@pytest.mark.parametrize("dtype,mode", [
    (dt, m) for dt in ("float32", "bfloat16")
    for m in (jfl.MASK_NONE, jfl.MASK_CAUSAL, jfl.MASK_STRICT)])
def test_backward_pair_matches_jax_run_bwd_kernels(dtype, mode):
    """The port's dQ and dK/dV functions against JAX's two backward
    kernels (``_run_bwd_kernels``, interpret mode, blocks of 16) on the
    same inputs and the lse of JAX's forward, at S = 48; the first case
    folds a nonzero lse cotangent into delta, as ``_flash_lse_bwd``
    does."""
    B, S, H, D = 2, 48, 2, 16
    q, k, v, do = _inputs(40 + mode + 3 * (dtype == "bfloat16"),
                          (B, S, H, D), 4)
    first = dtype == "float32" and mode == jfl.MASK_NONE
    g_lse = (np.random.RandomState(9).randn(B * H, S) * 0.5 if first
             else np.zeros((B * H, S))).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jdo = (_bhsd(x, jdt) for x in (q, k, v, do))
    jout, res = jfl._flash_fwd(jq, jk, jv, mode, scale, 16, 16, True)
    jlse = res[4]
    delta = jnp.sum(jdo.astype(jnp.float32) * jout.astype(jnp.float32),
                    axis=-1) - jnp.asarray(g_lse)
    jdq, jdk, jdv = jfl._run_bwd_kernels(jq, jk, jv, jdo, jlse, delta, mode,
                                         scale, 16, 16, True)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    lse, tdelta = _bshd(jlse, B, H), _bshd(delta, B, H)
    dq = tfl.flash_bwd_dq(tq, tk, tv, tdo, lse, tdelta, mode, scale)
    dk, dv = tfl.flash_bwd_dkv(tq, tk, tv, tdo, lse, tdelta, mode, scale)
    tol = GRAD if dtype == "float32" else BF16
    for got, want, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        assert got.dtype == tdt and got.shape == (B, S, H, D)
        _close(got.float(), _bshd(want, B, H), tol, name)
    if mode == jfl.MASK_STRICT:   # row 0 sees no key: no gradient
        assert float(dq[:, 0].float().abs().max()) == 0.0


def test_backward_route_is_wgmma_only_when_every_operand_is_bf16():
    b = torch.zeros((1, 8, 1, 16), dtype=torch.bfloat16)
    f = b.float()
    assert tfl.bwd_route(b, b, b, b) == "wgmma"
    for i in range(4):
        ops = [b] * 4
        ops[i] = f
        assert tfl.bwd_route(*ops) == "tf32x3"
    assert tfl.bwd_route(f, f, f, f) == "tf32x3"
    with pytest.raises(ValueError, match="dtype"):
        tfl.bwd_route(b, b, b, b.half())


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "tf32x3")])
def test_transformer_backward_takes_the_route_of_its_dtype(monkeypatch,
                                                           dtype, route):
    """The model's attention (q/k/v views of the fused qkv projection,
    ``models/transformer.py``) hands the backward pair operands of the
    compute dtype: a bf16 model (BERT's and GPT-2's) takes the wgmma
    route, an f32 one the split-precision TF32 route."""
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.models.transformer import init_gpt2_
    cfg = TransformerConfig(vocab_size=61, num_layers=2, num_heads=2,
                            d_model=32, d_ff=64, max_len=32, dtype=dtype,
                            attention_impl="flash")
    model = init_gpt2_(Transformer(cfg), torch.Generator().manual_seed(0))
    seen, bwd = [], tfl.flash_bwd

    def spy(q, k, v, do, *rest):
        seen.append(tfl.bwd_route(q, k, v, do))
        return bwd(q, k, v, do, *rest)

    monkeypatch.setattr(tfl, "flash_bwd", spy)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 61, (2, 32)))
    model(tokens).float().square().mean().backward()
    assert seen == [route] * cfg.num_layers


def test_forward_route_is_wgmma_only_when_every_operand_is_bf16():
    b = torch.zeros((1, 8, 1, 16), dtype=torch.bfloat16)
    f = b.float()
    assert tfl.fwd_route(b, b, b) == "wgmma"
    for i in range(3):
        ops = [b] * 3
        ops[i] = f
        assert tfl.fwd_route(*ops) == "tf32x3"
    assert tfl.fwd_route(f, f, f) == "tf32x3"
    with pytest.raises(ValueError, match="dtype"):
        tfl.fwd_route(b, b, b.half())


def _spy_forward_routes(monkeypatch):
    seen, fwd = [], tfl.flash_fwd

    def spy(q, k, v, *rest):
        seen.append(tfl.fwd_route(q, k, v))
        return fwd(q, k, v, *rest)

    monkeypatch.setattr(tfl, "flash_fwd", spy)
    return seen


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "tf32x3")])
def test_transformer_forward_takes_the_route_of_its_dtype(monkeypatch,
                                                          dtype, route):
    """The model's attention hands the forward q/k/v of the compute dtype:
    a bf16 model (BERT's and GPT-2's) takes the wgmma route, an f32 one
    the split-precision TF32 route."""
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.models.transformer import init_gpt2_
    cfg = TransformerConfig(vocab_size=61, num_layers=2, num_heads=2,
                            d_model=32, d_ff=64, max_len=32, dtype=dtype,
                            attention_impl="flash")
    model = init_gpt2_(Transformer(cfg), torch.Generator().manual_seed(0))
    seen = _spy_forward_routes(monkeypatch)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 61, (2, 32)))
    model(tokens)
    assert seen == [route] * cfg.num_layers


def test_lse_out_dtype_f32_keeps_bf16_inputs_on_the_tf32x3_route(
        monkeypatch):
    """``out_dtype=f32`` casts q before the forward, as JAX does, so bf16
    inputs go to the f32 kernel and the partial keeps f32-accurate
    products."""
    seen = _spy_forward_routes(monkeypatch)
    q, k, v = _t(_inputs(7), torch.bfloat16)
    tfl.flash_attention_lse(q, k, v, out_dtype=torch.float32)
    tfl.flash_attention_lse(q, k, v)
    assert seen == ["tf32x3", "wgmma"]


def _fwd_with_bf16_p(q, k, v, mode, scale):
    """The wgmma forward's arithmetic, dense and in f32 but for one
    rounding: P = exp(s - m) goes to bf16 before P·V, while l sums the
    unrounded P."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    keep = tfl._keep(q.shape[1], mode, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, tfl.NEG_INF))
    m = torch.clamp_min(s.amax(dim=-1), tfl.NEG_INF / 2)
    p = torch.exp(s - m[..., None])
    l = torch.clamp_min(p.sum(dim=-1), 1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), v.float()) \
        / l.transpose(1, 2)[..., None]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", [tfl.MASK_NONE, tfl.MASK_CAUSAL,
                                  tfl.MASK_STRICT])
def test_forward_rounding_bound_is_sound(mode, seed):
    """``attention_fwd_rounding_bound`` covers the rounding of P to bf16:
    an emulation that rounds only P stays within the bound of the plain
    version in f32, and within FLASH_TOL's bf16 part (2 ulps + 1e-3·max)
    plus the bound once both are rounded to bf16, as the card's checks
    hold the kernel.  The bound is at most 2⁻⁸·max|v| and 0 on a row that
    sees no key."""
    shape = (2, 80, 2, 32)
    q, k, v = _t(_inputs(60 + seed, shape), torch.bfloat16)
    kw = dict(mask_mode=mode, scale=1.0 / np.sqrt(shape[-1]))
    ref, _ = tfl.attention_fwd_reference(q, k, v, out_dtype=torch.float32,
                                         **kw)
    bound = tfl.attention_fwd_rounding_bound(q, k, v, **kw)
    got = _fwd_with_bf16_p(q, k, v, mode, kw["scale"])
    assert bound.shape == ref.shape and bound.dtype == torch.float32
    assert bool(((got - ref).abs() <= bound + 1e-6).all())
    assert float((got - ref).abs().max()) > 0   # P's rounding does show
    got16, ref16 = got.bfloat16().float(), ref.bfloat16().float()
    tol = 1e-3 * float(ref16.abs().max()) + 2 ** -6 * ref16.abs() + bound
    assert bool(((got16 - ref16).abs() <= tol).all())
    assert float(bound.max()) <= 2 ** -8 * float(v.float().abs().max())
    if mode == tfl.MASK_STRICT:
        assert float(bound[:, 0].abs().max()) == 0.0
        assert float(got[:, 0].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# The f32 kernels' arithmetic: split-precision TF32 (3xTF32)
# ---------------------------------------------------------------------------

def _tf32(x):
    """``x`` (f32) rounded to TF32 as the kernels round it
    (``csrc/mma_sync.cuh`` ``tf32``): ``(bits + 0x1000) & 0xffffe000``,
    to nearest on the 13 low mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(eq, a, b):
    """``einsum(eq, a, b)`` as the kernels multiply on the tensor cores:
    each f32 operand split into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
    and the product summed as lo·hi + hi·lo + hi·hi in f32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _bwd_tf32x3(q, k, v, do, lse, delta, mode, scale):
    """dQ, dK, dV with every product in 3xTF32, the rest in f32, as
    ``csrc/flash_attention_bwd_tf32_sm90.cu`` computes them: the scale
    applied to the scores inside exp and to dQ / dK at the end."""
    s = _mm3("bqhd,bkhd->bhqk", q, k)
    p = torch.exp(s * scale - lse[..., None])
    keep = tfl._keep(q.shape[1], mode, q.device)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    ds = p * (_mm3("bqhd,bkhd->bhqk", do, v) - delta[..., None])
    return (_mm3("bhqk,bkhd->bqhd", ds, k) * scale,
            _mm3("bhqk,bqhd->bkhd", ds, q) * scale,
            _mm3("bhqk,bqhd->bkhd", p, do))


@pytest.mark.parametrize("S", [48, 80])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("mode", [jfl.MASK_NONE, jfl.MASK_CAUSAL,
                                  jfl.MASK_STRICT])
def test_tf32x3_backward_pair_matches_jax_run_bwd_kernels(mode, D, S):
    """The f32 route's arithmetic (every product in 3xTF32) against JAX's
    two backward kernels (``_run_bwd_kernels``, interpret mode, blocks of
    16) at the f32 gradient tolerance, from the lse of JAX's forward, at
    S = 48 and S = 80 (past one 64-row tile of the kernels); STRICT's row
    0 sees no key and gets exactly zero."""
    B, H = 2, 2
    q, k, v, do = _inputs(70 + 3 * mode + D + S, (B, S, H, D), 4)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jdo = (_bhsd(x, jnp.float32) for x in (q, k, v, do))
    jout, res = jfl._flash_fwd(jq, jk, jv, mode, scale, 16, 16, True)
    delta = jnp.sum(jdo * jout, axis=-1)
    jgrads = jfl._run_bwd_kernels(jq, jk, jv, jdo, res[4], delta, mode,
                                  scale, 16, 16, True)
    got = _bwd_tf32x3(*(torch.from_numpy(x) for x in (q, k, v, do)),
                      _bshd(res[4], B, H), _bshd(delta, B, H), mode, scale)
    for g, want, name in zip(got, jgrads, ("dq", "dk", "dv")):
        _close(g, _bshd(want, B, H), GRAD, name)
    if mode == jfl.MASK_STRICT:
        assert float(got[0][:, 0].abs().max()) == 0.0


LOG2E = np.float32(1.4426950408889634)


def _fwd_tf32x3(q, k, v, mode, scale, tile=64):
    """out [B, S, H, D] and lse [B, H, S] with both products in 3xTF32
    and the softmax in f32, online over key tiles of ``tile``, as
    ``csrc/flash_attention_fwd_tf32_sm90.cu`` computes them: the running
    max floored at ``NEG_INF / 2`` from the start and compared as
    s·scale, the scale applied inside exp2, P = exp2(s·scale·log2 e −
    m·log2 e), l floored at 1e-30 and out = O·(1 / l)."""
    B, S, H, D = q.shape
    keep = tfl._keep(S, mode, q.device)
    m = torch.full((B, H, S), tfl.NEG_INF / 2)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, D))
    sl2 = np.float32(scale) * LOG2E
    for k0 in range(0, S, tile):
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        s = _mm3("bqhd,bkhd->bhqk", q, kt)
        if keep is not None:
            s = torch.where(keep[:, k0:k0 + tile], s,
                            torch.full_like(s, -float("inf")))
        m_new = torch.maximum(m, s.amax(dim=-1) * np.float32(scale))
        corr = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2(s * sl2 - (m_new * LOG2E)[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _mm3("bhqk,bkhd->bhqd", p, vt)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = acc * (1.0 / l)[..., None]
    return out.transpose(1, 2), m + torch.log(l)


@pytest.mark.parametrize("S", [48, 80, 144])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("mode", [jfl.MASK_NONE, jfl.MASK_CAUSAL,
                                  jfl.MASK_STRICT])
def test_tf32x3_forward_matches_jax_flash_fwd(mode, D, S):
    """The f32 forward's arithmetic (both products in 3xTF32, the online
    softmax in f32 over 64-key tiles) against JAX's forward kernel
    (``_flash_fwd``, interpret mode, blocks of 16) at the f32 forward
    tolerance, for out and lse, past one and two 64-row tiles; STRICT's
    row 0 sees no key: out exactly 0 and lse exactly ``NEG_INF / 2``."""
    B, H = 2, 2
    q, k, v = _inputs(90 + 3 * mode + D + S, (B, S, H, D))
    scale = 1.0 / np.sqrt(D)
    jout, res = jfl._flash_fwd(*(_bhsd(x, jnp.float32) for x in (q, k, v)),
                               mode, scale, 16, 16, True)
    out, lse = _fwd_tf32x3(*(torch.from_numpy(x) for x in (q, k, v)), mode,
                           scale)
    _close(out, _bshd(jout, B, H), FWD, "out")
    _close(lse, _bshd(res[4], B, H), FWD, "lse")
    if mode == jfl.MASK_STRICT:
        assert float(out[:, 0].abs().max()) == 0.0
        assert torch.all(lse[:, :, 0] == np.float32(tfl.NEG_INF / 2))


#: The error estimate of one 3xTF32 product (PERF.md §6): the dropped
#: lo·lo and the rounding of the two lo parts, each at most 2⁻²² of
#: |a|·|b| per term.
TF32X3_PART = 3 * 2.0 ** -22


@pytest.mark.parametrize("eq,shapes", [
    ("bqhd,bkhd->bhqk", ((2, 80, 2, 64), (2, 80, 2, 64))),   # S, dP
    ("bhqk,bkhd->bqhd", ((2, 2, 80, 80), (2, 80, 2, 64))),   # dQ
    ("bhqk,bqhd->bkhd", ((2, 2, 80, 80), (2, 80, 2, 64)))])  # dK, dV
def test_tf32x3_product_error_stays_under_its_estimate(eq, shapes):
    """Each 3xTF32 product differs from the exact (f64) product by at
    most ``TF32X3_PART`` of Σ|a|·|b| plus what the f32 sums round
    (``(k + 2)·2⁻²⁴`` of Σ|a|·|b| for a sum of k terms, split in three
    and added), and the split shows: it moves the result from the plain
    f32 product.  One TF32 pass (hi·hi) errs far beyond the estimate,
    which is why the kernels take three."""
    rng = np.random.RandomState(len(eq) + shapes[0][-1])
    a, b = (torch.from_numpy((rng.randn(*sh) * 0.5).astype(np.float32))
            for sh in shapes)
    k = shapes[1][1]   # the contracted length (S)
    exact = torch.einsum(eq, a.double(), b.double())
    mass = torch.einsum(eq, a.double().abs(), b.double().abs())
    got = _mm3(eq, a, b).double()
    bound = (TF32X3_PART + (k + 2) * 2.0 ** -24) * mass
    assert bool(((got - exact).abs() <= bound).all())
    assert float((got - torch.einsum(eq, a, b).double()).abs().max()) > 0
    one = torch.einsum(eq, _tf32(a), _tf32(b)).double()
    assert float(((one - exact).abs() / mass).max()) > 8 * TF32X3_PART
