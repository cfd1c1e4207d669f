"""Paged attention of the PyTorch port against the JAX package.

The port's plain version (``paged_attention_reference``, what a CPU
tensor runs) is held against both the JAX gather reference and the JAX
Pallas kernel in interpret mode (``paged_decode_attention`` /
``paged_prefill_attention``, interpret auto-selected off-TPU), on the
same inputs made with numpy, at the JAX package's own tolerance (rtol
2e-4 / atol 2e-5: the kernel associates the softmax blockwise).  The
cases mirror ``tests/test_paged_attention.py``: block sizes 8 and 16,
pool geometries (6,4), (9,7), (3,2), all three mask modes, native /
int8 / fp8 pools, all-hole rows, and a poisoned block NB-1 that every
hole clamps onto.

The quantizer must match the JAX one bit for bit (values and f16
scales), since the pools it writes are what both kernels read.

The CUDA kernel itself runs only on the card: the ``gpu``-marked tests
of ``tests/test_torch_gpu.py`` hold it against the plain version there.
Here its algorithm (query tiles, table splits, the merge) is checked in
Python with the port's online-softmax helpers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import flash as jflash
from horovod_tpu.serve import paged_attention as jpa
from horovod_tpu_torch.parallel import flash as tflash
from horovod_tpu_torch.serve import paged_attention as tpa

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5


def _t(x):
    """numpy (or jax) array -> torch CPU tensor; fp8 travels as raw bytes."""
    a = np.asarray(x)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.detach().cpu().numpy()


def _rand_pool(rng, NB, bt, H, Dh):
    return (rng.randn(NB, bt, H, Dh).astype(np.float32),
            rng.randn(NB, bt, H, Dh).astype(np.float32))


def _assert_matches_jax(port_out, jax_outs):
    for name, ref in jax_outs.items():
        np.testing.assert_allclose(_np(port_out), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


# -- decode -------------------------------------------------------------------

@pytest.mark.parametrize("bt", [8, 16])
@pytest.mark.parametrize("geometry", [(6, 4), (9, 7), (3, 2)])
def test_decode_plain_matches_jax_reference_and_kernel(bt, geometry):
    """Decode at positions straddling block boundaries (k·BT, k·BT±1),
    hole-sentinel tables and an inactive all-hole row (pos 0): the port
    equals JAX's gather reference and its interpret-mode kernel, and the
    all-hole row is exactly 0."""
    NB, MB = geometry
    H, Dh, B = 2, 16, 4
    rng = np.random.RandomState(NB * bt)
    kp, vp = _rand_pool(rng, NB, bt, H, Dh)
    q = rng.randn(B, H, Dh).astype(np.float32)
    tables = np.full((B, MB), NB, np.int32)
    perm = rng.permutation(NB)
    positions = []
    for b, pos in enumerate([bt - 1, bt, min(bt + 1, MB * bt - 1), 0]):
        nblk = pos // bt + 1
        tables[b, :min(nblk, NB)] = perm[:min(nblk, NB)]
        positions.append(pos)
    tables[3, :] = NB
    positions = np.asarray(positions, np.int32)
    out = tpa.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                     _t(positions))
    assert out.dtype == torch.float32 and out.shape == (B, H, Dh)
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(positions))
    _assert_matches_jax(out, {
        "reference": jpa.paged_attention_reference(*args),
        "kernel": jpa.paged_decode_attention(*args)})
    assert float(out[3].abs().max()) == 0.0


# -- prefill, every mask mode, poisoned hole block -----------------------------

@pytest.mark.parametrize("bt", [8, 16])
@pytest.mark.parametrize("mask_mode", [tpa.MASK_NONE, tpa.MASK_CAUSAL,
                                       tpa.MASK_STRICT])
def test_prefill_plain_matches_jax_all_mask_modes(bt, mask_mode):
    """Prefill chunks under every mask mode; block NB-1 is referenced by
    no table entry, so every read of it is a clamped hole: poisoning it
    must change nothing, in the port as in JAX."""
    NB, MB, H, Dh, B, C = 6, 4, 2, 16, 3, 5
    rng = np.random.RandomState(10 * mask_mode + bt)
    kp, vp = _rand_pool(rng, NB, bt, H, Dh)
    q = rng.randn(B, C, H, Dh).astype(np.float32)
    tables = np.array([[0, 2, NB, NB], [1, 3, 4, NB], [2, NB, NB, NB]],
                      np.int32)
    starts = np.array([bt - 1, 2 * bt - 1, 0], np.int32)

    def port(k, v):
        return tpa.paged_prefill_attention(
            _t(q), _t(k), _t(v), _t(tables), _t(starts),
            mask_mode=mask_mode)

    out = port(kp, vp)
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(starts))
    _assert_matches_jax(out, {
        "reference": jpa.paged_attention_reference(*args,
                                                   mask_mode=mask_mode),
        "kernel": jpa.paged_prefill_attention(*args, mask_mode=mask_mode)})
    if mask_mode == tpa.MASK_STRICT:
        # Row 2's first query sits at position 0: strict attends nothing.
        assert float(out[2, 0].abs().max()) == 0.0
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[NB - 1] = 1e30
    vp2[NB - 1] = -1e30
    np.testing.assert_array_equal(_np(port(kp2, vp2)), _np(out))


# -- quantized pools ------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_plain_matches_jax(kv_dtype):
    """int8 / fp8 pools quantized by JAX, read by both: the port's
    dequantizing plain version equals JAX's reference and kernel, for
    decode and for a causal prefill chunk."""
    NB, bt, MB, H, Dh, B = 6, 8, 4, 4, 32, 3
    rng = np.random.RandomState(9)
    kp, vp = _rand_pool(rng, NB, bt, H, Dh)
    kq, ks = jpa.quantize_kv(jnp.asarray(kp), kv_dtype)
    vq, vs = jpa.quantize_kv(jnp.asarray(vp), kv_dtype)
    tables = np.array([[0, 2, 3, NB], [1, 4, NB, NB], [5, NB, NB, NB]],
                      np.int32)
    positions = np.array([25, 10, 7], np.int32)
    q = rng.randn(B, H, Dh).astype(np.float32)
    out = tpa.paged_decode_attention(
        _t(q), _t(kq), _t(vq), _t(tables), _t(positions),
        k_scale=_t(ks), v_scale=_t(vs))
    jargs = (jnp.asarray(q), kq, vq, jnp.asarray(tables),
             jnp.asarray(positions))
    jkw = dict(k_scale=ks, v_scale=vs)
    _assert_matches_jax(out, {
        "reference": jpa.paged_attention_reference(*jargs, **jkw),
        "kernel": jpa.paged_decode_attention(*jargs, **jkw)})
    qc = rng.randn(B, 5, H, Dh).astype(np.float32)
    starts = np.array([20, 6, 0], np.int32)
    out = tpa.paged_prefill_attention(
        _t(qc), _t(kq), _t(vq), _t(tables), _t(starts),
        k_scale=_t(ks), v_scale=_t(vs))
    jargs = (jnp.asarray(qc), kq, vq, jnp.asarray(tables),
             jnp.asarray(starts))
    _assert_matches_jax(out, {
        "reference": jpa.paged_attention_reference(*jargs, **jkw),
        "kernel": jpa.paged_prefill_attention(*jargs, **jkw)})


def _quantizer_inputs():
    rng = np.random.RandomState(3)
    x = rng.randn(7, 4, 16).astype(np.float32) * 3.0
    x[0, 0] = 0.0                                  # zero row: scale floor
    # amax 127 gives scale 1.0, so these values sit exactly on .5 ties:
    # round half to even decides them.
    x[0, 1] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                        126.5, -126.5, 4.5, 5.5, 6.5, 7.5, 8.5, 9.5],
                       np.float32)
    x[1, 0] *= 1e4                                 # large magnitudes
    x[1, 1] *= 1e-6                                # tiny magnitudes
    x[2] = rng.randn(4, 16).astype(np.float32).round(1)
    return x


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantize_kv_bit_for_bit(kv_dtype):
    """``quantize_kv`` gives JAX's bytes: the int8/fp8 payload and the f16
    scale rows, ties and zero rows included; ``dequantize_kv`` agrees."""
    x = _quantizer_inputs()
    jq, js = jpa.quantize_kv(jnp.asarray(x), kv_dtype)
    tq, ts = tpa.quantize_kv(torch.from_numpy(x), kv_dtype)
    assert tq.dtype == {"int8": torch.int8,
                        "fp8": torch.float8_e4m3fn}[kv_dtype]
    assert ts.dtype == torch.float16 and tuple(ts.shape) == (7, 4)
    np.testing.assert_array_equal(
        _np(tq.view(torch.uint8) if kv_dtype == "fp8" else tq),
        np.asarray(jq).view(np.uint8) if kv_dtype == "fp8"
        else np.asarray(jq))
    np.testing.assert_array_equal(_np(ts).view(np.uint16),
                                  np.asarray(js).view(np.uint16))
    np.testing.assert_array_equal(
        _np(tpa.dequantize_kv(tq, ts)),
        np.asarray(jpa.dequantize_kv(jq, js)))


def test_quantize_kv_rejects_native():
    with pytest.raises(ValueError, match="not quantized"):
        tpa.quantize_kv(torch.zeros(2, 4), "native")


@pytest.mark.parametrize("head_dim", [16, 64])
def test_kv_bytes_per_token_matches_jax(head_dim):
    assert set(tpa.KV_DTYPES) == set(jpa.KV_DTYPES)
    for kvd in tpa.KV_DTYPES:
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            assert (tpa.kv_bytes_per_token(kvd, head_dim, tdt)
                    == jpa.kv_bytes_per_token(kvd, head_dim, jdt)), kvd


# -- the kernel's algorithm, in Python --------------------------------------

def _blockwise(q, kp, vp, tables, positions, mask_mode, tq, split_blocks):
    """The CUDA kernel's loop written with the port's flash helpers: per
    (sequence, head, tile of ``tq`` query rows, split of ``split_blocks``
    table entries), walk the split, skip holes and blocks
    ``block_contributes`` rules out, mask on absolute positions, fold
    with the floored online softmax; then merge the splits."""
    B, C, H, Dh = q.shape
    NB, BT = kp.shape[0], kp.shape[1]
    MB = tables.shape[1]
    scale = 1.0 / np.sqrt(Dh)
    out = torch.zeros(B, C, H, Dh)
    for b in range(B):
        for h in range(H):
            for q0 in range(0, C, tq):
                rows = min(tq, C - q0)
                q_lo = int(positions[b]) + q0
                parts = []
                for j0 in range(0, max(MB, 1), split_blocks):
                    m, l, acc = tflash.online_softmax_init(rows, Dh)
                    for j in range(j0, min(MB, j0 + split_blocks)):
                        t = int(tables[b, j])
                        if t >= NB or not tflash.block_contributes(
                                mask_mode, q_lo, q_lo + rows - 1, j * BT):
                            continue
                        s = (q[b, q0:q0 + rows, h] * scale) @ kp[t, :, h].T
                        s = tflash.causal_mask(s, q_lo, j * BT, mask_mode)
                        m, l, acc = tflash.online_softmax_block(
                            s, vp[t, :, h], m, l, acc)
                    parts.append((m, l, acc))
                out[b, q0:q0 + rows, h] = _merge(parts)
    return out


def _merge(parts):
    """The kernel's merge of a row's splits: rescale each split's sum and
    accumulator to the largest max, then the flush's 1e-30 floor."""
    m = torch.stack([p[0] for p in parts]).max(dim=0).values
    w = [torch.exp(p[0] - m) for p in parts]
    l = sum(wi * p[1] for wi, p in zip(w, parts))
    acc = sum(wi[:, None] * p[2] for wi, p in zip(w, parts))
    return tflash.online_softmax_flush(m, l, acc)[0]


@pytest.mark.parametrize("mask_mode", [tpa.MASK_NONE, tpa.MASK_CAUSAL,
                                       tpa.MASK_STRICT])
@pytest.mark.parametrize("split_blocks", [2, 8])
def test_kernel_algorithm_matches_plain_version(mask_mode, split_blocks):
    """The tiling the CUDA kernel uses gives the plain version's answer,
    holes, all-masked rows and the poisoned block included: query tiles
    of 4 rows (so tiles skip blocks the whole chunk would not) and the
    table cut into splits of ``split_blocks`` blocks merged afterwards
    (2: two splits, one of them empty for some rows; 8: one split)."""
    NB, bt, H, Dh = 7, 8, 2, 16
    rng = np.random.RandomState(40 + mask_mode)
    kp, vp = (torch.from_numpy(a) for a in _rand_pool(rng, NB, bt, H, Dh))
    kp[NB - 1] = 1e30
    vp[NB - 1] = -1e30
    q = torch.from_numpy(rng.randn(3, 10, H, Dh).astype(np.float32))
    tables = torch.tensor([[0, 2, 5, NB], [1, 3, 4, NB], [NB, NB, NB, NB]],
                          dtype=torch.int32)
    starts = torch.tensor([14, 0, 0], dtype=torch.int32)
    ref = tpa.paged_attention_reference(q, kp, vp, tables, starts,
                                        mask_mode=mask_mode)
    got = _blockwise(q, kp, vp, tables, starts, mask_mode, tq=4,
                     split_blocks=split_blocks)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert float(got[2].abs().max()) == 0.0
    assert tpa.num_splits(4) == 1 and tpa.num_splits(64) == 8
    assert tpa.num_splits(tpa.SPLIT_BLOCKS + 1) == 2


def test_mask_vocabulary_matches_jax():
    """``causal_mask`` / ``block_contributes`` and the mask constants are
    JAX's, at absolute offsets."""
    assert (tflash.NEG_INF, tflash.MASK_NONE, tflash.MASK_CAUSAL,
            tflash.MASK_STRICT) == (jflash.NEG_INF, jflash.MASK_NONE,
                                    jflash.MASK_CAUSAL, jflash.MASK_STRICT)
    s = np.random.RandomState(0).randn(5, 8).astype(np.float32)
    for mode in (0, 1, 2):
        for q_off, k_off in ((0, 0), (7, 3), (3, 7)):
            np.testing.assert_array_equal(
                _np(tflash.causal_mask(torch.from_numpy(s), q_off, k_off,
                                       mode)),
                np.asarray(jflash.causal_mask(jnp.asarray(s), q_off, k_off,
                                              mode)))
            for k_lo in (0, 5, 7, 8, 12):
                assert (tflash.block_contributes(mode, q_off, q_off + 4,
                                                 k_lo)
                        == bool(jflash.block_contributes(mode, q_off,
                                                         q_off + 4, k_lo)))


# -- the wrapper ------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.RandomState(1)
    kp, vp = (torch.from_numpy(a) for a in _rand_pool(rng, 3, 8, 2, 16))
    q = torch.from_numpy(rng.randn(2, 2, 16).astype(np.float32))
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    pos = torch.tensor([9, 3], dtype=torch.int32)
    before = tpa.LAUNCHES["paged_attention"]
    out = tpa.paged_decode_attention(q, kp, vp, tables, pos)
    ref = tpa.paged_attention_reference(q, kp, vp, tables, pos)
    assert torch.equal(out, ref)
    assert tpa.LAUNCHES["paged_attention"] == before


def test_other_devices_raise():
    t = torch.empty((2, 1, 2, 16), device="meta")
    pool = torch.empty((3, 8, 2, 16), device="meta")
    idx = torch.empty((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tpa.paged_prefill_attention(t, pool, pool, idx,
                                    torch.empty((2,), dtype=torch.int32,
                                                device="meta"))

