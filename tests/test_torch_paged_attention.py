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

The CUDA kernels themselves run only on the card: the ``gpu``-marked
tests of ``tests/test_torch_gpu.py`` hold them against the plain version
there.  Here their schedules are checked in Python: the prefill
route's (query tiles, key tiles of whole table entries fixed by table
index, 3xTF32 products emulated with TF32 rounding, table splits and
their merge), held to the plain version, JAX's reference and its derived
rounding bound (``paged_prefill_rounding_bound``), with a row's bits
independent of the chunk bucket and the batch; and the decode route's
(tiles of a split folded by warps apart, combined in warp order, then
the merge).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import flash as jflash
from horovod_tpu.serve import paged_attention as jpa
from horovod_tpu_torch.parallel import flash as tflash
from horovod_tpu_torch.serve import paged_attention as tpa

NEG_INF = tflash.NEG_INF

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


# -- the kernels' algorithms, in Python -------------------------------------

def _tf32(x):
    """``x`` (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest on the low 13 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mma3(a, b, acc, exact_b):
    """``acc`` [R, N] += ``a`` [R, Kd] · ``b`` [Kd, N] the way the prefill
    route multiplies: each operand split into ``hi = tf32(x)`` and ``lo =
    tf32(x - hi)``, and per k-step of 8 the ``mma.sync`` passes lo·hi,
    hi·lo (none for an exact, narrow-pool ``b``) and hi·hi, each adding
    its exact products to the f32 accumulator with one rounding.
    Elementwise only, so a row's bits depend on that row alone."""
    a_hi = _tf32(a)
    a_lo = _tf32(a - a_hi)
    b_hi = _tf32(b)
    b_lo = _tf32(b - b_hi)
    passes = [(a_lo, b_hi)] + ([] if exact_b else [(a_hi, b_lo)]) \
        + [(a_hi, b_hi)]
    for k0 in range(0, a.shape[1], 8):
        for x, y in passes:
            t = acc.double()
            for k in range(k0, min(k0 + 8, a.shape[1])):
                t = t + x[:, k, None].double() * y[None, k, :].double()
            acc = t.float()
    return acc


def _exp(x):
    """f32 exp, rounded from float64 (so its bits do not depend on where
    an element sits in a vectorized loop)."""
    return torch.exp(x.double()).float()


def _blockwise(q, kp, vp, tables, positions, mask_mode, *,
               split_blocks=tpa.SPLIT_BLOCKS, key_tile=tpa.KEY_TILE,
               query_tile=tpa.QUERY_TILE, k_scale=None, v_scale=None):
    """The prefill route's schedule (``csrc/paged_attention_prefill_sm90.cu``)
    in Python, for q [B, C, H, Dh]: per (sequence, head, tile of
    ``query_tile`` rows, split of ``split_blocks`` table entries), key
    tiles of ``ent`` whole entries fixed by table index; a tile with no
    live entry (hole, or a block ``block_contributes`` rules out for the
    query tile) is skipped, a dead entry inside a live one is zero and
    masked; S = (q·scale)·Kᵀ and O += P·V in 3xTF32 (``_mma3``), a
    quantized key's scale on its score and its V scale on its
    probability, the floored online softmax folded once per tile by the
    warp group of the tile's parity, the two groups' states combined in
    group order; then the splits merged in split order."""
    B, C, H, Dh = q.shape
    NB, BT = kp.shape[0], kp.shape[1]
    MB = tables.shape[1]
    scale = 1.0 / np.sqrt(Dh)
    ent = max(1, min(split_blocks, key_tile // BT))
    exact = kp.dtype != torch.float32
    out = torch.zeros(B, C, H, Dh)
    for b in range(B):
        for h in range(H):
            for q0 in range(0, C, query_tile):
                rows = min(query_tile, C - q0)
                q_lo = int(positions[b]) + q0
                q_hi = q_lo + rows - 1
                qs = q[b, q0:q0 + rows, h].float() * scale
                qpos = q_lo + torch.arange(rows)[:, None]
                parts = []
                for j0 in range(0, max(MB, 1), split_blocks):
                    n_ent = max(0, min(split_blocks, MB - j0))
                    live = [0 <= int(tables[b, j0 + e]) < NB
                            and tflash.block_contributes(
                                mask_mode, q_lo, q_hi, (j0 + e) * BT)
                            for e in range(n_ent)]
                    groups = [tflash.online_softmax_init(rows, Dh)
                              for _ in range(2)]
                    for e0 in range(0, n_ent, ent):
                        m, l, acc = groups[e0 // ent % 2]
                        es = range(e0, min(n_ent, e0 + ent))
                        if not any(live[e] for e in es):
                            continue
                        n8 = -(-len(es) * BT // 8) * 8
                        kt, vt = torch.zeros(n8, Dh), torch.zeros(n8, Dh)
                        ksc, vsc = torch.zeros(n8), torch.zeros(n8)
                        kpos = torch.full((n8,), -1)
                        for i, e in enumerate(es):
                            if not live[e]:
                                continue
                            t, r = int(tables[b, j0 + e]), slice(i * BT,
                                                                (i + 1) * BT)
                            kt[r], vt[r] = kp[t, :, h].float(), \
                                vp[t, :, h].float()
                            kpos[r] = (j0 + e) * BT + torch.arange(BT)
                            if k_scale is not None:
                                ksc[r] = k_scale[t, :, h].float()
                                vsc[r] = v_scale[t, :, h].float()
                        s = _mma3(qs, kt.T, torch.zeros(rows, n8), exact)
                        if k_scale is not None:
                            s = s * ksc
                        keep = kpos >= 0
                        if mask_mode == tpa.MASK_CAUSAL:
                            keep = keep & (kpos <= qpos)
                        elif mask_mode == tpa.MASK_STRICT:
                            keep = keep & (kpos < qpos)
                        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
                        m_new = torch.clamp_min(
                            torch.maximum(m, s.max(dim=1).values),
                            NEG_INF / 2)
                        p = _exp(s - m_new[:, None])
                        row_sum = p[:, 0]
                        for c in range(1, n8):
                            row_sum = row_sum + p[:, c]
                        corr = _exp(m - m_new)
                        l = l * corr + row_sum
                        pv = p * vsc if v_scale is not None else p
                        acc = _mma3(pv, vt, acc * corr[:, None], exact)
                        groups[e0 // ent % 2] = (m_new, l, acc)
                    (m0, l0, a0), (m1, l1, a1) = groups
                    m = torch.maximum(m0, m1)
                    f0, f1 = _exp(m0 - m), _exp(m1 - m)
                    parts.append((m, f0 * l0 + f1 * l1,
                                  f0[:, None] * a0 + f1[:, None] * a1))
                out[b, q0:q0 + rows, h] = _merge(parts, exp=_exp)
    return out


def _combine(parts, exp=torch.exp):
    """Partial softmax states in list order: rescale each sum and
    accumulator to the largest max and add them up."""
    m = torch.stack([p[0] for p in parts]).max(dim=0).values
    w = [exp(p[0] - m) for p in parts]
    l = sum(wi * p[1] for wi, p in zip(w, parts))
    acc = sum(wi[:, None] * p[2] for wi, p in zip(w, parts))
    return m, l, acc


def _merge(parts, exp=torch.exp):
    """The kernels' merge of a row's splits: combine them in split order,
    then the flush's 1e-30 floor."""
    return tflash.online_softmax_flush(*_combine(parts, exp))[0]


def _exact(q, kp, vp, tables, positions, mask_mode, k_scale=None,
           v_scale=None):
    """The attention of the same inputs in float64 (the plain version's
    masks and gather, no f32 rounding), [B, C, H, Dh]."""
    B, C, H, Dh = q.shape
    NB, BT = kp.shape[0], kp.shape[1]
    K = tables.shape[1] * BT
    idx = tables.long().clamp(0, NB - 1)
    kk = kp[idx].reshape(B, K, H, Dh).double()
    vv = vp[idx].reshape(B, K, H, Dh).double()
    if k_scale is not None:
        kk = kk * k_scale[idx].reshape(B, K, H, 1).double()
        vv = vv * v_scale[idx].reshape(B, K, H, 1).double()
    s = torch.einsum("bqhe,bkhe->bhqk", q.double() / np.sqrt(Dh), kk)
    q_pos = positions.long()[:, None, None, None] \
        + torch.arange(C)[None, None, :, None]
    k_pos = torch.arange(K)[None, None, None, :]
    keep = {tpa.MASK_NONE: torch.ones_like(k_pos <= q_pos),
            tpa.MASK_CAUSAL: k_pos <= q_pos,
            tpa.MASK_STRICT: k_pos < q_pos}[mask_mode]
    keep = keep & ~(tables >= NB).repeat_interleave(BT, dim=1)[:, None,
                                                               None]
    p = torch.softmax(torch.where(keep, s, torch.full_like(s, -np.inf)),
                      dim=-1)
    p = torch.where(keep.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhqk,bkhe->bqhe", p, vv)


def _assert_within_bound(got, exact, bound):
    """Elementwise ``|got - exact| <= bound`` (the derived rounding bound
    of the prefill route), reporting the worst ratio."""
    err = (got.double() - exact).abs()
    worst = float((err / bound.double().clamp_min(1e-38)).max())
    assert bool((err <= bound.double()).all()), \
        f"error exceeds the rounding bound: worst err/bound {worst:.3g}"
    return worst


def _prefill_problem(seed):
    """Three sequences over a pool of BT = 8 whose never-mapped block NB-1
    is poisoned: a table with a hole between its blocks, a full one, and
    an all-hole row; chunks of 10 rows from positions 14, 0 and 0."""
    NB, bt, H, Dh = 7, 8, 2, 16
    rng = np.random.RandomState(seed)
    kp, vp = (torch.from_numpy(a) for a in _rand_pool(rng, NB, bt, H, Dh))
    kp[NB - 1] = 1e30
    vp[NB - 1] = -1e30
    q = torch.from_numpy(rng.randn(3, 10, H, Dh).astype(np.float32))
    tables = torch.tensor([[0, 2, NB, 5], [1, 3, 4, NB], [NB, NB, NB, NB]],
                          dtype=torch.int32)
    starts = torch.tensor([14, 0, 0], dtype=torch.int32)
    return q, kp, vp, tables, starts


@pytest.mark.parametrize("mask_mode", [tpa.MASK_NONE, tpa.MASK_CAUSAL,
                                       tpa.MASK_STRICT])
@pytest.mark.parametrize("split_blocks,key_tile,query_tile",
                         [(2, 64, 64), (8, 64, 64), (8, 16, 4)])
def test_kernel_algorithm_matches_plain_version(mask_mode, split_blocks,
                                                key_tile, query_tile):
    """The prefill route's schedule gives the plain version's and JAX's
    answers and stays within its derived rounding bound of the exact
    (float64) attention, holes, all-masked rows and the poisoned block
    included: one split or two (2: some rows' second split empty), key
    tiles of one whole split or of two entries (16 keys: a dead entry
    inside a live tile), query tiles of the whole chunk or of 4 rows (so
    tiles skip blocks the whole chunk would not)."""
    q, kp, vp, tables, starts = _prefill_problem(40 + mask_mode)
    ref = tpa.paged_attention_reference(q, kp, vp, tables, starts,
                                        mask_mode=mask_mode)
    got = _blockwise(q, kp, vp, tables, starts, mask_mode,
                     split_blocks=split_blocks, key_tile=key_tile,
                     query_tile=query_tile)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    jargs = tuple(jnp.asarray(_np(a)) for a in (q, kp, vp, tables, starts))
    _assert_matches_jax(got, {"reference": jpa.paged_attention_reference(
        *jargs, mask_mode=mask_mode)})
    bound = tpa.paged_prefill_rounding_bound(
        q, kp, vp, tables, starts, mask_mode=mask_mode,
        split_blocks=split_blocks)
    _assert_within_bound(got, _exact(q, kp, vp, tables, starts, mask_mode),
                         bound)
    assert float(got[2].abs().max()) == 0.0
    assert float(bound[2].abs().max()) == 0.0
    assert tpa.num_splits(4) == 1 and tpa.num_splits(64) == 8
    assert tpa.num_splits(tpa.SPLIT_BLOCKS + 1) == 2
    assert tpa.entries_per_tile(16) == 4 and tpa.entries_per_tile(1) == 8


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_prefill_route_schedule_reads_quantized_pools(kv_dtype):
    """The schedule over JAX-quantized pools, scaled as the route scales
    (each score and each probability by its key's f16 scale, two TF32
    passes a product since the values are exact in TF32), equals the
    dequantizing plain version and JAX's reference, within the bound."""
    q, kp, vp, tables, starts = _prefill_problem(61)
    kp[-1], vp[-1] = 1e4, -1e4             # finite under an f16 scale
    jk = jpa.quantize_kv(jnp.asarray(_np(kp)), kv_dtype)
    jv = jpa.quantize_kv(jnp.asarray(_np(vp)), kv_dtype)
    (kq, ks), (vq, vs) = ((_t(a) for a in jk), (_t(a) for a in jv))
    kw = dict(k_scale=ks, v_scale=vs)
    for mode in (tpa.MASK_CAUSAL, tpa.MASK_STRICT):
        got = _blockwise(q, kq, vq, tables, starts, mode, split_blocks=2,
                         **kw)
        torch.testing.assert_close(
            got, tpa.paged_attention_reference(q, kq, vq, tables, starts,
                                               mask_mode=mode, **kw),
            rtol=RTOL, atol=ATOL)
        jargs = (jnp.asarray(_np(q)), jk[0], jv[0],
                 jnp.asarray(_np(tables)), jnp.asarray(_np(starts)))
        _assert_matches_jax(got, {"reference": jpa.paged_attention_reference(
            *jargs, mask_mode=mode, k_scale=jk[1], v_scale=jv[1])})
        _assert_within_bound(
            got, _exact(q, kq, vq, tables, starts, mode, ks, vs),
            tpa.paged_prefill_rounding_bound(q, kq, vq, tables, starts,
                                             mask_mode=mode, split_blocks=2,
                                             **kw))
        assert float(got[2].abs().max()) == 0.0


@pytest.mark.parametrize("mask_mode", [tpa.MASK_NONE, tpa.MASK_CAUSAL,
                                       tpa.MASK_STRICT])
def test_prefill_route_row_bits_do_not_depend_on_bucket_or_batch(mask_mode):
    """A row's bits depend only on its q, its table row and its start: the
    first 8 rows of a chunk come out the same at C buckets 8 and 64 (the
    64-row tile folds blocks the 8-row tile skips, each wholly past those
    rows), and a sequence alone equals itself in a batch of 4."""
    NB, bt, H, Dh, MB = 50, 8, 2, 16, 12
    rng = np.random.RandomState(70 + mask_mode)
    kp, vp = (torch.from_numpy(a) for a in _rand_pool(rng, NB, bt, H, Dh))
    q = torch.from_numpy(rng.randn(4, 64, H, Dh).astype(np.float32))
    tables = torch.from_numpy(
        rng.permutation(NB - 1)[:4 * MB].reshape(4, MB).astype(np.int32))
    tables[1, 5] = NB                       # a hole between blocks
    starts = torch.tensor([20, 3, 30, 0], dtype=torch.int32)
    assert tpa.num_splits(MB) == 2
    c64 = _blockwise(q, kp, vp, tables, starts, mask_mode)
    c8 = _blockwise(q[:, :8].contiguous(), kp, vp, tables, starts,
                    mask_mode)
    assert torch.equal(c8, c64[:, :8])
    for b in range(4):
        alone = _blockwise(q[b:b + 1, :8].contiguous(), kp, vp,
                           tables[b:b + 1], starts[b:b + 1], mask_mode)
        assert torch.equal(alone[0], c8[b]), f"row {b}"
    torch.testing.assert_close(
        c64, tpa.paged_attention_reference(q, kp, vp, tables, starts,
                                           mask_mode=mask_mode),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pool,magnitude", [("f32", 1.0), ("f32", 30.0),
                                            ("bf16", 1.0), ("int8", 1e4),
                                            ("fp8", 1e4)])
def test_prefill_rounding_bound_covers_the_schedule(pool, magnitude):
    """``paged_prefill_rounding_bound`` covers the emulated route's error
    against the float64 attention over seeded inputs, element by element:
    f32 pools (unit and wide score ranges), a bf16 pool, and int8 / fp8
    pools of values up to ±1e4, whose scores span thousands."""
    for seed in range(3):
        rng = np.random.RandomState(900 + seed)
        NB, bt, H, Dh, MB = 12, 8, 2, 32, 10
        kp, vp = (torch.from_numpy(a * magnitude)
                  for a in _rand_pool(rng, NB, bt, H, Dh))
        q = torch.from_numpy(rng.randn(2, 9, H, Dh).astype(np.float32))
        tables = torch.from_numpy(np.stack([rng.permutation(NB)[:MB]
                                            for _ in range(2)])
                                  .astype(np.int32))
        starts = torch.tensor([70, 11], dtype=torch.int32)
        kw = {}
        if pool == "bf16":
            kp, vp = kp.bfloat16(), vp.bfloat16()
        elif pool != "f32":
            kp, ks = tpa.quantize_kv(kp, pool)
            vp, vs = tpa.quantize_kv(vp, pool)
            kw = dict(k_scale=ks, v_scale=vs)
        got = _blockwise(q, kp, vp, tables, starts, tpa.MASK_CAUSAL,
                         split_blocks=4, **kw)
        bound = tpa.paged_prefill_rounding_bound(
            q, kp, vp, tables, starts, split_blocks=4, **kw)
        worst = _assert_within_bound(
            got, _exact(q, kp, vp, tables, starts, tpa.MASK_CAUSAL,
                        kw.get("k_scale"), kw.get("v_scale")), bound)
        assert worst < 1.0


def _decode_route(q, kp, vp, tables, positions, mask_mode, *, warps,
                  split_blocks, tile_rows, cluster, k_scale=None,
                  v_scale=None):
    """The decode kernel's schedule (``csrc/paged_attention_decode_sm90.cu``)
    in Python, for q [B, H, Dh]: per (sequence, head, split), the split's
    key blocks (holes and blocks past the query dropped before anything
    is read) cut into tiles of ``tile_rows`` keys; warp w folds tiles w,
    w + ``warps``, ... with the floored online softmax.  Up to
    ``cluster`` splits merge all their warps' states at once, in (split,
    warp) order; a wider table combines each split's warps in warp order
    and then merges the splits in split order."""
    B, H, Dh = q.shape
    NB, BT = kp.shape[0], kp.shape[1]
    MB = tables.shape[1]
    scale = 1.0 / np.sqrt(Dh)

    def rows(pool, scales, t, r0, h):
        x = pool[t, r0:r0 + tile_rows, h].float()
        if scales is not None:
            x = x * scales[t, r0:r0 + tile_rows, h].float()[:, None]
        return x

    out = torch.zeros(B, H, Dh)
    for b in range(B):
        qpos = int(positions[b])
        for h in range(H):
            splits = []
            for j0 in range(0, max(MB, 1), split_blocks):
                live = [j for j in range(j0, min(MB, j0 + split_blocks))
                        if 0 <= int(tables[b, j]) < NB
                        and tflash.block_contributes(mask_mode, qpos, qpos,
                                                     j * BT)]
                tiles = [(j, r0) for j in live
                         for r0 in range(0, BT, tile_rows)]
                states = []
                for w in range(warps):
                    m, l, acc = tflash.online_softmax_init(1, Dh)
                    for j, r0 in tiles[w::warps]:
                        t = int(tables[b, j])
                        k = rows(kp, k_scale, t, r0, h)
                        s = (q[b, h].float() * scale)[None] @ k.T
                        s = tflash.causal_mask(s, qpos, j * BT + r0,
                                               mask_mode)
                        m, l, acc = tflash.online_softmax_block(
                            s, rows(vp, v_scale, t, r0, h), m, l, acc)
                    states.append((m, l, acc))
                splits.append(states)
            if len(splits) <= cluster:
                out[b, h] = _merge([st for sp in splits for st in sp])
            else:
                out[b, h] = _merge([_combine(sp) for sp in splits])
    return out


def _decode_problem(seed, kv_dtype=None):
    """Decode rows over a pool of BT = 8 whose never-mapped block NB-1 is
    poisoned: a row over the whole table, one with holes between its
    blocks, a short row (its later splits see no block), and an all-hole
    row.  Returns numpy arrays (scales None for a native pool)."""
    NB, BT, H, Dh, MB = 10, 8, 2, 16, 6
    rng = np.random.RandomState(seed)
    kp, vp = _rand_pool(rng, NB, BT, H, Dh)
    kp[NB - 1], vp[NB - 1] = 1e30, -1e30
    ks = vs = None
    if kv_dtype is not None:
        kp[NB - 1], vp[NB - 1] = 1e4, -1e4   # finite under an f16 scale
        kp, ks = (np.asarray(a) for a in jpa.quantize_kv(jnp.asarray(kp),
                                                         kv_dtype))
        vp, vs = (np.asarray(a) for a in jpa.quantize_kv(jnp.asarray(vp),
                                                         kv_dtype))
    q = rng.randn(4, H, Dh).astype(np.float32)
    tables = np.array([[0, 1, 2, 3, 4, 5],
                       [6, NB, 7, NB, 8, NB],
                       [2, NB, NB, NB, NB, NB],
                       [NB] * MB], np.int32)
    positions = np.array([MB * BT - 1, 4 * BT + 2, 3, 0], np.int32)
    return q, kp, vp, tables, positions, ks, vs


@pytest.mark.parametrize("mask_mode", [tpa.MASK_NONE, tpa.MASK_CAUSAL,
                                       tpa.MASK_STRICT])
@pytest.mark.parametrize("warps,split_blocks,tile_rows,cluster",
                         [(4, 8, 8, 8), (4, 2, 8, 8), (1, 2, 4, 2),
                          (3, 4, 3, 8)])
def test_decode_route_schedule_matches_plain_version_and_jax(
        mask_mode, warps, split_blocks, tile_rows, cluster):
    """The decode kernel's schedule gives the plain version's and JAX's
    answers: one split or several (some rows' later splits empty), merged
    in one cluster or, for more splits than a cluster holds, split by
    split; one warp or several; tiles of a whole block or of part of one
    (3 keys: a ragged last tile); holes between blocks; an all-hole row
    that comes out exactly 0; and a poisoned block no table maps."""
    q, kp, vp, tables, positions, _, _ = _decode_problem(50 + mask_mode)
    args = tuple(_t(a) for a in (q, kp, vp, tables, positions))
    got = _decode_route(*args, mask_mode, warps=warps,
                        split_blocks=split_blocks, tile_rows=tile_rows,
                        cluster=cluster)
    ref = tpa.paged_attention_reference(*args, mask_mode=mask_mode)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    jargs = tuple(jnp.asarray(a) for a in (q, kp, vp, tables, positions))
    _assert_matches_jax(got, {"reference": jpa.paged_attention_reference(
        *jargs, mask_mode=mask_mode)})
    assert float(got[3].abs().max()) == 0.0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_decode_route_schedule_reads_quantized_pools(kv_dtype):
    """The schedule over JAX-quantized pools, scaled as the kernel scales
    (each score and each probability by its key's f16 scale), equals
    the dequantizing plain version and JAX's reference."""
    q, kp, vp, tables, positions, ks, vs = _decode_problem(60, kv_dtype)
    args = tuple(_t(a) for a in (q, kp, vp, tables, positions))
    kw = dict(k_scale=_t(ks), v_scale=_t(vs))
    got = _decode_route(*args, tpa.MASK_CAUSAL, warps=4, split_blocks=2,
                        tile_rows=8, cluster=8, **kw)
    torch.testing.assert_close(
        got, tpa.paged_attention_reference(*args, **kw), rtol=RTOL,
        atol=ATOL)
    jargs = tuple(jnp.asarray(a) for a in (q, kp, vp, tables, positions))
    _assert_matches_jax(got, {"reference": jpa.paged_attention_reference(
        *jargs, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))})
    assert float(got[3].abs().max()) == 0.0


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
    before = dict(tpa.LAUNCHES)
    out = tpa.paged_decode_attention(q, kp, vp, tables, pos)
    ref = tpa.paged_attention_reference(q, kp, vp, tables, pos)
    assert torch.equal(out, ref)
    assert tpa.LAUNCHES == before


def test_other_devices_raise():
    t = torch.empty((2, 1, 2, 16), device="meta")
    pool = torch.empty((3, 8, 2, 16), device="meta")
    idx = torch.empty((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tpa.paged_prefill_attention(t, pool, pool, idx,
                                    torch.empty((2,), dtype=torch.int32,
                                                device="meta"))

