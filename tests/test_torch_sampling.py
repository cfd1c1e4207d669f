"""The port's sampling module (``horovod_tpu_torch/serve/sampling.py``)
against the JAX package's.

The filters must describe the same distribution as JAX's: the port's
torch ``filter_logits`` equals ``_filter_logits_jnp`` and its
``filtered_probs`` equals JAX's to 1e-6 on seeded logits at V = 257,
with ties at the k-th value and top_p in {0.1, 0.9, 1}.  The port owns
its keys (it does not reproduce jax's bits), so the draws are held to
the filtered distribution by chi-square — the device draw
(``sample_batched``, Gumbel-max), the host draw (``sample_host``,
inverse CDF) and speculative accept/resample — as
``tests/test_serve_sampling.py`` holds JAX's.  Every test is
deterministic: the keys are fixed, so a bound either always holds or
never does.  Keys are pure functions of (seed, sample, position): a
row's draw does not depend on its batch row or the batch width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.serve import sampling as jsampling
from horovod_tpu_torch.serve import sampling as sampling

V = 257


def _chi2_bound(df):
    """Above the 99.9th percentile of chi2(df) over the df here (the
    bound ``tests/test_serve_sampling.py`` uses)."""
    return df + 4 * (2 * df) ** 0.5 + 11


def _chi2(counts, p, n):
    expected = p * n
    live = expected > 0
    chi2 = float(((counts[live] - expected[live]) ** 2
                  / expected[live]).sum())
    return chi2, int(live.sum()) - 1, float(counts[~live].sum())


def _logits(seed, ties_at=None):
    """Seeded logits at V = 257; ``ties_at=k`` makes five more entries
    equal to the k-th largest value."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(V) * 2).astype(np.float32)
    if ties_at is not None:
        kth = np.sort(x)[::-1][ties_at - 1]
        idx = rng.choice(np.flatnonzero(x < kth), 5, replace=False)
        x[idx] = kth
    return x


_FILTERS = [(0.7, None, 1.0), (1.3, 5, 1.0), (0.9, None, 0.1),
            (0.9, None, 0.9), (1.0, 40, 0.9), (0.6, 40, 0.1),
            (0.8, 40, 1.0), (1.1, 1, 1.0), (2.0, 257, 0.9),
            (1e-7, None, 1.0)]


@pytest.mark.parametrize("ties", [None, 5, 40], ids=lambda t: f"ties{t}")
@pytest.mark.parametrize("temp,top_k,top_p", _FILTERS,
                         ids=lambda v: repr(v))
def test_filters_match_jax(temp, top_k, top_p, ties):
    """The same support and the same values, to 1e-6, as JAX's traced
    filter and host filter (ties at the k-th value are all kept)."""
    x = _logits(int(temp * 100) + (top_k or 0) + int(top_p * 10)
                + (ties or 0), ties_at=ties)
    want = np.asarray(jsampling._filter_logits_jnp(
        jnp.asarray(x), jnp.float32(temp), jnp.int32(top_k or 0),
        jnp.float32(top_p)))
    got = sampling.filter_logits(torch.from_numpy(x), temp, top_k or 0,
                                 top_p).numpy()
    assert (np.isfinite(got) == np.isfinite(want)).all()
    live = np.isfinite(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-6, atol=1e-6)
    if ties is not None and top_k == ties and top_p == 1.0:
        assert live.sum() == top_k + 5
    np.testing.assert_allclose(
        sampling.filtered_probs(x, temp, top_k, top_p),
        jsampling.filtered_probs(x, temp, top_k, top_p), atol=1e-6)


@pytest.mark.parametrize("temp,top_k,seed", [(0.7, None, 85),
                                              (0.7, None, 0), (1.3, 5, 1),
                                              (0.8, 40, 2), (2.0, None, 3)])
def test_device_and_host_filters_keep_one_support_at_top_p_one(temp, top_k,
                                                               seed):
    """``filter_logits`` (device decode steps) and ``filtered_probs``
    (first tokens, spec accept/resample) keep the same tokens at
    ``top_p == 1``, so one sequence is filtered one way at every
    position.  Seed 85 with five ties at the 5th value is the input on
    which JAX's ``filtered_probs`` keeps 254 of 257 tokens and its traced
    filter 257 (ROADMAP Queue C)."""
    x = _logits(seed, ties_at=5 if seed == 85 else None)
    dev = np.isfinite(sampling.filter_logits(torch.from_numpy(x), temp,
                                             top_k or 0, 1.0).numpy())
    host = sampling.filtered_probs(x, temp, top_k, 1.0) > 0
    assert np.array_equal(dev, host)
    assert host.sum() == (top_k or V)


def test_filter_rows_are_independent_of_the_batch():
    """A [B, V] call with per-row parameters gives each row exactly what
    the row gives alone."""
    rows = [_logits(s) for s in range(6)]
    params = [(0.7, 0, 1.0), (1.3, 5, 1.0), (0.9, 0, 0.1), (1.0, 40, 0.9),
              (0.0, 0, 1.0), (0.6, 3, 0.5)]
    batch = sampling.filter_logits(
        torch.from_numpy(np.stack(rows)),
        torch.tensor([p[0] for p in params]),
        torch.tensor([p[1] for p in params]),
        torch.tensor([p[2] for p in params]))
    for i, (x, (t, k, p)) in enumerate(zip(rows, params)):
        alone = sampling.filter_logits(torch.from_numpy(x)[None], t, k, p)
        assert torch.equal(batch[i], alone[0])


def test_temperature_zero_is_the_argmax_exactly():
    rng = np.random.RandomState(3)
    logits = torch.from_numpy(rng.randn(5, V).astype(np.float32))
    keys = np.stack([sampling.seq_key(7, i) for i in range(5)])
    out = sampling.sample_batched(logits, sampling.pack_params(
        keys, np.arange(5) + 10, np.zeros(5), np.full(5, 3),
        np.full(5, 0.5)))
    assert torch.equal(out, logits.argmax(dim=-1))
    x = logits[0].numpy()
    assert sampling.sample_host(x, keys[0], 4, 0.0, 3, 0.5) == \
        int(np.argmax(x)) == sampling.sample_host_fused(x, keys[0], 4, 0.0,
                                                        3, 0.5)


@pytest.mark.parametrize("temp,top_k,top_p", [(0.8, 40, 0.95), (1.0, None,
                                                                 1.0),
                                              (1.3, 10, 0.7)],
                         ids=lambda v: repr(v))
def test_device_draw_follows_the_filtered_distribution(temp, top_k, top_p):
    """``sample_batched`` (the decode step's Gumbel-max draw) fed by
    ``pack_params``, as the engine feeds it: 20000 rows with fixed keys
    over one 64-token logit row, chi-square against ``filtered_probs``;
    nothing lands outside the support."""
    rng = np.random.RandomState(11)
    x = (rng.randn(64) * 1.5).astype(np.float32)
    N = 20000
    keys = np.stack([sampling.seq_key(2024, i) for i in range(N)])
    out = sampling.sample_batched(
        torch.from_numpy(x)[None].expand(N, 64), sampling.pack_params(
            keys, np.full(N, 9), np.full(N, temp), np.full(N, top_k or 0),
            np.full(N, top_p)))
    p = sampling.filtered_probs(x, temp, top_k, top_p)
    chi2, df, outside = _chi2(np.bincount(out.numpy(), minlength=64), p, N)
    assert outside == 0
    assert chi2 < _chi2_bound(df), (chi2, df)


def test_host_draw_follows_the_filtered_distribution():
    """``sample_host`` (inverse CDF at one uniform), one draw per
    position of one key."""
    rng = np.random.RandomState(12)
    x = (rng.randn(64) * 1.5).astype(np.float32)
    temp, top_k, top_p = 0.8, 40, 0.95
    key = sampling.seq_key(99, 0)
    N = 8000
    counts = np.zeros(64)
    for pos in range(N):
        counts[sampling.sample_host(x, key, pos, temp, top_k, top_p)] += 1
    chi2, df, outside = _chi2(counts,
                              sampling.filtered_probs(x, temp, top_k, top_p),
                              N)
    assert outside == 0
    assert chi2 < _chi2_bound(df), (chi2, df)


def test_spec_accept_resample_preserves_target_distribution():
    """Leviathan rejection with a point-mass (greedy) draft: accept d
    with probability p[d], else draw the residual — the marginal is the
    filtered target distribution (``tests/test_serve_sampling.py:125``,
    the same logits, filters and bound)."""
    rng = np.random.RandomState(7)
    logits = rng.randn(6).astype(np.float32) * 1.5
    p = sampling.filtered_probs(logits, 1.1, None, 0.95)
    d = int(np.argmax(logits))
    key = sampling.seq_key(1234, 0)
    N = 4000
    counts = np.zeros(len(p))
    for pos in range(N):
        if sampling.accept_draw(key, pos) < p[d]:
            counts[d] += 1
        else:
            counts[sampling.residual_sample(p, d, key, pos)] += 1
    chi2, _, outside = _chi2(counts, p, N)
    assert chi2 < 20.5, (chi2, counts, p * N)
    assert outside == 0


def test_accept_uniform_is_not_the_resample_uniform():
    key = sampling.seq_key(5, 1)
    a = [sampling.accept_draw(key, pos) for pos in range(200)]
    u = [sampling._uniform(sampling.token_key(key, pos))
         for pos in range(200)]
    assert all(x != y for x, y in zip(a, u))
    assert abs(np.corrcoef(a, u)[0, 1]) < 0.2


def test_keys_are_pure_functions_of_seed_sample_and_position():
    """A key depends only on (seed, sample index) and a token's key only
    on (key, position); the row words hashed on tensors give the bits
    hashed on numpy arrays and on Python ints."""
    assert np.array_equal(sampling.seq_key(3, 1), sampling.seq_key(3, 1))
    assert np.array_equal(sampling.seq_key(3 + 2 ** 31, 1),
                          sampling.seq_key(3, 1))   # seed % 2**31, as JAX
    keys = {tuple(sampling.seq_key(s, i)) for s in range(20)
            for i in range(5)}
    assert len(keys) == 100
    base = sampling.seq_key(8, 0)
    toks = [sampling.token_key(base, p) for p in range(300)]
    assert len({tuple(k) for k in toks}) == 300
    keys = np.stack([base] * 300).astype(np.int64)
    host = np.stack(sampling.row_words(keys, np.arange(300)), axis=1)
    dev = torch.stack(sampling.row_words(torch.from_numpy(keys),
                                         torch.arange(300)), dim=1)
    assert np.array_equal(dev.numpy(), host)
    t = toks[5]
    assert host[5].tolist() == [sampling._hash(int(t[0]), int(t[1]), 7),
                                sampling._hash(int(t[1]), int(t[0]), 8)]


@pytest.mark.parametrize("width", [1, 3, 8, 17])
def test_a_draw_does_not_depend_on_batch_row_or_width(width):
    """The same (logits, key, position, filters) row gives the same token
    at any row of any batch width, whatever the other rows hold."""
    rng = np.random.RandomState(width)
    x = (rng.randn(V) * 2).astype(np.float32)
    key = sampling.seq_key(42, 3)
    alone = sampling.sample_batched(torch.from_numpy(x)[None],
                                    sampling.pack_params(key[None], [17],
                                                         [0.9], [40], [0.95]))
    for row in range(width):
        logits = rng.randn(width, V).astype(np.float32)
        keys = rng.randint(0, 2 ** 32, (width, 2)).astype(np.int64)
        pos = rng.randint(0, 1000, width)
        logits[row], keys[row], pos[row] = x, key, 17
        packed = sampling.pack_params(keys, pos, np.full(width, 0.9),
                                      np.full(width, 40),
                                      np.full(width, 0.95))
        out = sampling.sample_batched(torch.from_numpy(logits), packed)
        assert out[row] == alone[0]
    words = torch.from_numpy(packed[:, :2]).long()
    noise = sampling.gumbel_noise(words, V)
    assert torch.equal(noise[row], sampling.gumbel_noise(
        words[row:row + 1], V)[0])


def test_fused_host_draw_is_one_device_row_and_packing_is_exact():
    rng = np.random.RandomState(4)
    x = (rng.randn(V) * 2).astype(np.float32)
    key = sampling.seq_key(77, 2)
    packed = sampling.pack_params(key[None], [31], [0.7], [12], [0.8])
    words = sampling.row_words(key[None].astype(np.int64), np.array([31]))
    assert packed[0, :2].tolist() == [int(words[0][0]), int(words[1][0])]
    assert packed[0, 2:].tolist() == [np.float32(0.7), 12, np.float32(0.8)]
    row = sampling.sample_batched(torch.from_numpy(x)[None],
                                  torch.from_numpy(packed))
    assert sampling.sample_host_fused(x, key, 31, 0.7, 12, 0.8) == int(row[0])


def test_residual_keeps_the_rejected_token_out():
    p = np.array([0.5, 0.3, 0.2])
    key = sampling.seq_key(1, 0)
    assert all(sampling.residual_sample(p, 0, key, pos) != 0
               for pos in range(200))
    assert sampling.residual_sample(np.array([1.0, 0.0]), 0, key, 0) == 0
    assert sampling.base_keys_array([None, key], 3).tolist() == \
        [[0, 0], key.tolist(), [0, 0]]

