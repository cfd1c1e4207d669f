"""The parts of the port's ring attention that need no world, against
the JAX package's functions on the same numpy inputs: the online fold
and the ragged fold trio, the striped layout, the per-hop decision
table, the masked-row merge, the schedule check and the mesh layout.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.parallel import ring

B, SQ, SK, H, D = 2, 8, 8, 2, 16


def _inputs(seed=0):
    g = np.random.RandomState(seed)
    return [(g.randn(B, s, H, D) * 0.5).astype(np.float32)
            for s in (SQ, SK, SK)]


def _jnp(*xs):
    import jax.numpy as jnp
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_ragged_fold_trio_matches_jax(mode):
    """Two ragged extents folded into an empty state and normalized, in
    each mask mode, with traced offsets and a padded extent (k_len <
    Sk), against JAX's ragged_fold_init / ragged_fold /
    ragged_fold_finish."""
    from horovod_tpu.parallel import ring as jring
    q, k, v = _inputs(mode)
    k2, v2 = _inputs(10 + mode)[1:]
    scale = 1.0 / np.sqrt(D)
    extents = ((k, v, 0, SK), (k2, v2, SK, 5))   # (k, v, k_start, k_len)
    jq = _jnp(q)[0]
    st = jring.ragged_fold_init(jq)
    tq = torch.from_numpy(q)
    ts = ring.ragged_fold_init(tq)
    for kk, vv, k_start, k_len in extents:
        jk, jv = _jnp(kk, vv)
        st = jring.ragged_fold(jq, jk, jv, q_start=4, k_start=k_start,
                               k_len=k_len, acc=st[0], m=st[1], l=st[2],
                               scale=scale, mask_mode=mode)
        ts = ring.ragged_fold(tq, torch.from_numpy(kk), torch.from_numpy(vv),
                              q_start=4, k_start=k_start, k_len=k_len,
                              acc=ts[0], m=ts[1], l=ts[2], scale=scale,
                              mask_mode=mode)
    for got, want in zip(ts, st):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(ring.ragged_fold_finish(*ts).numpy(),
                               np.asarray(jring.ragged_fold_finish(*st)),
                               rtol=2e-5, atol=1e-6)


def test_online_fold_matches_jax_and_masked_block_is_a_no_op():
    """online_fold of a real block then a fully masked one against
    JAX's; the masked fold leaves the state's bits unchanged, and on an
    empty state it keeps the output at exactly 0."""
    from horovod_tpu.parallel import ring as jring
    q, k, v = _inputs(3)
    s = (np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)).astype(np.float32)
    masked = np.full_like(s, -1e30)
    v32 = torch.from_numpy(v)
    st = ring.ragged_fold_init(torch.from_numpy(q))
    empty = ring.online_fold(torch.from_numpy(masked), v32, *st)
    assert float(empty[0].abs().max()) == 0.0
    assert float(ring.ragged_fold_finish(*empty).abs().max()) == 0.0
    st = ring.online_fold(torch.from_numpy(s), v32, *st)
    after = ring.online_fold(torch.from_numpy(masked), v32, *st)
    for a, b in zip(after, st):
        assert torch.equal(a, b)
    js = jring.ragged_fold_init(_jnp(q)[0])
    js = jring.online_fold(*_jnp(s, v), *js)
    for got, want in zip(st, js):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("n,axis", [(4, 1), (2, 0), (8, 1)])
def test_stripe_unstripe_match_jax(n, axis):
    from horovod_tpu.parallel import ring as jring
    x = np.arange(2 * 16 * 3).reshape(2, 16, 3)
    if axis == 0:
        x = x.transpose(1, 0, 2).copy()
    got = ring.stripe_sequence(torch.from_numpy(x), n, axis=axis)
    want = np.asarray(jring.stripe_sequence(_jnp(x)[0], n, axis=axis))
    np.testing.assert_array_equal(got.numpy(), want)
    back = ring.unstripe_sequence(got, n, axis=axis)
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="divisible"):
        ring.stripe_sequence(torch.zeros(2, 15), n, axis=1)


def _jax_arms(my, owner, causal, striped, schedule, s_local):
    """The arm ``ring_flash_attention``'s fold takes, read off
    ``horovod_tpu/parallel/ring.py:508-535``: ("kernel", mode), or
    ("forced", mode) for a kernel whose lse the serial schedule forces
    to -inf, or ("skip",)."""
    allow_skip = schedule == "overlap"
    if causal and striped:
        if owner <= my:
            return ("kernel", 1)
        return ("skip",) if allow_skip and s_local == 1 else ("kernel", 2)
    if causal:
        if allow_skip:
            arm = int(owner >= my) + int(owner > my)
            return [("kernel", 0), ("kernel", 1), ("skip",)][arm]
        mode = 1 if owner == my else 0
        return ("forced", mode) if owner > my else ("kernel", mode)
    return ("kernel", 0)


@pytest.mark.parametrize("schedule", ["overlap", "serial"])
@pytest.mark.parametrize("causal,striped", [(False, False), (True, False),
                                            (True, True), (False, True)])
@pytest.mark.parametrize("s_local", [1, 16])
def test_hop_plan_matches_jax_arms(schedule, causal, striped, s_local):
    n = 4
    for my in range(n):
        for owner in range(n):
            mode, forced = ring._hop_plan(my, owner, causal=causal,
                                          striped=striped,
                                          schedule=schedule, s_local=s_local)
            got = ("skip",) if mode is None else \
                ("forced" if forced else "kernel", mode)
            assert got == _jax_arms(my, owner, causal, striped, schedule,
                                    s_local), (my, owner)


def test_merge_gives_masked_source_weight_zero():
    """A source whose lse is -1e30 (or the kernel's masked-row
    -1e30 / 2 + log 1e-30) adds exactly nothing, whatever its output
    holds; two masked sources give 0 and stay masked; two real ones
    merge by logsumexp."""
    g = np.random.RandomState(1)
    o_a = torch.from_numpy(g.randn(1, 3, 2, 4).astype(np.float32))
    lse_a = torch.from_numpy(g.randn(1, 2, 3).astype(np.float32))
    junk = torch.full((1, 3, 2, 4), 7.0)
    for masked in (-1e30, -1e30 / 2 + np.log(1e-30)):
        lse_m = torch.full((1, 2, 3), masked, dtype=torch.float32)
        out, lse = ring._merge(o_a, lse_a, junk, lse_m)
        assert torch.equal(out, o_a) and torch.equal(lse, lse_a)
        out, lse = ring._merge(torch.zeros_like(junk), lse_m, o_a, lse_a)
        assert torch.equal(out, o_a) and torch.equal(lse, lse_a)
        out, lse = ring._merge(torch.zeros_like(junk), lse_m, junk, lse_m)
        assert float(out.abs().max()) == 0.0
        assert bool((lse <= ring.NEG_INF * 0.5).all())
    o_b = torch.from_numpy(g.randn(1, 3, 2, 4).astype(np.float32))
    lse_b = torch.from_numpy(g.randn(1, 2, 3).astype(np.float32))
    out, lse = ring._merge(o_a, lse_a, o_b, lse_b)
    want_lse = np.logaddexp(lse_a.numpy(), lse_b.numpy())
    w = lambda l: np.exp(l - want_lse).transpose(0, 2, 1)[..., None]  # noqa
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-6)
    np.testing.assert_allclose(
        out.numpy(), o_a.numpy() * w(lse_a.numpy())
        + o_b.numpy() * w(lse_b.numpy()), rtol=1e-5, atol=1e-6)


def test_check_schedule_rejects_unknown():
    ring._check_schedule("overlap")
    ring._check_schedule("serial")
    with pytest.raises(ValueError, match="schedule"):
        ring._check_schedule("eager")


def test_make_mesh_row_major_layout_and_size_check():
    """make_mesh lays ranks out row-major, as the JAX package reshapes
    its devices; every line along an axis; and the size mismatch."""
    import jax
    from horovod_tpu.parallel import make_mesh as jax_make_mesh
    m = make_mesh({"dp": 2, "sp": 2}, devices=range(4))
    np.testing.assert_array_equal(m.devices, [[0, 1], [2, 3]])
    jm = jax_make_mesh({"dp": 2, "sp": 2}, devices=jax.devices()[:4])
    np.testing.assert_array_equal(
        m.devices, np.vectorize(lambda d: d.id)(jm.devices))
    assert m.shape == {"dp": 2, "sp": 2} and m.size == 4
    assert m.lines("sp") == [(0, 1), (2, 3)]
    assert m.lines("dp") == [(0, 2), (1, 3)]
    assert m.lines("dp", "sp") == [(0, 1, 2, 3)]
    assert m.line(3, "dp") == (1, 3) and m.coords(2) == (1, 0)
    m3 = make_mesh({"a": 2, "b": 3, "c": 2}, devices=range(12))
    assert m3.lines("b")[:2] == [(0, 2, 4), (1, 3, 5)]
    assert m3.line(7, "a", "c") == (0, 1, 6, 7)
    assert m3.coords(7) == (1, 0, 1)
    with pytest.raises(ValueError, match="needs 6 devices, have 4"):
        make_mesh({"dp": 2, "sp": 3}, devices=range(4))
    with pytest.raises(ValueError, match="needs 6 devices, have 4"):
        jax_make_mesh({"dp": 2, "sp": 3}, devices=jax.devices()[:4])


@pytest.mark.parametrize("schedule", ["overlap", "serial"])
@pytest.mark.parametrize("causal,striped", [(False, False), (True, False),
                                            (True, True)])
def test_virtual_ring_matches_jax_dense(causal, striped, schedule):
    """``virtual_ring_flash_attention``, the ring's own per-rank hop code
    (``_rank_hops``) over 4 virtual shards on one device, against JAX's
    ``ring_attention_reference`` over the whole sequence: the output and
    dq, dk, dv of sum(out · w), at the ring tolerances; the hop calls
    are those ``_hop_plan`` gives (a serial contiguous-causal ring runs
    every hop, its hops above the diagonal forced to weight 0)."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu.parallel.ring import ring_attention_reference
    n, g = 4, np.random.RandomState(3)
    q, k, v, w = ((g.randn(1, 32, H, D) * 0.5).astype(np.float32)
                  for _ in range(4))

    def f(a, b, c):
        return jnp.sum(ring_attention_reference(a, b, c, causal=causal) * w)

    want = ring_attention_reference(*_jnp(q, k, v), causal=causal)
    want_g = jax.grad(f, argnums=(0, 1, 2))(*_jnp(q, k, v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    calls = []
    ring.set_ring_kernel_callback(calls.append)
    try:
        out = ring.virtual_ring_flash_attention(
            *leaves, n, causal=causal, striped=striped, schedule=schedule)
    finally:
        ring.set_ring_kernel_callback(None)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)
    for t, wg in zip(leaves, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg),
                                   rtol=2e-4, atol=2e-5)
    hops = n * (n + 1) // 2 if causal and not striped and \
        schedule == "overlap" else n * n
    assert len(calls) == hops
    assert calls.count(2) == (n * (n - 1) // 2 if striped else 0)
