"""Sequence parallelism of the port in a real 4-process gloo world,
against the JAX package on an emulated 4-rank mesh, on the same numpy
data.

One world serves every check: a module fixture writes the data and the
JAX models' converted weights to a file and starts four workers
(``hvd.init(device="cpu")``); each runs ``ring_attention`` and
``ring_flash_attention`` (overlap and serial; non-causal, causal
contiguous and causal striped; output and dq / dk / dv of each rank's
``mean(out²)``), both in bf16, ``ulysses_attention``, the
differentiable collectives, the TINY transformer under each
``seq_parallel`` with flash, phase 2 of ``dryrun_multichip``
(``entry.dryrun_seqpar_step``) and the port-only counters, and saves
what it got.  The JAX side runs ``shard_map`` over 4 of the conftest's
8 CPU devices.

The port's flash ring is held to JAX's einsum ring, which JAX pins
equal to its own flash ring at atol 2e-5
(``tests/test_sequence_parallel.py:222``); JAX's flash ring itself runs
once, non-causal, its causal cases being slow in interpret mode.
Tolerances: ring and Ulysses 2e-4 / 2e-5 (``:41``), the flash ring
atol 2e-5 (``:222``), bf16 atol 2e-2 (``:228``), the transformer 2e-3
(``:253``).
"""

import json

import numpy as np
import pytest

from test_torch_collectives import run_gloo_world

N = 4
B, S, H, D = 2, 64, 4, 16          # S_local 16
RTOL, ATOL = 2e-4, 2e-5
LAYOUTS = ((False, False), (True, False), (True, True))  # causal, striped
RAGGED = (2, 0, 3, 1)
REMAT = (1, 4 * 128, 2, 16)        # B, S, H, D of the remat case
TINY = dict(vocab_size=128, num_layers=2, num_heads=8, d_model=64,
            d_ff=128, max_len=64, causal=True)


def _rng_data():
    g = np.random.RandomState(0)
    mk = lambda *shape: (g.randn(*shape) * 0.3).astype(np.float32)  # noqa
    d = {"q": mk(B, S, H, D), "k": mk(B, S, H, D), "v": mk(B, S, H, D),
         "q1": mk(1, N, 2, 16), "k1": mk(1, N, 2, 16), "v1": mk(1, N, 2, 16),
         "rq": mk(*REMAT), "rk": mk(*REMAT), "rv": mk(*REMAT),
         "uq": mk(B, S, 8, D), "uk": mk(B, S, 8, D), "uv": mk(B, S, 8, D),
         "tokens": np.random.RandomState(3).randint(0, 128, (2, 64)),
         "tiny_w": (np.random.RandomState(4).randn(2, 64, 128)
                    * 0.3).astype(np.float32)}
    for r in range(N):
        d[f"a2a_x{r}"] = mk(8, 3)
        d[f"a2a_w{r}"] = mk(8, 3)
        d[f"ag_x{r}"] = mk(2, 3)
        d[f"ag_w{r}"] = mk(2 * N, 3)
        d[f"agr_x{r}"] = mk(RAGGED[r], 3)
        d[f"agr_w{r}"] = mk(sum(RAGGED), 3)
        d[f"rs_x{r}"] = mk(8, 3)
        d[f"rs_w{r}"] = mk(2, 3)
    return d


WORKER = '''
import json
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import entry
from horovod_tpu_torch.models.transformer import Transformer, \\
    TransformerConfig
from horovod_tpu_torch.parallel import ring, ulysses
from horovod_tpu_torch.parallel.ring import (
    ring_attention, ring_flash_attention, stripe_sequence)
from horovod_tpu_torch.timeline import Timeline

torch.set_num_threads(1)
out_path = sys.argv[1]
N, LAYOUTS, RAGGED, TINY = %(consts)r
hvd.init(device="cpu")
r = hvd.rank()
assert hvd.size() == N and hvd.mesh().shape == {"hvd": N}
data = dict(np.load(DATA))
res = {}


def save(key, t):
    res[key] = t.detach().float().numpy().copy() \\
        if isinstance(t, torch.Tensor) else np.asarray(t)


def shard(x, striped=False):
    x = torch.from_numpy(data[x] if isinstance(x, str) else x)
    if striped:
        x = stripe_sequence(x, N)
    s = x.shape[1] // N
    return x[:, r * s:(r + 1) * s].clone()


fns = {"ring": ring_attention, "flash": ring_flash_attention}
for causal, striped in LAYOUTS:
    for fname, fn in fns.items():
        for sched in ("overlap", "serial"):
            a, b, c = (shard(x, striped).requires_grad_()
                       for x in ("q", "k", "v"))
            o = fn(a, b, c, causal=causal, striped=striped, schedule=sched)
            (o ** 2).mean().backward()
            key = f"{fname}_{int(causal)}{int(striped)}_{sched}"
            for part, t in (("o", o), ("dq", a.grad), ("dk", b.grad),
                            ("dv", c.grad)):
                save(f"{key}_{part}", t)
for fname, fn in fns.items():
    o = fn(*(shard(x).bfloat16() for x in ("q", "k", "v")))
    assert o.dtype == torch.bfloat16
    save(f"{fname}_bf16", o)
# dq comes back in q's dtype through the f32 hops.
a = shard("q").bfloat16().requires_grad_()
ring_flash_attention(a, shard("k").bfloat16(), shard("v").bfloat16(),
                     causal=True).float().sum().backward()
save("flash_bf16_dq_is_bf16", a.grad.dtype == torch.bfloat16)

# Hop kernels actually run (the callback) and rotations, per call.
modes = []
ring.set_ring_kernel_callback(modes.append)
with torch.no_grad():
    for sched in ("overlap", "serial"):
        modes.clear()
        ring.ROTATIONS.update(forward=0, backward=0)
        ring_flash_attention(shard("q"), shard("k"), shard("v"),
                             causal=True, schedule=sched)
        save(f"calls_{sched}", modes)
        save(f"rotations_{sched}", ring.ROTATIONS["forward"])
        ring.ROTATIONS.update(forward=0, backward=0)
        ring_attention(shard("q"), shard("k"), shard("v"), causal=True,
                       schedule=sched)
        save(f"rotations_einsum_{sched}", ring.ROTATIONS["forward"])
    modes.clear()
    ring_flash_attention(*(shard(x, True) for x in ("q1", "k1", "v1")),
                         causal=True, striped=True)
    save("calls_striped_one_row", modes)
ring.set_ring_kernel_callback(None)
ring.ROTATIONS.update(forward=0, backward=0)
a, b, c = (shard(x).requires_grad_() for x in ("q", "k", "v"))
ring_flash_attention(a, b, c, causal=True).sum().backward()
save("rotations_fwd_bwd", [ring.ROTATIONS["forward"],
                           ring.ROTATIONS["backward"]])

# The timeline's ring_hop events (the hop schedule).
tl_path = out_path + ".timeline.json"
tl = Timeline(tl_path, rank=r)
ring.set_ring_timeline(tl, "tltest")
for _ in range(2):   # one configuration: written once
    ring_attention(shard("q"), shard("k"), shard("v"), causal=True)
ring.set_ring_timeline(None)
tl.close()
res["timeline"] = np.asarray(open(tl_path).read())

# remat_hops: same gradients, fewer saved bytes.
for remat in (True, False):
    seen, total = set(), [0]

    def pack(t):
        key = (t.untyped_storage().data_ptr(), t.untyped_storage().nbytes())
        if key not in seen:
            seen.add(key)
            total[0] += key[1]
        return t

    a, b, c = (shard(x).requires_grad_() for x in ("rq", "rk", "rv"))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = ring_attention(a, b, c, causal=True, remat_hops=remat)
    (o ** 2).mean().backward()
    save(f"remat{int(remat)}_bytes", total[0])
    save(f"remat{int(remat)}_dq", a.grad)
    save(f"remat{int(remat)}_dk", b.grad)

# Ulysses.
for causal in (False, True):
    a, b, c = (shard(x).requires_grad_() for x in ("uq", "uk", "uv"))
    o = ulysses.ulysses_attention(a, b, c, causal=causal)
    (o ** 2).mean().backward()
    for part, t in (("o", o), ("dq", a.grad), ("dk", b.grad),
                    ("dv", c.grad)):
        save(f"uly_{int(causal)}_{part}", t)
x = shard("uq")
save("seq_to_heads", ulysses.seq_to_heads(x))
save("uly_roundtrip", ulysses.heads_to_seq(ulysses.seq_to_heads(x)))
try:
    ulysses.seq_to_heads(torch.ones(2, 4, 6, 16))
    save("uly_error", "")
except ValueError as e:
    save("uly_error", str(e))
save("striped_positions", ring.striped_positions(4))

# The differentiable collectives.
def grad_of(key, op):
    x = torch.from_numpy(data[f"{key}_x{r}"]).requires_grad_()
    (op(x) * torch.from_numpy(data[f"{key}_w{r}"])).sum().backward()
    save(f"{key}_grad", x.grad)

grad_of("a2a", lambda x: hvd.alltoall(x, name="a2a"))
grad_of("ag", lambda x: hvd.allgather(x))
grad_of("agr", lambda x: hvd.allgather(x, name="ragged"))
grad_of("rs", lambda x: hvd.reducescatter(x, op=hvd.Sum))
data.update({f"rsa_{k}{i}": data[f"rs_{k}{i}"] for k in "xw"
             for i in range(N)})
grad_of("rsa", lambda x: hvd.reducescatter(
    x, op=hvd.Average, prescale_factor=0.5, postscale_factor=3.0))

# The TINY transformer under each seq_parallel, flash attention.
state = {k[2:]: torch.from_numpy(v) for k, v in data.items()
         if k.startswith("w.")}
toks = data["tokens"]
for sp, impl in (("ring", "flash"), ("ring_striped", "flash"),
                 ("ulysses", "flash"), ("ring", None)):
    model = Transformer(TransformerConfig(
        **TINY, dtype=torch.float32, seq_parallel=sp,
        attention_impl=impl), device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        logits = model(shard(toks, sp == "ring_striped"))
    save(f"tiny_{sp}_{impl}", logits)

# remat with seq_parallel: each block recomputed in the backward, its
# rotations or exchanges included; the parameter gradients of
# sum(logits * w) over this rank's shard.
for sp in ("ring", "ring_striped", "ulysses"):
    st = sp == "ring_striped"
    model = Transformer(TransformerConfig(
        **TINY, dtype=torch.float32, seq_parallel=sp, attention_impl="flash",
        remat=True), device="cpu")
    model.load_state_dict(state)
    ring.ROTATIONS.update(forward=0, backward=0)
    logits = model(shard(toks, st))
    (logits * shard("tiny_w", st)).sum().backward()
    save(f"remat_{sp}_logits", logits)
    save(f"remat_{sp}_rotations", [ring.ROTATIONS["forward"],
                                   ring.ROTATIONS["backward"]])
    for k, p in model.named_parameters():
        save(f"remat_{sp}_g.{k}", p.grad)

# Phase 2 of dryrun_multichip.
state2 = {k[3:]: torch.from_numpy(v) for k, v in data.items()
          if k.startswith("w2.")}
loss, model = entry.dryrun_seqpar_step(device="cpu", state_dict=state2)
save("p2_loss", loss)
for k, v in model.state_dict().items():
    save("p2." + k, v)
for k, v in model.named_parameters():
    save("p2g." + k, v.grad)
np.savez(out_path, **res)
hvd.shutdown()
'''


def _jax_tiny_params():
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import Transformer, TransformerConfig
    cfg = TransformerConfig(**TINY, dtype=jnp.float32, axis_name="hvd")
    toks = jnp.asarray(_rng_data()["tokens"])
    return cfg, Transformer(cfg).init(jax.random.PRNGKey(0), toks)


def _jax_phase2_setup():
    import dataclasses
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import Transformer, TransformerConfig
    dp, sp = 2, 2
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=sp,
                            d_model=64, d_ff=128, max_len=64, causal=True,
                            dtype=jnp.float32, seq_parallel="ring",
                            axis_name="sp")
    toks = jnp.asarray(np.random.RandomState(2).randint(
        0, 128, (2 * dp, 8 * sp)).astype(np.int32))
    params = Transformer(dataclasses.replace(cfg, seq_parallel=None)).init(
        jax.random.PRNGKey(1), toks[:1, :8])
    return cfg, toks, params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from horovod_tpu_torch.models import params_from_jax
    tmp = tmp_path_factory.mktemp("seqpar")
    data = _rng_data()
    for k, v in params_from_jax(_jax_tiny_params()[1]).items():
        data["w." + k] = v.numpy()
    for k, v in params_from_jax(_jax_phase2_setup()[2]).items():
        data["w2." + k] = v.numpy()
    np.savez(tmp / "data.npz", **data)
    script = WORKER % {"consts": (N, LAYOUTS, RAGGED, TINY)}
    script = script.replace("DATA", repr(str(tmp / "data.npz")))
    return run_gloo_world(script, tmp, size=N, timeout=600)


@pytest.fixture(scope="module")
def mesh4():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:N]), ("hvd",))


def _sharded(mesh, fn, n_in, n_out=1):
    import jax
    from jax.sharding import PartitionSpec as P
    spec = P(None, "hvd")
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec,) * n_in,
        out_specs=spec if n_out == 1 else (spec,) * n_out,
        check_vma=False))


def _port(world, key):
    """The ranks' shards of ``key`` concatenated along the sequence."""
    return np.concatenate([w[key] for w in world], axis=1)


def _stripe(x):
    from horovod_tpu.parallel.ring import stripe_sequence
    return np.asarray(stripe_sequence(x, N))


@pytest.fixture(scope="module")
def jax_rings(mesh4):
    """JAX's einsum ring (default schedule) for each layout: output and
    the gradients of each shard's mean(out²); and in bf16."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu.parallel.ring import ring_attention
    d = _rng_data()
    out = {}
    for causal, striped in LAYOUTS:
        def run(q, k, v, causal=causal, striped=striped):
            f = lambda a, b, c: ring_attention(  # noqa: E731
                a, b, c, causal=causal, striped=striped)
            g = jax.grad(lambda a, b, c: jnp.mean(f(a, b, c) ** 2),
                         argnums=(0, 1, 2))(q, k, v)
            return (f(q, k, v),) + g
        qkv = [_stripe(d[x]) if striped else d[x] for x in "qkv"]
        out[(causal, striped)] = [np.asarray(t) for t in _sharded(
            mesh4, run, 3, 4)(*qkv)]
    bf = [jnp.asarray(d[x], jnp.bfloat16) for x in "qkv"]
    out["bf16"] = np.asarray(_sharded(mesh4, ring_attention, 3)(*bf),
                             np.float32)
    return out


@pytest.mark.parametrize("sched", ["overlap", "serial"])
@pytest.mark.parametrize("fname", ["ring", "flash"])
@pytest.mark.parametrize("causal,striped", LAYOUTS)
def test_ring_matches_jax(world, jax_rings, fname, causal, striped, sched):
    """The port's einsum ring and flash ring, both schedules, against
    JAX's ring_attention on the same shards: the output and dq, dk, dv
    (the K/V gradients include what came back through the inverse
    rotations)."""
    want = jax_rings[(causal, striped)]
    key = f"{fname}_{int(causal)}{int(striped)}_{sched}"
    for i, part in enumerate(("o", "dq", "dk", "dv")):
        got = _port(world, f"{key}_{part}")
        if fname == "ring":
            np.testing.assert_allclose(got, want[i], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{key} {part}")
        else:
            np.testing.assert_allclose(got, want[i], atol=2e-5,
                                       err_msg=f"{key} {part}")


@pytest.mark.parametrize("fname", ["ring", "flash"])
def test_ring_bf16_io_matches_jax(world, jax_rings, fname):
    np.testing.assert_allclose(_port(world, f"{fname}_bf16"),
                               jax_rings["bf16"], atol=2e-2)
    assert all(bool(w["flash_bf16_dq_is_bf16"]) for w in world)


def test_jax_flash_ring_matches_port_non_causal(world, mesh4):
    """JAX's own flash ring (Pallas in interpret mode), non-causal, the
    one case cheap enough here, against the port's flash ring."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu.parallel.ring import ring_flash_attention
    d = _rng_data()

    def run(q, k, v):
        f = lambda a, b, c: ring_flash_attention(a, b, c)  # noqa: E731
        g = jax.grad(lambda a, b, c: jnp.mean(f(a, b, c) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
        return (f(q, k, v),) + g

    want = _sharded(mesh4, run, 3, 4)(*(d[x] for x in "qkv"))
    for part, w in zip(("o", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(_port(world, f"flash_00_overlap_{part}"),
                                   np.asarray(w), atol=2e-5, err_msg=part)


def test_hop_kernels_launch_only_where_attended(world):
    """Contiguous causal: n(n+1)/2 hop kernels under "overlap" (rank r
    runs r + 1: NONE below the diagonal, CAUSAL on it, nothing above),
    n² under "serial"; striped with one row per shard skips its strict
    hops, n(n+1)/2 again."""
    over = [list(w["calls_overlap"]) for w in world]
    assert [len(c) for c in over] == [r + 1 for r in range(N)]
    assert sum(len(c) for c in over) == N * (N + 1) // 2
    for r, c in enumerate(over):
        assert sorted(c) == [0] * r + [1]
    assert sum(len(w["calls_serial"]) for w in world) == N * N
    assert sum(len(w["calls_striped_one_row"]) for w in world) == \
        N * (N + 1) // 2


def test_rotation_counts(world):
    """n - 1 rotations under "overlap", n under "serial", both rings;
    the backward runs the inverse of every forward rotation on every
    rank, the ranks that skipped hops included."""
    for w in world:
        assert int(w["rotations_overlap"]) == N - 1
        assert int(w["rotations_serial"]) == N
        assert int(w["rotations_einsum_overlap"]) == N - 1
        assert int(w["rotations_einsum_serial"]) == N
        assert list(w["rotations_fwd_bwd"]) == [N - 1, N - 1]


def test_timeline_records_hop_schedule(world):
    """One ring_hop event per hop, once per configuration, with
    _emit_hop_schedule's fields: bytes rotated, mask rule, schedule and
    the skipped shards of the true skip."""
    for w in world:
        events = [e for e in json.loads(str(w["timeline"]))
                  if e.get("name", "").startswith("RING_HOP")]
        assert len(events) == N
        hops = {e["args"]["hop"]: e for e in events}
        assert set(hops) == set(range(N))
        for hop, e in hops.items():
            assert e["tid"] == "tltest/ring_attention"
            assert e["args"] == {
                "hop": hop, "bytes_rotated": 2 * B * (S // N) * H * D * 4,
                "mask": "causal-contiguous", "schedule": "overlap",
                "skipped_shards": N - hop if hop else 0}


def test_remat_hops_same_gradients_fewer_saved_bytes(world):
    for w in world:
        for part in ("dq", "dk"):
            np.testing.assert_allclose(w[f"remat1_{part}"],
                                       w[f"remat0_{part}"], atol=1e-6)
        assert int(w["remat1_bytes"]) < 0.75 * int(w["remat0_bytes"]), \
            (int(w["remat1_bytes"]), int(w["remat0_bytes"]))


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(world, mesh4, causal):
    import jax
    import jax.numpy as jnp
    from horovod_tpu.parallel.ring import ring_attention_reference
    from horovod_tpu.parallel.ulysses import ulysses_attention
    d = _rng_data()

    def run(q, k, v):
        f = lambda a, b, c: ulysses_attention(  # noqa: E731
            a, b, c, causal=causal)
        g = jax.grad(lambda a, b, c: jnp.mean(f(a, b, c) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
        return (f(q, k, v),) + g

    want = _sharded(mesh4, run, 3, 4)(*(d[x] for x in ("uq", "uk", "uv")))
    for part, w in zip(("o", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(_port(world, f"uly_{int(causal)}_{part}"),
                                   np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=part)
    dense = ring_attention_reference(d["uq"], d["uk"], d["uv"],
                                     causal=causal)
    np.testing.assert_allclose(_port(world, f"uly_{int(causal)}_o"),
                               np.asarray(dense), rtol=RTOL, atol=ATOL)


def test_ulysses_exchange_and_roundtrip(world, mesh4):
    import jax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel.ulysses import seq_to_heads
    d = _rng_data()
    want = jax.jit(jax.shard_map(
        seq_to_heads, mesh=mesh4, in_specs=P(None, "hvd"),
        out_specs=P(None, None, "hvd")))(d["uq"])
    got = np.concatenate([w["seq_to_heads"] for w in world], axis=2)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(_port(world, "uly_roundtrip"), d["uq"])


def test_ulysses_head_divisibility_error(world):
    for w in world:
        msg = str(w["uly_error"])
        assert "divisible" in msg and "heads (6)" in msg, msg


def test_striped_positions(world, mesh4):
    import jax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel.ring import striped_positions
    want = np.asarray(jax.jit(jax.shard_map(
        lambda: striped_positions(4)[None], mesh=mesh4, in_specs=(),
        out_specs=P("hvd")))())
    got = np.stack([w["striped_positions"] for w in world])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", ["a2a", "ag", "rs", "rsa"])
def test_collective_gradients_match_jax(world, mesh4, key):
    """Each rank's d/dx of sum(op(x) · w) through the differentiable
    alltoall (its backward the inverse alltoall), allgather (a
    reduce-scatter) and reducescatter (an allgather; Average with
    pre/post scale), against jax.grad of the lax collectives."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P
    d = _rng_data()
    src = "rs" if key == "rsa" else key
    ops = {"a2a": lambda x: lax.all_to_all(x, "hvd", 0, 0, tiled=True),
           "ag": lambda x: lax.all_gather(x, "hvd", tiled=True),
           "rs": lambda x: lax.psum_scatter(x, "hvd", tiled=True),
           "rsa": lambda x: lax.psum_scatter(0.5 * x, "hvd", tiled=True)
           / N * 3.0}
    xs = np.concatenate([d[f"{src}_x{r}"] for r in range(N)])
    ws = np.concatenate([d[f"{src}_w{r}"] for r in range(N)])
    grad = jax.jit(jax.shard_map(
        jax.grad(lambda x, w: jnp.sum(ops[key](x) * w)), mesh=mesh4,
        in_specs=(P("hvd"), P("hvd")), out_specs=P("hvd")))(xs, ws)
    got = np.concatenate([w[f"{key}_grad"] for w in world])
    np.testing.assert_allclose(got, np.asarray(grad), rtol=1e-6, atol=1e-6)


def test_ragged_allgather_gradient(world):
    """The ragged allgather's backward: rank r's rows get the sum over
    ranks of the cotangent rows that hold them (port only: JAX gathers
    equal shapes in a trace)."""
    d = _rng_data()
    total = sum(d[f"agr_w{r}"] for r in range(N))
    start = 0
    for r, w in enumerate(world):
        want = total[start:start + RAGGED[r]]
        start += RAGGED[r]
        np.testing.assert_allclose(w["agr_grad"], want, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("sp,impl", [("ring", "flash"),
                                     ("ring_striped", "flash"),
                                     ("ulysses", "flash"), ("ring", None)])
def test_tiny_transformer_seq_parallel_matches_jax_dense(world, sp, impl):
    """TINY (``tests/test_sequence_parallel.py:233``) from JAX's weights:
    each rank's logits of its shard under ``seq_parallel`` (positions
    from the model: offset shards, or striped_positions) against JAX's
    dense logits of the whole sequence."""
    from horovod_tpu.models import Transformer
    cfg, params = _jax_tiny_params()
    toks = _rng_data()["tokens"]
    want = np.asarray(Transformer(cfg).apply(params, toks))
    got = _port(world, f"tiny_{sp}_{impl}")
    if sp == "ring_striped":
        from horovod_tpu.parallel.ring import unstripe_sequence
        got = np.asarray(unstripe_sequence(got, N))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("sp", ["ring", "ring_striped", "ulysses"])
def test_tiny_transformer_remat_seq_parallel_matches_jax(world, sp):
    """TINY with ``remat`` under each ``seq_parallel`` (flash), against
    JAX's remat transformer (``nn.remat(Block)``) over the whole
    sequence: each rank's logits, and the parameter gradients of
    sum(logits * w) summed over the ranks against jax.grad of the same
    sum.  The ring's forward rotations are counted twice (the forward,
    then the recompute) and its inverse rotations once: the recompute
    ran every block's rotations, in one order on every rank."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import Transformer
    from horovod_tpu_torch.models import params_from_jax
    cfg, params = _jax_tiny_params()
    model = Transformer(dataclasses.replace(cfg, remat=True))
    d = _rng_data()
    toks, w = d["tokens"], d["tiny_w"]
    want = np.asarray(model.apply(params, toks))
    want_g = params_from_jax(jax.device_get(jax.grad(
        lambda p: jnp.sum(model.apply(p, toks) * w))(params)))
    got = _port(world, f"remat_{sp}_logits")
    if sp == "ring_striped":
        from horovod_tpu.parallel.ring import unstripe_sequence
        got = np.asarray(unstripe_sequence(got, N))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    for k, v in want_g.items():
        np.testing.assert_allclose(
            sum(w_[f"remat_{sp}_g.{k}"] for w_ in world), v.numpy(),
            rtol=2e-3, atol=2e-3, err_msg=k)
    layers = TINY["num_layers"]
    for w_ in world:
        want_rot = [2 * layers * (N - 1), layers * (N - 1)] \
            if sp != "ulysses" else [0, 0]
        assert list(w_[f"remat_{sp}_rotations"]) == want_rot


def test_dryrun_seqpar_step_matches_jax_phase2(world):
    """Phase 2 of ``dryrun_multichip``: one Adam step on the dp=2 × sp=2
    mesh with ``DistributedOptimizer(reduce_axes=("dp", "sp"))``, from
    JAX's initial weights, against JAX's ``t_step``: the loss, every
    reduced gradient (the mean over the 4 shards, as Average over both
    axes gives), and every parameter after the step.  Adam's first step
    moves each element by lr·g/(|g| + 1e-8), so an element whose
    gradient is near 1e-8 turns an f32 rounding of g into up to lr in
    the parameter: the parameters are held at atol lr/100, the
    gradients at f32 rounding."""
    import jax
    import optax
    from jax.sharding import Mesh, PartitionSpec as P
    import horovod_tpu as jhvd
    from horovod_tpu.models import Transformer, lm_loss
    from horovod_tpu_torch.models import params_from_jax
    cfg, toks, params = _jax_phase2_setup()
    model = Transformer(cfg)
    opt = jhvd.DistributedOptimizer(optax.adam(1e-3),
                                    reduce_axes=("dp", "sp"))
    state = opt.init(params)
    pos = np.arange(16)[None].repeat(4, axis=0)

    def t_step(params, state, toks, pos):
        def loss_fn(p):
            logits = model.apply(p, toks, positions=pos)
            return lm_loss(logits[:, :-1], toks[:, 1:])
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        mean = jax.tree_util.tree_map(lambda g: g / 4, grads)
        return params, mean, jax.lax.pmean(jax.lax.pmean(loss, "sp"), "dp")

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    new, grads, loss = jax.jit(jax.shard_map(
        t_step, mesh=mesh,
        in_specs=(P(), P(), P("dp", "sp"), P("dp", "sp")),
        out_specs=(P(), P(), P())))(params, state, toks, pos)
    want = params_from_jax(jax.device_get(new))
    want_g = params_from_jax(jax.device_get(grads))
    for w in world:
        np.testing.assert_allclose(float(w["p2_loss"]), float(loss),
                                   rtol=2e-5)
        for k, v in want_g.items():
            np.testing.assert_allclose(w["p2g." + k], v.numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        for k, v in want.items():
            np.testing.assert_allclose(w["p2." + k], v.numpy(), rtol=2e-5,
                                       atol=1e-5, err_msg=k)
