"""Adasum in the port (``horovod_tpu_torch/ops/adasum.py``, the Adasum
paths of ``allreduce`` and the gradient layer) in a real 4-process gloo
world, against the JAX package on an emulated 4-rank world on the same
per-rank numpy data; and the combine itself without a world.

One world serves every check: a module fixture writes each rank's data
and the weights to a file and starts four workers
(``hvd.init(device="cpu", process_sets=[(0, 2)])``, then (1, 2, 3)
registered).  Over the world (4 ranks, a power of two) Adasum runs the
butterfly; over (0, 2) and (1, 2, 3), a strict subset, it gathers and
reduces a zero-padded tree.  Each op runs plain, with pre/postscale, on
bf16 input, under fp16 compression, and in its grouped, in-place and
async forms; ``adasum_delta_step(per_layer_stacked=...)`` gives a
stacked [L, D] leaf one coefficient pair per slice; and the example's
``TINY`` GPT-2 (f32, dense attention, from flax weights converted by
``params_from_jax``) takes 2 steps of ``adasum_delta_step(SGD(0.05))``
and 2 of ``DistributedOptimizer(SGD(0.05), op=Adasum)``.

Tolerances: the ops at rtol 1e-4 / atol 1e-6 (JAX's
``tests/test_adasum.py:73``); bf16 and fp16 results at one rounding step
of the wire type, relatively and of the largest input; parameters after training at rtol 1e-4 / atol 1e-5.
Every member holds the same bits, and a rank outside a set gets its
input back, unscaled.  Without a world, ``pair_combine`` and
``_tree_reduce_gathered`` match JAX's on fixed inputs, and the
``HVD_ADASUM_ACC_DTYPE=f64`` islands land near a float64 numpy model
where f32 islands cancel catastrophically.
"""

import numpy as np
import pytest

from test_torch_collectives import run_gloo_world
from test_torch_process_sets import _check, _same_bits

N = 4
A, B = (0, 2), (1, 2, 3)
WORLD = tuple(range(N))
SETS = {"w": WORLD, "A": A, "B": B}
L, D = 3, 8
ROWS, S = 2, 16           # TINY GPT-2: rows per rank, tokens per row
OPS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _rank_data(r):
    g = np.random.RandomState(700 + r)
    return {
        "x": g.randn(3, 5).astype(np.float32),
        "y": g.randn(7).astype(np.float32),
        # per-layer scales 1, 10, 100: joint and per-slice coefficients
        # differ
        "g_st": (g.randn(L, D) * np.array([1, 10, 100])[:, None])
        .astype(np.float32),
        "g_pl": g.randn(5).astype(np.float32),
    }


def _stack(key):
    return np.stack([_rank_data(r)[key] for r in range(N)])


def _tokens():
    return np.random.RandomState(0).randint(0, 512, (ROWS * N, S))


WORKER = '''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples.gpt2_adasum import TINY
from horovod_tpu_torch.models import Transformer, lm_loss
from horovod_tpu_torch.process_sets import ProcessSet

torch.set_num_threads(1)
out_path = sys.argv[1]
A, B = %(sets)r
hvd.init(device="cpu", process_sets=[ProcessSet(A)])
r = hvd.rank()
assert hvd.size() == 4
data = dict(np.load(DATA))
d = {k[:-1]: torch.from_numpy(v) for k, v in data.items()
     if k[-1] == str(r) and not k.startswith("w.")}
res = {}


def save(key, t):
    res[key] = t.detach().float().numpy().copy()


ps_b = hvd.add_process_set(list(B))
sets = {"w": hvd.global_process_set, "A": hvd.ProcessSet(list(A)),
        "B": ps_b}
x, y = d["x"], d["y"]
for s, ps in sets.items():
    x0 = x.clone()
    kw = dict(op=hvd.Adasum, process_set=ps)
    save(f"ada_{s}", hvd.allreduce(x, **kw))
    assert torch.equal(x, x0), "allreduce changed its input"
    save(f"ada_scaled_{s}", hvd.allreduce(x, prescale_factor=0.5,
                                          postscale_factor=3.0, **kw))
    out = hvd.allreduce(x.bfloat16(), **kw)
    assert out.dtype == torch.bfloat16
    save(f"ada_bf16_{s}", out)
    out = hvd.allreduce(x, compression=hvd.Compression.fp16, **kw)
    assert out.dtype == torch.float32
    save(f"ada_fp16_{s}", out)
    g0, g1 = hvd.grouped_allreduce([x, y], **kw)
    save(f"ada_grouped0_{s}", g0), save(f"ada_grouped1_{s}", g1)
    t = x.clone()
    assert hvd.allreduce_(t, **kw) is t
    save(f"ada_inplace_{s}", t)
    ts = [x.clone(), y.clone()]
    outs = hvd.grouped_allreduce_(ts, **kw)
    assert all(a is b for a, b in zip(outs, ts))
    save(f"ada_ginplace0_{s}", ts[0]), save(f"ada_ginplace1_{s}", ts[1])
    h = hvd.allreduce_async(x, **kw)
    hg = hvd.grouped_allreduce_async([x, y], **kw)
    assert hvd.poll(h)
    save(f"ada_async_{s}", hvd.synchronize(h))
    g0, g1 = hvd.synchronize(hg)
    save(f"ada_gasync0_{s}", g0), save(f"ada_gasync1_{s}", g1)
try:
    hvd.ops._fused_allreduce([x, x], op=hvd.Adasum)
    res["fused_refuses"] = np.array(0)
except ValueError as e:
    assert "coefficient pair per tensor" in str(e), e
    res["fused_refuses"] = np.array(1)

# adasum_delta_step with a stacked leaf: 2 steps of SGD-momentum.
for s in ("w", "B"):
    st = torch.nn.Parameter(torch.from_numpy(data["w.p_st"]).clone())
    pl = torch.nn.Parameter(torch.from_numpy(data["w.p_pl"]).clone())
    opt = torch.optim.SGD([st, pl], lr=0.1, momentum=0.9)
    for step in range(2):
        st.grad = d["g_st"] * (step + 1)
        pl.grad = d["g_pl"] * (step + 1)
        hvd.adasum_delta_step(opt, named_parameters=[("st", st), ("pl", pl)],
                              process_set=sets[s],
                              per_layer_stacked=lambda n: n == "st")
    save(f"delta_st_{s}", st), save(f"delta_pl_{s}", pl)
    save(f"delta_mom_{s}", opt.state[st]["momentum_buffer"])

# The example's TINY GPT-2, 2 steps each way.
toks = torch.from_numpy(data["w.tokens"][r * %(rows)d:(r + 1) * %(rows)d])
weights = {k[len("w.gpt."):]: torch.from_numpy(v) for k, v in data.items()
           if k.startswith("w.gpt.")}
for how in ("delta", "optimizer"):
    model = Transformer(TINY, device="cpu")
    model.load_state_dict(weights)
    sgd = torch.optim.SGD(model.parameters(), lr=0.05)
    opt = hvd.DistributedOptimizer(sgd, op=hvd.Adasum) \\
        if how == "optimizer" else sgd
    params = dict(model.named_parameters())

    def loss_fn(p):
        logits = torch.func.functional_call(model, p, (toks,))
        return lm_loss(logits[:, :-1], toks[:, 1:])

    for _ in range(2):
        if how == "delta":
            loss, grads = hvd.local_value_and_grad(loss_fn)(params)
            for name, p in params.items():
                p.grad = grads[name]
            hvd.adasum_delta_step(sgd)
        else:
            opt.zero_grad()
            loss_fn(params).backward()
            opt.step()
    for k, v in model.state_dict().items():
        save(f"gpt_{how}/{k}", v)
np.savez(out_path, **res)
hvd.shutdown()
''' % {"sets": (A, B), "rows": ROWS}


def _jax_tiny():
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jt
    return jt.Transformer(jt.TransformerConfig(
        vocab_size=512, num_layers=2, num_heads=8, d_model=128, d_ff=256,
        max_len=128, causal=True, dtype=jnp.float32, scan_layers=False))


def _gpt_params():
    import jax
    import jax.numpy as jnp
    tree = _jax_tiny().init(jax.random.PRNGKey(0),
                            jnp.zeros((1, S), jnp.int32))["params"]
    rng = np.random.RandomState(9)
    std = {"scale": 0.1, "bias": 0.05, "embedding": 0.1, "kernel": 0.1}

    def leaf(path, x):
        name = path[-1].key
        return np.asarray(std[name] * rng.randn(*x.shape) + (name == "scale"),
                          np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(tree))


def _start_params():
    g = np.random.RandomState(5)
    return {"st": g.randn(L, D).astype(np.float32),
            "pl": g.randn(5).astype(np.float32)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from horovod_tpu_torch.models import params_from_jax
    tmp = tmp_path_factory.mktemp("adasum")
    data = {f"{k}{r}": v for r in range(N) for k, v in _rank_data(r).items()}
    params = _gpt_params()
    for k, v in params_from_jax(params).items():
        data["w.gpt." + k] = v.numpy()
    start = _start_params()
    data["w.p_st"], data["w.p_pl"] = start["st"], start["pl"]
    data["w.tokens"] = _tokens()
    np.savez(tmp / "data.npz", **data)
    script = WORKER.replace("DATA", repr(str(tmp / "data.npz")))
    return params, run_gloo_world(script, tmp, size=N, timeout=300)


@pytest.fixture(scope="module")
def jax4():
    """The JAX package on an emulated 4-rank world with the worker's
    sets registered."""
    import os
    import horovod_tpu as hvd
    hvd.shutdown()
    old = os.environ.get("HVD_TPU_EMULATE_RANKS")
    os.environ["HVD_TPU_EMULATE_RANKS"] = str(N)
    try:
        hvd.init()
        assert hvd.size() == N
        sets = {"w": hvd.global_process_set,
                "A": hvd.add_process_set(list(A)),
                "B": hvd.add_process_set(list(B))}
        yield hvd, sets
    finally:
        hvd.shutdown()
        if old is None:
            os.environ.pop("HVD_TPU_EMULATE_RANKS", None)
        else:
            os.environ["HVD_TPU_EMULATE_RANKS"] = old


def _np_pair(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    dot, na, nb = (a * b).sum(), (a * a).sum(), (b * b).sum()
    return ((1 - dot / (2 * na) if na > 0 else 1.0) * a
            + (1 - dot / (2 * nb) if nb > 0 else 1.0) * b)


def _np_tree(ts):
    ts = [t.astype(np.float64) for t in ts]
    while len(ts) & (len(ts) - 1):
        ts.append(np.zeros_like(ts[0]))
    while len(ts) > 1:
        ts = [_np_pair(ts[i], ts[i + 1]) for i in range(0, len(ts), 2)]
    return ts[0]


@pytest.mark.parametrize("s", ["w", "A", "B"])
def test_allreduce_adasum_every_form_matches_jax(setup, jax4, s):
    """Butterfly over the world, gather + padded tree over (0, 2) and
    (1, 2, 3): plain, scaled, bf16, fp16-compressed, grouped (one
    coefficient pair per tensor), in-place and async."""
    import jax.numpy as jnp
    _, world = setup
    hvd, sets = jax4
    ps, members = sets[s], SETS[s]
    xs, ys = _stack("x"), _stack("y")
    x, y = jnp.asarray(xs), jnp.asarray(ys)
    kw = dict(op=hvd.Adasum, process_set=ps)
    want = np.asarray(hvd.allreduce(x, **kw))
    np.testing.assert_allclose(
        want[members[0]], _np_tree([xs[m] for m in members]), rtol=1e-4)
    for key in ("ada", "ada_inplace", "ada_async"):
        _check(world, f"{key}_{s}", want, members, xs, **OPS_TOL)
        _same_bits(world, f"{key}_{s}", members)
    _check(world, f"ada_scaled_{s}",
           hvd.allreduce(x, prescale_factor=0.5, postscale_factor=3.0, **kw),
           members, xs, **OPS_TOL)
    _same_bits(world, f"ada_scaled_{s}", members)
    bf = np.asarray(hvd.allreduce(x.astype(jnp.bfloat16), **kw)
                    .astype(jnp.float32))
    step = np.abs(xs).max()   # one rounding step of the wire type of it
    _check(world, f"ada_bf16_{s}", bf, members,
           np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32)),
           rtol=2**-7, atol=2**-8 * step)
    _same_bits(world, f"ada_bf16_{s}", members)
    _check(world, f"ada_fp16_{s}",
           hvd.allreduce(x, compression=hvd.Compression.fp16, **kw),
           members, np.asarray(x.astype(jnp.float16).astype(jnp.float32)),
           rtol=2**-10, atol=2**-11 * step)
    g0, g1 = hvd.grouped_allreduce([x, y], **kw)
    for key in ("ada_grouped", "ada_ginplace", "ada_gasync"):
        _check(world, f"{key}0_{s}", g0, members, xs, **OPS_TOL)
        _check(world, f"{key}1_{s}", g1, members, ys, **OPS_TOL)
        _same_bits(world, f"{key}1_{s}", members)
    # One coefficient pair per tensor: y's result is y's own Adasum.
    np.testing.assert_allclose(
        world[members[0]][f"ada_grouped1_{s}"],
        _np_tree([ys[m] for m in members]), rtol=1e-4, atol=1e-6)
    for r in range(N):
        assert int(world[r]["fused_refuses"]) == 1


@pytest.mark.parametrize("s", ["w", "B"])
def test_adasum_delta_step_per_layer_stacked_matches_jax(setup, jax4, s):
    """Two SGD-momentum steps of ``adasum_delta_step`` whose stacked
    [L, D] leaf takes one coefficient pair per slice, against JAX's in
    shard_map; the momentum is averaged over the set."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P
    _, world = setup
    hvd, sets = jax4
    opt = optax.sgd(0.1, momentum=0.9)

    def body(params, state, g_st, g_pl, k):
        grads = {"st": g_st[0] * k, "pl": g_pl[0] * k}
        p = jax.tree_util.tree_map(lambda a: a[0], params)
        st = jax.tree_util.tree_map(lambda a: a[0], state)
        p, st = hvd.adasum_delta_step(
            opt, p, grads, st, process_set=sets[s],
            per_layer_stacked=lambda path: path[0].key == "st")
        return jax.tree_util.tree_map(lambda a: a[None], (p, st))

    step = jax.jit(jax.shard_map(
        body, mesh=hvd.mesh(), in_specs=(P("hvd"),) * 4 + (P(),),
        out_specs=P("hvd"), check_vma=False))
    start = _start_params()
    params = {k: jnp.stack([jnp.asarray(v)] * N) for k, v in start.items()}
    state = jax.tree_util.tree_map(lambda a: jnp.stack([a] * N),
                                   opt.init(jax.tree_util.tree_map(
                                       jnp.asarray, start)))
    for k in (1.0, 2.0):
        params, state = step(params, state, jnp.asarray(_stack("g_st")),
                             jnp.asarray(_stack("g_pl")), jnp.float32(k))
    members = SETS[s]
    for name in ("st", "pl"):
        _check(world, f"delta_{name}_{s}", np.asarray(params[name]),
               WORLD, **PARAM_TOL)
        _same_bits(world, f"delta_{name}_{s}", members)
    _check(world, f"delta_mom_{s}", np.asarray(state[0].trace["st"]),
           WORLD, **PARAM_TOL)
    # Per-slice differs from one joint pair over the whole stack.
    joint = _np_tree([_stack("g_st")[m] for m in members])
    per_slice = np.stack([_np_tree([_stack("g_st")[m][i] for m in members])
                          for i in range(L)])
    assert not np.allclose(joint, per_slice, rtol=1e-3)


def _jax_gpt_train(hvd, params, how):
    import jax
    import optax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.models import transformer as jt
    model = _jax_tiny()
    opt = optax.sgd(0.05)
    if how == "optimizer":
        opt = hvd.DistributedOptimizer(opt, op=hvd.Adasum)

    def local_step(p, s, toks):
        def loss_fn(q):
            logits = model.apply({"params": q}, toks)
            return jt.lm_loss(logits[:, :-1], toks[:, 1:])

        _, grads = hvd.local_value_and_grad(loss_fn)(p)
        if how == "delta":
            out = hvd.adasum_delta_step(opt, p, grads, s)
        else:
            updates, s = opt.update(grads, s, p)
            out = optax.apply_updates(p, updates), s
        return jax.tree_util.tree_map(lambda a: a[None], out)

    # The Adasum results are equal on every rank but typed varying: out
    # per rank, then rank 0's.
    step = hvd.parallel.shard_step(
        local_step, in_specs=(P(), P(), P("hvd")), out_specs=P("hvd"))
    state = opt.init(params)
    toks = _tokens()
    for _ in range(2):
        params, state = jax.tree_util.tree_map(
            lambda a: a[0], step(params, state, toks))
    return jax.device_get(params)


@pytest.mark.parametrize("how", ["delta", "optimizer"])
def test_tiny_gpt2_adasum_training_matches_jax(setup, jax4, how):
    """2 steps of ``adasum_delta_step(SGD(0.05))`` (local gradients from
    ``local_value_and_grad``) or of ``DistributedOptimizer(SGD(0.05),
    op=Adasum)`` on the example's TINY GPT-2, against JAX's example
    step on the same weights and rows."""
    from horovod_tpu_torch.models import params_from_jax
    params, world = setup
    hvd, _ = jax4
    want = params_from_jax(_jax_gpt_train(hvd, params, how))
    init = params_from_jax(params)
    moved = 0
    for key, w in want.items():
        got = world[0][f"gpt_{how}/{key}"]
        np.testing.assert_allclose(got, w.numpy(), err_msg=key, **PARAM_TOL)
        _same_bits(world, f"gpt_{how}/{key}", WORLD)
        moved += int(not np.array_equal(got, init[key].numpy()))
    assert moved == len(want)


# -- the combine without a world ---------------------------------------------

def test_pair_combine_and_tree_match_jax():
    import jax.numpy as jnp
    import torch
    from horovod_tpu.ops import adasum as ja
    from horovod_tpu_torch.ops import adasum as ta
    rng = np.random.RandomState(13)
    a, b = rng.randn(2, L, D).astype(np.float32)
    b[1] = 0.0                                       # a zero slice of b
    for per_slice in (False, True):
        want = np.asarray(ja.pair_combine(jnp.asarray(a), jnp.asarray(b),
                                          per_slice))
        got = ta.pair_combine(torch.from_numpy(a), torch.from_numpy(b),
                              per_slice)
        np.testing.assert_allclose(got.numpy(), want, **OPS_TOL)
        stack = rng.randn(3, L, D).astype(np.float32)   # padded to 4
        want = np.asarray(ja._tree_reduce_gathered(jnp.asarray(stack),
                                                   per_slice))
        got = ta._tree_reduce_gathered(torch.from_numpy(stack), per_slice)
        np.testing.assert_allclose(got.numpy(), want, **OPS_TOL)
    # bf16 input, f32 islands, the result rounded to bf16 once.
    want = np.asarray(ja.pair_combine(jnp.asarray(a, jnp.bfloat16),
                                      jnp.asarray(b, jnp.bfloat16))
                      .astype(jnp.float32))
    got = ta.pair_combine(torch.from_numpy(a).bfloat16(),
                          torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                               atol=1e-6)
    # Parallel tensors average, orthogonal ones sum, a zero one is identity.
    t = torch.from_numpy(a)
    torch.testing.assert_close(ta.pair_combine(t, t), t)
    e0, e1 = torch.eye(2)
    torch.testing.assert_close(ta.pair_combine(3 * e0, 4 * e1),
                               torch.tensor([3.0, 4.0]))
    torch.testing.assert_close(ta.pair_combine(torch.zeros(2), e1), e1)


def test_acc_dtype_knob_f64_beats_f32_on_bf16_islands(monkeypatch):
    """On bf16-quantized, near-parallel, mixed-magnitude inputs (carried
    in float64 so the output cast keeps the islands' error), float64
    islands land within 1e-9 of a float64 numpy model, 100 times closer
    than float32 islands (JAX's test of the knob)."""
    import torch
    from horovod_tpu_torch.ops import adasum as ta
    n = 1 << 15
    rng = np.random.RandomState(11)
    scale = np.where(np.arange(n) % 2, 1e3, 1e-3)
    a = torch.from_numpy(rng.randn(n) * scale).bfloat16().double()
    b = (a * 1.0003 + torch.from_numpy(rng.randn(n) * scale * 1e-4)) \
        .bfloat16().double()
    expected = _np_pair(a.numpy(), b.numpy())
    monkeypatch.setenv("HVD_ADASUM_ACC_DTYPE", "f32")
    assert ta._acc_dtype() == torch.float32
    err32 = np.linalg.norm(ta.pair_combine(a, b).numpy() - expected)
    monkeypatch.setenv("HVD_ADASUM_ACC_DTYPE", "float64")
    assert ta._acc_dtype() == torch.float64
    err64 = np.linalg.norm(ta.pair_combine(a, b).numpy() - expected)
    assert err32 > 0
    assert err64 < err32 * 1e-2, (err32, err64)
    assert err64 < 1e-9 * np.linalg.norm(expected), err64


def test_acc_dtype_knob_refuses_other_values(monkeypatch):
    import torch
    from horovod_tpu_torch.ops import adasum as ta
    monkeypatch.setenv("HVD_ADASUM_ACC_DTYPE", "f16")
    with pytest.raises(ValueError, match="HVD_ADASUM_ACC_DTYPE"):
        ta.pair_combine(torch.ones(2), torch.ones(2))
    monkeypatch.delenv("HVD_ADASUM_ACC_DTYPE")
    assert ta._acc_dtype() == torch.float32


def test_adasum_bench_model_matches_jax_tree():
    """``examples/adasum_bench.py``'s float64 model of the tree (what the
    multi-card run holds both exchange paths to) agrees with JAX's tree
    over a stack of 3, zero-padded to 4, on correlated rows."""
    import jax.numpy as jnp
    import torch
    from horovod_tpu.ops import adasum as ja
    from horovod_tpu_torch.examples.adasum_bench import float64_tree
    rng = np.random.RandomState(17)
    stack = rng.randn(3, L, D).astype(np.float32)
    stack[1] = 0.8 * stack[0] + 0.6 * stack[1]
    want = np.asarray(ja._tree_reduce_gathered(jnp.asarray(stack)))
    got = float64_tree(torch.from_numpy(stack))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **OPS_TOL)
