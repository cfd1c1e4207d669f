"""Model parallelism of the port in a real 4-process gloo world, against
the JAX package on 4 of the conftest's 8 emulated CPU devices, on the
same numpy data.

One world serves every check: a module fixture writes the data and the
JAX models' converted weights to a file and starts four workers
(``hvd.init(device="cpu")``); each runs ``expert_parallel_ffn`` sharded
over the world (output and gradients), the TINY MoE transformer with
its experts sharded (and with ``remat``), ``gpipe_spmd`` over 4 stages
(forward, gradients, and M < S, where stage 0's wrap-around hop must
still run its backward), ``column_row_parallel_mlp`` over 4 shards
(forward, weight and input gradients), ``shard_step`` with 1-D and
2-D specs, and phases 3-5 of ``dryrun_multichip``
(``entry.dryrun_{moe,pp,tp}_step``), and saves what it got.  The JAX
side runs ``shard_map`` over the same layouts.

Tolerances are the JAX tests': MoE 1e-4 / 1e-5 (``tests/test_moe.py``),
the MoE transformer 2e-3 (``:153``), the pipeline 1e-5 / 1e-6 forward
and 1e-4 / 1e-6 gradients, tensor parallelism 1e-4 / 1e-5
(``tests/test_pipeline.py``).
"""

import numpy as np
import pytest

from test_torch_collectives import run_gloo_world

N = 4
TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_len=16, causal=True)
PIPE = {"fwd": (5, 3, 6), "grad": (4, 2, 5), "short": (2, 2, 5)}  # M, mb, d


def _data():
    g = np.random.RandomState(0)
    mk = lambda *s, sc=1.0: (g.randn(*s) * sc).astype(np.float32)  # noqa
    d = {"moe_x": mk(64, 8), "moe_gate": mk(8, 8, sc=2.0),
         "moe_w_in": mk(8, 8, 16, sc=0.1), "moe_w_out": mk(8, 16, 8, sc=0.1),
         "moe_w": mk(64, 8),
         "tiny_tokens": np.random.RandomState(1).randint(0, 64, (8, 16)),
         "tiny_w": mk(8, 16, 64),
         "tp_x": mk(4, 6), "tp_w1": mk(6, 32, sc=0.3),
         "tp_w2": mk(32, 6, sc=0.3),
         "tpg_x": mk(3, 4), "tpg_w1": mk(4, 16, sc=0.3),
         "tpg_w2": mk(16, 4, sc=0.3),
         "ss_w": mk(3), "ss_x": mk(8, 3), "ss_y": mk(4, 3)}
    for name, (M, mb, dd) in PIPE.items():
        d[f"pp_{name}_ws"] = mk(N, dd, dd, sc=0.5)
        d[f"pp_{name}_xs"] = mk(M, mb, dd)
        d[f"pp_{name}_tgt"] = mk(M, mb, dd)
    return d


WORKER = '''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import entry, parallel
from horovod_tpu_torch.models import shard_experts
from horovod_tpu_torch.models.transformer import Transformer, \\
    TransformerConfig
from horovod_tpu_torch.parallel import P, moe, pipeline, tensor

torch.set_num_threads(1)
out_path = sys.argv[1]
N, TINY, PIPE = %(consts)r
hvd.init(device="cpu")
r = hvd.rank()
assert hvd.size() == N
data = dict(np.load(DATA))
res = {}


def save(key, t):
    res[key] = t.detach().float().numpy().copy() \\
        if isinstance(t, torch.Tensor) else np.asarray(t)


def T(key):
    return torch.from_numpy(data[key])


# expert_parallel_ffn over the world: 16 tokens and 2 experts a rank.
x = T("moe_x")[16 * r:16 * r + 16].clone().requires_grad_()
gate = T("moe_gate").clone().requires_grad_()
w_in = T("moe_w_in")[2 * r:2 * r + 2].clone().requires_grad_()
w_out = T("moe_w_out")[2 * r:2 * r + 2].clone().requires_grad_()
out = moe.expert_parallel_ffn(x, gate, w_in, w_out, axis_name="hvd",
                              top_k=2, capacity_factor=16.0)
(torch.sum(out.out * T("moe_w")[16 * r:16 * r + 16])
 + out.aux_loss).backward()
save("moe_out", out.out)
save("moe_aux", out.aux_loss)
save("moe_dropped", out.dropped_frac)
for k, t in (("x", x), ("gate", gate), ("w_in", w_in), ("w_out", w_out)):
    save(f"moe_g_{k}", t.grad)

# The TINY MoE transformer, experts sharded over the world.
state = {k[2:]: torch.from_numpy(v) for k, v in data.items()
         if k.startswith("w.")}
toks = T("tiny_tokens")[2 * r:2 * r + 2]
for remat in (False, True):
    model = Transformer(TransformerConfig(
        **TINY, dtype=torch.float32, moe_experts=8,
        moe_capacity_factor=16.0, expert_axis="hvd", remat=remat),
        device="cpu")
    model.load_state_dict(shard_experts(state, "hvd"))
    assert tuple(model.blocks[1].moe_w_in.shape) == (2, 32, 64)
    assert parallel.sharded_axes(model.blocks[1].moe_w_in) == ("hvd",)
    logits = model(toks)
    (logits * T("tiny_w")[2 * r:2 * r + 2]).sum().backward()
    save(f"tiny_logits_{int(remat)}", logits)
    # The replicated model on this rank's rows: the same products.
    full = Transformer(TransformerConfig(
        **TINY, dtype=torch.float32, moe_experts=8,
        moe_capacity_factor=16.0, remat=remat), device="cpu")
    full.load_state_dict(state)
    with torch.no_grad():
        save(f"tiny_replicated_{int(remat)}", full(toks))
    save(f"tiny_aux_count_{int(remat)}", len(model.aux_losses))
    for k, p in model.named_parameters():
        save(f"tiny_g{int(remat)}.{k}", p.grad)

# gpipe_spmd over 4 stages; M < S in "short".
parallel.make_mesh({"pp": N})
for name, (M, mb, d) in PIPE.items():
    w = T(f"pp_{name}_ws")[r:r + 1].clone().requires_grad_()
    xs = T(f"pp_{name}_xs").clone().requires_grad_()
    pipeline.HOPS.update(forward=0, backward=0)
    ys = pipeline.gpipe_spmd(lambda p, v: torch.tanh(v @ p[0]), w, xs,
                             axis_name="pp")
    torch.mean((ys - T(f"pp_{name}_tgt")) ** 2).backward()
    save(f"pp_{name}_ys", ys)
    save(f"pp_{name}_gw", w.grad)
    save(f"pp_{name}_gx", xs.grad)
    save(f"pp_{name}_hops", [pipeline.HOPS["forward"],
                             pipeline.HOPS["backward"]])
with torch.no_grad():
    ys = pipeline.gpipe_spmd(lambda p, v: torch.tanh(v @ p[0]),
                             T("pp_fwd_ws")[r:r + 1], T("pp_fwd_xs"),
                             axis_name="pp")
save("pp_nograd_ys", ys)

# column_row_parallel_mlp over 4 shards.
parallel.make_mesh({"tp": N})
c = tensor.shard_columns(T("tp_w1"), N)[r]
rw = tensor.shard_rows(T("tp_w2"), N)[r]
save("tp_y", tensor.column_row_parallel_mlp(T("tp_x"), c, rw))
x = T("tpg_x").clone().requires_grad_()
c = tensor.shard_columns(T("tpg_w1"), N)[r].clone().requires_grad_()
rw = tensor.shard_rows(T("tpg_w2"), N)[r].clone().requires_grad_()
tensor.column_row_parallel_mlp(x, c, rw).sum().backward()
save("tp_gc", c.grad)
save("tp_gr", rw.grad)
save("tp_gx", x.grad)

# shard_step: the world's axis, then a 2-D mesh with a tuple axis.
step = parallel.shard_step(
    lambda w, x: (w + hvd.allreduce(x.sum(0), op=hvd.Sum), x * 2.0),
    out_specs=(P(), P("hvd")))
a, b = step(T("ss_w"), T("ss_x"))
save("ss1_a", a)
save("ss1_b", b)
mesh2 = parallel.make_mesh({"dp": 2, "ep": 2})
step = parallel.shard_step(
    lambda w, x, y: (w * 1.0, x + float(r), y * 2.0), mesh=mesh2,
    in_specs=(P(), P(("dp", "ep")), P("dp")),
    out_specs=(P(), P(("dp", "ep")), P("dp")))
a, b, cc = step(T("ss_w"), T("ss_x"), T("ss_y"))
save("ss2_b", b)
save("ss2_c", cc)
save("ss2_dp_rows", parallel.data_parallel_sharding(
    mesh2, "dp").shard(T("ss_x")))

# shard_experts on the dp x ep mesh: this rank's experts by its ep index.
for k, v in shard_experts(state, "ep").items():
    save("se." + k, v)
try:
    shard_experts({"moe_w_in": torch.zeros(3, 2)}, "ep")
    save("se_indivisible_raised", 0)
except ValueError as e:
    save("se_indivisible_raised", int("do not divide" in str(e)))

# Phases 3-5 of dryrun_multichip.
state3 = {k[3:]: torch.from_numpy(v) for k, v in data.items()
          if k.startswith("w3.")}
loss, model = entry.dryrun_moe_step(device="cpu", state_dict=state3)
save("p3_loss", loss)
for k, v in model.state_dict().items():
    save("p3." + k, v)
for k, v in model.named_parameters():
    save("p3g." + k, v.grad)
loss, w = entry.dryrun_pp_step(device="cpu")
save("p4_loss", loss)
save("p4_w", w)
loss, tp = entry.dryrun_tp_step(device="cpu")
save("p5_loss", loss)
save("p5_c", tp["c"])
save("p5_r", tp["r"])
np.savez(out_path, **res)
hvd.shutdown()
'''


def _jax_tiny():
    import jax
    from horovod_tpu.models import Transformer, TransformerConfig
    import jax.numpy as jnp
    cfg = TransformerConfig(**TINY, dtype=jnp.float32, moe_experts=8,
                            moe_capacity_factor=16.0, scan_layers=False)
    params = Transformer(cfg).init(jax.random.PRNGKey(0),
                                   _data()["tiny_tokens"])
    return cfg, {"params": params["params"]}


def _jax_phase3():
    import dataclasses
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import Transformer, TransformerConfig
    dp = ep = 2
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=4,
                            d_model=64, d_ff=128, max_len=16, causal=True,
                            dtype=jnp.float32, moe_experts=2 * ep,
                            moe_capacity_factor=4.0, expert_axis="ep")
    toks = np.random.RandomState(3).randint(0, 128, (2 * dp * ep, 16))
    params = Transformer(dataclasses.replace(cfg, expert_axis=None)).init(
        jax.random.PRNGKey(2), toks[:1])
    # Not init's sown "losses" (the reference's quirk, ROADMAP Queue C).
    return cfg, toks, {"params": params["params"]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from horovod_tpu_torch.models import params_from_jax
    tmp = tmp_path_factory.mktemp("modelpar")
    data = _data()
    for k, v in params_from_jax(_jax_tiny()[1]).items():
        data["w." + k] = v.numpy()
    for k, v in params_from_jax(_jax_phase3()[2]).items():
        data["w3." + k] = v.numpy()
    np.savez(tmp / "data.npz", **data)
    script = WORKER % {"consts": (N, TINY, PIPE)}
    script = script.replace("DATA", repr(str(tmp / "data.npz")))
    return run_gloo_world(script, tmp, size=N, timeout=300)


def _mesh(*names):
    import jax
    from jax.sharding import Mesh
    shape = (N,) if len(names) == 1 else (2, 2)
    return Mesh(np.asarray(jax.devices()[:N]).reshape(shape), names)


def _cat(world, key):
    return np.concatenate([w[key] for w in world])


def test_expert_parallel_ffn_sharded_matches_jax(world):
    """8 experts, 2 a rank, 16 tokens a rank, capacity to spare: each
    rank's output against JAX's sharded ffn and the unsharded one
    (``tests/test_moe.py:76``); the gradients of sum(out · w) + aux:
    x and the expert shards per rank, the replicated gate's summed over
    the ranks (JAX sums an invariant input's cotangent)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel.moe import expert_parallel_ffn
    d = _data()
    args = [d[k] for k in ("moe_x", "moe_gate", "moe_w_in", "moe_w_out")]
    ref = expert_parallel_ffn(*args, axis_name=None, top_k=2,
                              capacity_factor=16.0)

    def local(x, gate, wi, wo, w):
        def loss(x, gate, wi, wo):
            r = expert_parallel_ffn(x, gate, wi, wo, axis_name="hvd",
                                    top_k=2, capacity_factor=16.0)
            return jnp.sum(r.out * w) + r.aux_loss, r
        (_, r), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(x, gate, wi, wo)
        return r.out, r.aux_loss[None], g[0], g[1], g[2], g[3]

    spec = P("hvd")
    out, aux, gx, ggate, gwi, gwo = jax.jit(jax.shard_map(
        local, mesh=_mesh("hvd"), in_specs=(spec, P(), spec, spec, spec),
        out_specs=(spec, spec, spec, P(), spec, spec)))(*args, d["moe_w"])
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_cat(world, "moe_out"), np.asarray(out), **tol)
    np.testing.assert_allclose(_cat(world, "moe_out"), np.asarray(ref.out),
                               **tol)
    np.testing.assert_allclose(np.stack([w["moe_aux"] for w in world]),
                               np.asarray(aux), **tol)
    assert all(float(w["moe_dropped"]) == 0.0 for w in world)
    np.testing.assert_allclose(_cat(world, "moe_g_x"), np.asarray(gx), **tol)
    np.testing.assert_allclose(_cat(world, "moe_g_w_in"), np.asarray(gwi),
                               **tol)
    np.testing.assert_allclose(_cat(world, "moe_g_w_out"), np.asarray(gwo),
                               **tol)
    np.testing.assert_allclose(sum(w["moe_g_gate"] for w in world),
                               np.asarray(ggate), **tol)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_transformer_expert_sharded_matches_jax(world, remat):
    """TINY with 8 experts sharded 2 a rank (``shard_experts``): each
    rank's logits against the replicated JAX model on the same rows
    (``tests/test_moe.py:153``, 2e-3) and, bit for bit, against the
    port's replicated model, one aux loss per MoE block (remat
    recomputes the block and both alltoalls without a second entry), and
    the gradients of sum(logits · w) against JAX's expert-sharded model
    under shard_map: the dense ones summed over the ranks, the experts'
    per rank."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.models import Transformer
    from horovod_tpu_torch.models import params_from_jax
    cfg, params = _jax_tiny()
    d = _data()
    toks = d["tiny_tokens"]
    want = np.asarray(Transformer(cfg).apply(params, toks))
    np.testing.assert_allclose(_cat(world, f"tiny_logits_{int(remat)}"),
                               want, rtol=2e-3, atol=2e-3)
    assert all(int(w[f"tiny_aux_count_{int(remat)}"]) == 1 for w in world)
    # Each member's block of rows is its own expert product, as in the
    # replicated model: the logits agree bit for bit.
    for w in world:
        np.testing.assert_array_equal(w[f"tiny_logits_{int(remat)}"],
                                      w[f"tiny_replicated_{int(remat)}"])
    model = Transformer(dataclasses.replace(cfg, expert_axis="hvd",
                                            remat=remat))

    def spec(path, _):
        return P("hvd") if path[-1].key in ("moe_w_in", "moe_w_out") \
            else P()

    specs = jax.tree_util.tree_map_with_path(spec, params)

    def grads(p, t, w):
        # A replicated weight's gradient comes back summed over the
        # shards (the transpose of its cast to varying).
        return jax.grad(lambda p: jnp.sum(model.apply(p, t) * w))(p)

    g = jax.jit(jax.shard_map(
        grads, mesh=_mesh("hvd"), in_specs=(specs, P("hvd"), P("hvd")),
        out_specs=specs))(params, toks, d["tiny_w"])
    for k, v in params_from_jax(jax.device_get(g)).items():
        got = _cat(world, f"tiny_g{int(remat)}.{k}") \
            if k.endswith(("moe_w_in", "moe_w_out")) \
            else sum(w[f"tiny_g{int(remat)}.{k}"] for w in world)
        np.testing.assert_allclose(got, v.numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_pipes():
    """JAX's gpipe_spmd over 4 stages for each case: the outputs, and
    the gradients of mean((ys - tgt)²) with respect to the stacked
    stages and xs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel.pipeline import gpipe_spmd
    d = _data()
    out = {}
    for name in PIPE:
        def body(ws, xs, tgt):
            def loss(ws, xs):
                ys = gpipe_spmd(lambda p, x: jnp.tanh(x @ p[0]), ws, xs,
                                axis_name="pp")
                return jnp.mean((ys - tgt) ** 2), ys
            (_, ys), (gw, gx) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(ws, xs)
            return ys, gw, gx
        out[name] = [np.asarray(t) for t in jax.jit(jax.shard_map(
            body, mesh=_mesh("pp"), in_specs=(P("pp"), P(), P()),
            out_specs=(P(), P("pp"), P())))(
                d[f"pp_{name}_ws"], d[f"pp_{name}_xs"], d[f"pp_{name}_tgt"])]
    return out


def _sequential(ws, xs):
    y = xs
    for w in ws:
        y = np.tanh(y @ w)
    return y


@pytest.mark.parametrize("name", list(PIPE))
def test_gpipe_matches_jax(world, jax_pipes, name):
    """The pipeline's outputs on every rank (``tests/test_pipeline.py:44``:
    1e-5 / 1e-6, also against the stages run in sequence), each rank's
    stage gradient (``:64``: 1e-4 / 1e-6) and xs's gradient, summed over
    the stages, against JAX's; "short" has M = 2 < S = 4 microbatches.
    Every rank posts every hop and every inverse hop: M + S - 2 each."""
    ys, gw, gx = jax_pipes[name]
    d = _data()
    M = PIPE[name][0]
    for w in world:
        np.testing.assert_allclose(w[f"pp_{name}_ys"], ys, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(
            w[f"pp_{name}_ys"], _sequential(d[f"pp_{name}_ws"],
                                            d[f"pp_{name}_xs"]),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(w[f"pp_{name}_gx"], gx, rtol=1e-4,
                                   atol=1e-6)
        assert list(w[f"pp_{name}_hops"]) == [M + N - 2] * 2
    np.testing.assert_allclose(_cat(world, f"pp_{name}_gw"), gw, rtol=1e-4,
                               atol=1e-6)


def test_gpipe_without_grad(world, jax_pipes):
    for w in world:
        np.testing.assert_allclose(w["pp_nograd_ys"], jax_pipes["fwd"][0],
                                   rtol=1e-5, atol=1e-6)


def test_column_row_parallel_mlp_matches_jax(world):
    """The forward (``tests/test_pipeline.py:100``) and the gradients of
    sum(y) (``:122``) with respect to each rank's column and row shards
    and to the replicated x, whose gradient is whole on every rank,
    against JAX's shard_map and the dense MLP; 1e-4 / 1e-5."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel.tensor import (column_row_parallel_mlp,
                                             shard_columns, shard_rows)
    d = _data()
    tol = dict(rtol=1e-4, atol=1e-5)
    dense = jax.nn.gelu(d["tp_x"] @ d["tp_w1"]) @ d["tp_w2"]
    for w in world:
        np.testing.assert_allclose(w["tp_y"], np.asarray(dense), **tol)

    def body(x, c, r):
        return jax.grad(lambda x, c, r: jnp.sum(column_row_parallel_mlp(
            x, c[0], r[0], axis_name="tp")), argnums=(0, 1, 2))(x, c, r)

    gx, gc, gr = jax.jit(jax.shard_map(
        body, mesh=_mesh("tp"), in_specs=(P(), P("tp"), P("tp")),
        out_specs=(P(), P("tp"), P("tp"))))(
            d["tpg_x"], jnp.stack(shard_columns(d["tpg_w1"], N)),
            jnp.stack(shard_rows(d["tpg_w2"], N)))
    np.testing.assert_allclose(np.stack([w["tp_gc"] for w in world]),
                               np.asarray(gc), **tol)
    np.testing.assert_allclose(np.stack([w["tp_gr"] for w in world]),
                               np.asarray(gr), **tol)
    gw1, gw2, gxd = jax.grad(lambda w1, w2, x: jnp.sum(
        jax.nn.gelu(x @ w1) @ w2), argnums=(0, 1, 2))(
            d["tpg_w1"], d["tpg_w2"], d["tpg_x"])
    np.testing.assert_allclose(
        np.concatenate([w["tp_gc"] for w in world], axis=1),
        np.asarray(gw1), **tol)
    for w in world:
        np.testing.assert_allclose(w["tp_gx"], np.asarray(gx), **tol)
        np.testing.assert_allclose(w["tp_gx"], np.asarray(gxd), **tol)


def test_shard_step_matches_jax(world):
    """``shard_step`` with its default in_specs (the first argument
    whole, the rest split over the world's axis) and out_specs P() /
    P("hvd"), then on a dp × ep mesh with a tuple axis P(("dp", "ep"))
    (row-major) and P("dp"), against JAX's ``shard_step`` on the same
    layouts; every rank holds the gathered outputs."""
    import jax
    from jax.sharding import PartitionSpec as P
    import horovod_tpu as jhvd
    d = _data()
    step = jhvd.parallel.shard_step(
        lambda w, x: (w + jax.lax.psum(x.sum(0), "hvd"), x * 2.0),
        mesh=_mesh("hvd"), axis_name="hvd", out_specs=(P(), P("hvd")))
    a, b = step(d["ss_w"], d["ss_x"])
    mesh2 = _mesh("dp", "ep")
    step2 = jhvd.parallel.shard_step(
        lambda w, x, y: (w * 1.0, x + (jax.lax.axis_index("dp") * 2
                                       + jax.lax.axis_index("ep")), y * 2.0),
        mesh=mesh2, in_specs=(P(), P(("dp", "ep")), P("dp")),
        out_specs=(P(), P(("dp", "ep")), P("dp")))
    _, b2, c2 = step2(d["ss_w"], d["ss_x"], d["ss_y"])
    for r, w in enumerate(world):
        np.testing.assert_allclose(w["ss1_a"], np.asarray(a), rtol=1e-6)
        np.testing.assert_array_equal(w["ss1_b"], np.asarray(b))
        np.testing.assert_array_equal(w["ss2_b"], np.asarray(b2))
        np.testing.assert_array_equal(w["ss2_c"], np.asarray(c2))
        i = r // 2
        np.testing.assert_array_equal(w["ss2_dp_rows"],
                                      d["ss_x"][4 * i:4 * i + 4])


def test_shard_experts_slices_expert_leaves(world):
    """On the {"dp": 2, "ep": 2} mesh each rank gets experts [4j, 4j + 4)
    of the global [8, ...] weights by its ep index j = rank % 2, whatever
    its dp row; other entries pass through untouched; 3 experts over
    ep = 2 raise."""
    from horovod_tpu_torch.models import params_from_jax
    d = {k: v.numpy() for k, v in params_from_jax(_jax_tiny()[1]).items()}
    assert any(k.endswith(("moe_w_in", "moe_w_out")) for k in d)
    for r, w in enumerate(world):
        j = r % 2
        assert {k[3:] for k in w if k.startswith("se.")} == set(d)
        for k, v in d.items():
            want = v[4 * j:4 * j + 4] if k.endswith(
                ("moe_w_in", "moe_w_out")) else v
            np.testing.assert_array_equal(w["se." + k], want, err_msg=k)
        assert int(w["se_indivisible_raised"]) == 1


def test_dryrun_moe_step_matches_jax_phase3(world):
    """Phase 3 of ``dryrun_multichip`` from JAX's initial weights: the
    loss, every reduced gradient and every parameter after one Adam step
    against JAX's ``moe_step`` on the dp=2 × ep=2 mesh.  The reduced
    gradients are JAX's per-shard gradients summed over dp × ep for the
    dense weights and over dp alone for the experts, both divided by
    dp·ep = 4: ``DistributedOptimizer(reduce_axes=("dp", "ep"))``'s
    rule.  Parameters at atol lr/100, as phase 2's test, except where
    the gradient is below 1e-6: Adam's first step moves an element by
    lr · g/(|g| + 1e-8), which there turns g's f32 rounding into a
    visible part of lr, so those are held to lr."""
    import jax
    import optax
    from jax.sharding import PartitionSpec as P
    import horovod_tpu as jhvd
    from horovod_tpu.models import Transformer, lm_loss
    from horovod_tpu_torch.models import params_from_jax
    cfg, toks, params = _jax_phase3()
    model = Transformer(cfg)
    opt = jhvd.DistributedOptimizer(optax.adam(1e-3),
                                    reduce_axes=("dp", "ep"))
    state = opt.init(params)
    experts = ("moe_w_in", "moe_w_out")

    def spec(path, _):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        return P("ep") if name in experts else P()

    def step(params, state, toks):
        def loss_fn(p):
            logits, mut = model.apply(p, toks, mutable=["losses"])
            aux = sum(jax.tree.leaves(mut["losses"]))
            return lm_loss(logits[:, :-1], toks[:, 1:]) + 0.01 * aux
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state, params)
        # The transpose of each weight's cast to varying has summed its
        # gradient over the axes it is replicated on: the dense ones over
        # dp × ep, the experts (split over ep) over dp alone.
        reduced = jax.tree_util.tree_map(lambda g: g / 4, grads)
        return (optax.apply_updates(params, updates), reduced,
                jax.lax.pmean(jax.lax.pmean(loss, "ep"), "dp"))

    pspec = jax.tree_util.tree_map_with_path(spec, params)
    new, grads, loss = jax.jit(jax.shard_map(
        step, mesh=_mesh("dp", "ep"),
        in_specs=(pspec, jax.tree_util.tree_map_with_path(spec, state),
                  P(("dp", "ep"))),
        out_specs=(pspec, pspec, P())))(params, state, toks)
    want = params_from_jax(jax.device_get(new))
    want_g = params_from_jax(jax.device_get(grads))
    for r, w in enumerate(world):
        j = r % 2
        np.testing.assert_allclose(float(w["p3_loss"]), float(loss),
                                   rtol=2e-5)
        for k, v in want_g.items():
            v = v.numpy()
            if k.endswith(experts):
                v = v[2 * j:2 * j + 2]
            np.testing.assert_allclose(w["p3g." + k], v, rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        for k, v in want.items():
            v, g = v.numpy(), want_g[k].numpy()
            if k.endswith(experts):
                v, g = v[2 * j:2 * j + 2], g[2 * j:2 * j + 2]
            # Where |g| is within 100 eps of Adam's eps (1e-8), an f32
            # rounding of g moves g/(|g| + eps), so the step, by a visible
            # part of lr: those elements are held to lr itself.
            tiny = np.abs(g) < 1e-6
            np.testing.assert_allclose(w["p3." + k][~tiny], v[~tiny],
                                       rtol=2e-5, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(w["p3." + k][tiny], v[tiny],
                                       atol=1e-3, err_msg=k)


def test_dryrun_pp_and_tp_steps_match_jax_phases_4_5(world):
    """Phases 4 and 5 of ``dryrun_multichip`` (dp=2 × pp=2 GPipe, dp=2 ×
    tp=2 Megatron MLP, SGD(0.05) through ``reduce_axes=("dp",)``): the
    loss and each rank's shard after the step against JAX's."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P
    import horovod_tpu as jhvd
    from horovod_tpu.parallel.pipeline import gpipe_spmd, stack_stage_params
    from horovod_tpu.parallel.tensor import (column_row_parallel_mlp,
                                             shard_columns, shard_rows)
    dp = pp = tp = 2
    d, M, mb = 8, 4, 2
    rng = np.random.RandomState(4)
    stages = stack_stage_params([jnp.asarray(rng.randn(d, d) * 0.3,
                                             jnp.float32) for _ in range(pp)])
    xs = jnp.asarray(rng.randn(dp * M, mb, d), jnp.float32)
    tgt = jnp.asarray(rng.randn(dp * M, mb, d), jnp.float32)
    popt = jhvd.DistributedOptimizer(optax.sgd(0.05), reduce_axes=("dp",))

    def pp_step(stacked, state, xs, tgt):
        def loss_fn(p):
            ys = gpipe_spmd(lambda w, x: jnp.tanh(x @ w[0]), p, xs,
                            axis_name="pp")
            return jnp.mean((ys - tgt) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(stacked)
        updates, state = popt.update(grads, state, stacked)
        return optax.apply_updates(stacked, updates), \
            jax.lax.pmean(loss, "dp")

    new, ploss = jax.jit(jax.shard_map(
        pp_step, mesh=_mesh("dp", "pp"),
        in_specs=(P("pp"), P("pp"), P("dp"), P("dp")),
        out_specs=(P("pp"), P())))(stages, popt.init(stages), xs, tgt)
    rng = np.random.RandomState(5)
    f = 8 * tp
    w1 = jnp.stack(shard_columns(jnp.asarray(rng.randn(d, f) * 0.3,
                                             jnp.float32), tp))
    w2 = jnp.stack(shard_rows(jnp.asarray(rng.randn(f, d) * 0.3,
                                          jnp.float32), tp))
    txs = jnp.asarray(rng.randn(4 * dp, d), jnp.float32)
    ttgt = jnp.asarray(rng.randn(4 * dp, d), jnp.float32)
    topt = jhvd.DistributedOptimizer(optax.sgd(0.05), reduce_axes=("dp",))

    def tp_step(params, state, xs, tgt):
        def loss_fn(p):
            y = column_row_parallel_mlp(xs, p["c"][0], p["r"][0],
                                        axis_name="tp")
            return jnp.mean((y - tgt) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = topt.update(grads, state, params)
        return optax.apply_updates(params, updates), \
            jax.lax.pmean(loss, "dp")

    tparams = {"c": w1, "r": w2}
    tnew, tloss = jax.jit(jax.shard_map(
        tp_step, mesh=_mesh("dp", "tp"),
        in_specs=(P("tp"), P("tp"), P("dp"), P("dp")),
        out_specs=(P("tp"), P())))(tparams, topt.init(tparams), txs, ttgt)
    for r, w in enumerate(world):
        j = r % 2
        np.testing.assert_allclose(float(w["p4_loss"]), float(ploss),
                                   rtol=1e-5)
        np.testing.assert_allclose(w["p4_w"], np.asarray(new)[j:j + 1],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(w["p5_loss"]), float(tloss),
                                   rtol=1e-5)
        np.testing.assert_allclose(w["p5_c"], np.asarray(tnew["c"])[j:j + 1],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(w["p5_r"], np.asarray(tnew["r"])[j:j + 1],
                                   rtol=1e-5, atol=1e-6)
