"""Process sets and the collective API of the port in a real 4-process
gloo world, against the JAX package on an emulated 4-rank world on the
same per-rank numpy data; and the process-set table without a world.

One world serves every check: a module fixture writes each rank's data
to a file and starts four worker processes (``hvd.init(device="cpu",
process_sets=[(0, 2)])`` from the launcher's environment); each runs
every op and saves its results.  The workers register (0, 2) at init and
(1, 2, 3) after it, use both, remove (0, 2), then register (0, 1, 2) and
(1, 3) in the same order on every rank (``dist.new_group`` is collective
over the world).

Members are held to the JAX op's output rank for rank: rtol 1e-6 for
f32, exact for integers and bool, a bf16 rounding step (rtol 2**-7) for
bf16 sums.  A rank outside a set gets its input back, unscaled, and every
member of a set holds the same bits.  The optimizer and batch-norm
comparisons run a model in both frameworks and are held to rtol 2e-5 /
atol 1e-6.
"""

import inspect

import numpy as np
import pytest

from test_torch_collectives import run_gloo_world

N = 4
A, B, C, D = (0, 2), (1, 2, 3), (0, 1, 2), (1, 3)
OPS = ("AVERAGE", "SUM", "MIN", "MAX", "PRODUCT")
RAGGED_ROWS = (2, 0, 3, 1)
SPLITS = np.array([[1, 0, 2, 1], [0, 0, 1, 3], [2, 2, 0, 0], [0, 1, 1, 1]])
LR, MOMENTUM, STEPS = 0.1, 0.9, 2


def _rank_data(r):
    """Rank r's inputs (the worker loads them from the data file)."""
    g = np.random.RandomState(300 + r)
    dense = np.zeros((5, 4), np.float32)
    dense[g.randint(0, 5, 3), g.randint(0, 4, 3)] = g.randn(3)
    dense[r, 0] = r + 1.0        # a position of this rank's own
    dense[2, 3] = 0.5 * (r + 1)  # one every rank holds: summed duplicates
    return {
        "x": g.randn(3, 5).astype(np.float32),
        "i": g.randint(-5, 6, (4,)).astype(np.int32),
        "b": g.rand(4, 3) < 0.5,
        "rag": g.randn(RAGGED_ROWS[r], 3).astype(np.float32),
        "a2a_w": g.randn(8, 2).astype(np.float32),
        "a2a_s": g.randn(6, 2).astype(np.float32),
        "a2a_i": g.randint(0, 100, (4, 3)).astype(np.int64),
        "a2av": g.randn(int(SPLITS[r].sum()), 2).astype(np.float32),
        "rs_e": g.randn(8, 3).astype(np.float32),
        "rs_p": g.randn(5, 3).astype(np.float32),
        "rs_i": g.randint(-20, 21, (5, 2)).astype(np.int32),
        "sparse": dense,
        "mlp_x": g.randn(5, 6).astype(np.float32),
        "bn_x": (g.randn(3, 4, 5) * 2 + r).astype(np.float32),
        "bn_c": g.randn(5).astype(np.float32),
        "bn_d": g.randn(5).astype(np.float32),
    }


def _obj(r):
    return {"rank": r, "vals": list(range(r)), "name": f"r{r}",
            "nested": {"t": (r, r * 0.5), "s": {r}}}


WORKER = '''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import sync_batch_norm as sbn
from horovod_tpu_torch.models.mlp import MLP
from horovod_tpu_torch.process_sets import ProcessSet

torch.set_num_threads(1)
out_path = sys.argv[1]
A, B, C, D = %(sets)r
OPS = %(ops)r
ps_a = ProcessSet(A)
hvd.init(device="cpu", process_sets=[ps_a])
r = hvd.rank()
assert hvd.size() == 4 and hvd.gloo_enabled()
assert hvd.local_slots() == 1 and hvd.is_homogeneous()
data = dict(np.load(DATA))
d = {k[:-1]: torch.from_numpy(v) for k, v in data.items()
     if k[-1] == str(r) and not k.startswith("w.")}
res = {}


def save(key, t):
    res[key] = t.detach().numpy().copy() if isinstance(t, torch.Tensor) \\
        else np.asarray(t)


def raises(exc, fn, words):
    try:
        fn()
    except exc as e:
        assert words in str(e), e
        return 1
    return 0


ps_b = hvd.add_process_set(list(B))
save("ids_1", [ps_a.process_set_id, ps_b.process_set_id])
assert hvd.add_process_set(ProcessSet([3, 2, 1])) is ps_b
x, i = d["x"], d["i"]
sets = {"A": ps_a, "B": ps_b}
for s, ps in sets.items():
    x0 = x.clone()
    for op in OPS:
        save(f"ar_{s}_{op}", hvd.allreduce(x, op=getattr(hvd.ReduceOp, op),
                                           process_set=ps))
    assert torch.equal(x, x0)
    for op in OPS:
        save(f"ar_bool_{s}_{op}", hvd.allreduce(
            d["b"], op=getattr(hvd.ReduceOp, op), process_set=ps))
    for op in ("AVERAGE", "SUM"):
        rop = getattr(hvd.ReduceOp, op)
        save(f"ar_scaled_{s}_{op}", hvd.allreduce(
            x, op=rop, prescale_factor=0.5, postscale_factor=3.0,
            process_set=ps))
        save(f"ar_int_{s}_{op}", hvd.allreduce(i, op=rop, process_set=ps))
    save(f"ar_fused_{s}", torch.cat([t.reshape(-1) for t in
         hvd.ops._fused_allreduce([x, 2 * x], op=hvd.Average,
                                  prescale_factor=0.5, postscale_factor=2.0,
                                  process_set=ps)]))
    save(f"bcast_{s}", hvd.broadcast(x, root_rank=1, process_set=ps))
    save(f"bcast_bool_{s}", hvd.broadcast(d["b"], root_rank=0,
                                          process_set=ps))
    hvd.barrier(process_set=ps)
    save(f"ag_{s}", hvd.allgather(x, process_set=ps))
    save(f"ag_rag_{s}", hvd.allgather(d["rag"], process_set=ps))
    save(f"rs_p_{s}", hvd.reducescatter(d["rs_p"], op=hvd.Sum,
                                        process_set=ps))
    save(f"rs_avg_{s}", hvd.reducescatter(d["rs_e"], op=hvd.Average,
                                          prescale_factor=2.0,
                                          postscale_factor=0.5,
                                          process_set=ps))
save("bcast_B_root2", hvd.broadcast(x, root_rank=2, process_set=ps_b))
save("a2a_A", hvd.alltoall(d["a2a_w"], process_set=ps_a))
save("a2a_B", hvd.alltoall(d["a2a_s"], process_set=ps_b))

# Over the world.
save("ag_w", hvd.allgather(x))
save("ag_rag_w", hvd.allgather(d["rag"]))
save("ag_bool_w", hvd.allgather(d["b"]))
save("ag_bf16_w", hvd.allgather(x.bfloat16()).float())
g0, g1 = hvd.grouped_allgather([x, d["rag"]])
save("gag_0", g0), save("gag_1", g1)
save("a2a_w", hvd.alltoall(d["a2a_w"]))
save("a2a_i_w", hvd.alltoall(d["a2a_i"]))
save("a2a_bool_w", hvd.alltoall(d["b"]))
out, recv = hvd.alltoall(d["a2av"], splits=torch.tensor(%(splits)r[r]))
assert recv.dtype == torch.int32
save("a2av", out), save("a2av_recv", recv)
save("rs_e_w", hvd.reducescatter(d["rs_e"]))
save("rs_p_w", hvd.reducescatter(d["rs_p"], op=hvd.Average,
                                 prescale_factor=0.5, postscale_factor=3.0))
save("rs_i_w", hvd.reducescatter(d["rs_i"], op=hvd.Average))
save("rs_bf16_w", hvd.reducescatter(d["rs_e"].bfloat16()).float())
g0, g1 = hvd.grouped_reducescatter([d["rs_e"], d["rs_p"]], op=hvd.Average,
                                   process_set=ps_a)
save("grs_0", g0), save("grs_1", g1)

# In place: the same values, written into the given tensors.
t = x.clone()
assert hvd.allreduce_(t, op=hvd.Sum, process_set=ps_b) is t
save("inplace_ar", t)
ts = [x.clone(), 2 * x]
outs = hvd.grouped_allreduce_(ts, op=hvd.Average, process_set=ps_a)
assert all(a is b for a, b in zip(outs, ts))
save("inplace_gar_0", ts[0]), save("inplace_gar_1", ts[1])
t = x.clone()
assert hvd.broadcast_(t, root_rank=1, process_set=ps_b) is t
save("inplace_bcast", t)

# Async: a handle per op; poll, then synchronize once.
handles = {
    "async_ar": hvd.allreduce_async(x, op=hvd.Sum, process_set=ps_b),
    "async_ag": hvd.allgather_async(d["rag"]),
    "async_a2a": hvd.alltoall_async(d["a2a_w"]),
    "async_rs": hvd.reducescatter_async(d["rs_p"], op=hvd.Sum),
    "async_bcast": hvd.broadcast_async(x, root_rank=1, process_set=ps_a),
}
t = x.clone()
h_inplace = hvd.allreduce_async_(t, op=hvd.Average)
h_grouped = hvd.grouped_allreduce_async([x, 2 * x], op=hvd.Sum,
                                        process_set=ps_b)
for k, h in handles.items():
    assert hvd.poll(h)
    save(k, hvd.synchronize(h))
assert hvd.synchronize(h_inplace) is t
save("async_inplace_ar", t)
g0, g1 = hvd.synchronize(h_grouped)
save("async_gar_0", g0), save("async_gar_1", g1)
save("resync_raises", raises(ValueError, lambda: hvd.synchronize(h_grouped),
                             "already-synchronized"))

# Objects and sparse tensors.
%(obj_fn)s
obj = _obj(r)
save("bobj_w", [hvd.broadcast_object(obj, root_rank=2) == _obj(2)])
save("bobj_B", [hvd.broadcast_object(obj, root_rank=1, process_set=ps_b)
                == _obj(2 if r in B else r)])
fn = hvd.broadcast_object_fn(root_rank=3)
save("bobj_fn", [fn(obj) == _obj(3)])
save("agobj_w", [hvd.allgather_object(obj) == [_obj(q) for q in range(4)]])
save("agobj_B", [hvd.allgather_object(obj, process_set=ps_b) ==
                 ([_obj(q) for q in B] if r in B else [obj])])
sp = d["sparse"].to_sparse()
save("sparse_sum_w", hvd.sparse_allreduce(sp, op=hvd.Sum).to_dense())
out = hvd.sparse_allreduce(sp, op=hvd.Average, process_set=ps_b)
assert out.is_sparse
save("sparse_avg_B", hvd.densify_if_sparse(out))

# What still refuses, and what a set must be.
save("raises_unregistered", raises(
    ValueError, lambda: hvd.allreduce(x, process_set=ProcessSet([0, 3])),
    "add_process_set"))
save("raises_splits_subset", raises(
    NotImplementedError, lambda: hvd.alltoall(
        d["a2a_s"], splits=[2, 2, 2], process_set=ps_b), "ROADMAP"))
save("adasum_B", hvd.allreduce(x, op=hvd.Adasum, process_set=ps_b))
save("raises_indivisible", raises(
    ValueError, lambda: hvd.alltoall(d["a2a_w"], process_set=ps_b),
    "divisible"))
save("raises_trailing", raises(
    ValueError, lambda: hvd.allgather(torch.zeros(2, 2 + (r == 3))),
    "trailing dims"))

# Remove (0, 2); register (0, 1, 2) and (1, 3) after it.
assert hvd.remove_process_set(ps_a)
assert not hvd.remove_process_set(hvd.global_process_set)
save("raises_removed", raises(
    ValueError, lambda: hvd.allreduce(x, process_set=ps_a),
    "add_process_set"))
ps_c = hvd.add_process_set(list(C))
ps_d = hvd.add_process_set(ProcessSet(D))
halves = hvd.partition_process_sets(2)
whole = hvd.partition_process_sets(1)[0]
save("ids_2", [ps_c.process_set_id, ps_d.process_set_id]
     + [p.process_set_id for p in halves] + [whole.process_set_id])
save("ids_all", hvd.get_process_set_ids())
save("included", [hvd.ops.members_of(p).included for p in halves])
save("ar_half", hvd.allreduce(x, op=hvd.Sum,
                              process_set=halves[r // 2]))
save("ar_whole", hvd.allreduce(x, op=hvd.Sum, process_set=whole))

# Two SGD-momentum steps of an MLP, averaged over (0, 1, 2).
model = MLP(6, (8, 3))
model.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in data.items()
                       if k.startswith("w.")})
opt = hvd.DistributedOptimizer(torch.optim.SGD(
    model.parameters(), lr=%(lr)r, momentum=%(momentum)r), process_set=ps_c)
for _ in range(%(steps)r):
    opt.zero_grad()
    (model(d["mlp_x"]) ** 2).mean().backward()
    opt.step()
for k, v in model.state_dict().items():
    save("mlp." + k, v)

# Batch statistics over (1, 3), and their gradient.
xb = d["bn_x"].clone().requires_grad_()
n0 = dict(sbn.STATS_ALLREDUCES)
mean, var = hvd.sync_batch_stats(xb, process_set=ps_d)
((mean * d["bn_c"]).sum() + (var * d["bn_d"]).sum()).backward()
save("bn_mean", mean), save("bn_var", var), save("bn_grad", xb.grad)
save("bn_collectives", [sbn.STATS_ALLREDUCES[k] - n0[k] for k in n0])
bn = hvd.SyncBatchNorm(5, momentum=0.5, process_set=ps_d)
bn(d["bn_x"], use_running_average=False)
save("bn_running_mean", bn.mean)

np.savez(out_path, **res)
hvd.shutdown()
''' % {"sets": (A, B, C, D), "ops": OPS, "splits": SPLITS.tolist(),
       "lr": LR, "momentum": MOMENTUM, "steps": STEPS,
       "obj_fn": inspect.getsource(_obj)}


def _mlp():
    from horovod_tpu.models import mlp as jmlp
    return jmlp.create_mlp((8, 3))


def _mlp_params():
    import jax
    import jax.numpy as jnp
    params = _mlp().init(jax.random.PRNGKey(0), jnp.zeros((1, 6)))["params"]
    rng = np.random.RandomState(5)
    return jax.tree_util.tree_map(
        lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32),
        jax.device_get(params))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from horovod_tpu_torch.models import resnet_params_from_jax
    tmp = tmp_path_factory.mktemp("psets")
    data = {f"{k}{r}": v for r in range(N) for k, v in _rank_data(r).items()}
    for k, v in resnet_params_from_jax({"params": _mlp_params()}).items():
        data["w." + k] = v.numpy()
    np.savez(tmp / "data.npz", **data)
    script = WORKER.replace("DATA", repr(str(tmp / "data.npz")))
    return run_gloo_world(script, tmp, size=N, timeout=300)


@pytest.fixture(scope="module")
def jax4():
    """The JAX package on an emulated 4-rank world (eager ops take and
    return per-rank stacks [4, ...]), with the worker's sets registered."""
    import os
    import horovod_tpu as hvd
    hvd.shutdown()
    old = os.environ.get("HVD_TPU_EMULATE_RANKS")
    os.environ["HVD_TPU_EMULATE_RANKS"] = str(N)
    try:
        hvd.init()
        assert hvd.size() == N
        sets = {name: hvd.add_process_set(list(ranks)) for name, ranks in
                (("A", A), ("B", B), ("C", C), ("D", D))}
        yield hvd, sets
    finally:
        hvd.shutdown()
        if old is None:
            os.environ.pop("HVD_TPU_EMULATE_RANKS", None)
        else:
            os.environ["HVD_TPU_EMULATE_RANKS"] = old


def _stack(key):
    return np.stack([_rank_data(r)[key] for r in range(N)])


def _members(s):
    return {"A": A, "B": B, "C": C, "D": D, "w": tuple(range(N))}[s]


def _check(world, key, want, members, inputs=None, rtol=1e-6, atol=1e-6):
    """Members hold JAX's per-rank output (``want`` [N, ...] or a list)
    and identical bits where JAX gives every member the same value; the
    others hold ``inputs`` [N, ...] exactly."""
    for r in range(N):
        got = world[r][key]
        if r in members:
            w = np.asarray(want[r])
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(got, w, rtol=rtol, atol=atol,
                                           err_msg=f"{key} rank {r}")
            else:
                np.testing.assert_array_equal(got, w, err_msg=f"{key} {r}")
        else:
            np.testing.assert_array_equal(got, np.asarray(inputs)[r],
                                          err_msg=f"{key} non-member {r}")


def _same_bits(world, key, members):
    for r in members[1:]:
        np.testing.assert_array_equal(world[r][key], world[members[0]][key],
                                      err_msg=key)


@pytest.mark.parametrize("s", ["A", "B"])
def test_subset_allreduce_every_op_and_scale_matches_jax(world, jax4, s):
    import jax.numpy as jnp
    hvd, sets = jax4
    ps, members = sets[s], _members(s)
    x, i = jnp.asarray(_stack("x")), jnp.asarray(_stack("i"))
    for op in OPS:
        rop = getattr(hvd.ReduceOp, op)
        _check(world, f"ar_{s}_{op}", hvd.allreduce(x, op=rop, process_set=ps),
               members, _stack("x"))
        _same_bits(world, f"ar_{s}_{op}", members)
        # Bool sums and averages count (int32, as lax.psum does); a rank
        # outside the set gets its input in that type, as in JAX.
        want = hvd.allreduce(jnp.asarray(_stack("b")), op=rop,
                             process_set=ps)
        if op == "MAX":
            # JAX masks a non-member's bool with -inf cast to bool, True,
            # so its MAX over a subset is all True (ROADMAP Queue C,
            # reference quirks): hold the port to OR over the members.
            want = np.stack([_stack("b")[list(members)].any(0)] * N)
        _check(world, f"ar_bool_{s}_{op}", want, members,
               _stack("b").astype(np.asarray(want).dtype))
        for r in range(N):
            assert world[r][f"ar_bool_{s}_{op}"].dtype == \
                np.asarray(want).dtype, (op, r)
    for op in ("AVERAGE", "SUM"):
        rop = getattr(hvd.ReduceOp, op)
        _check(world, f"ar_scaled_{s}_{op}",
               hvd.allreduce(x, op=rop, prescale_factor=0.5,
                             postscale_factor=3.0, process_set=ps),
               members, _stack("x"))
        _check(world, f"ar_int_{s}_{op}",
               hvd.allreduce(i, op=rop, process_set=ps), members,
               _stack("i"))
    want = hvd.grouped_allreduce([x, 2 * x], op=hvd.Average,
                                 prescale_factor=0.5, postscale_factor=2.0,
                                 process_set=ps)
    flat = np.concatenate([np.asarray(w).reshape(N, -1) for w in want], 1)
    inputs = np.concatenate([_stack("x").reshape(N, -1),
                             2 * _stack("x").reshape(N, -1)], 1)
    _check(world, f"ar_fused_{s}", flat, members, inputs)


@pytest.mark.parametrize("s", ["A", "B"])
def test_subset_broadcast_root_is_set_relative(world, jax4, s):
    import jax.numpy as jnp
    hvd, sets = jax4
    ps, members = sets[s], _members(s)
    x = jnp.asarray(_stack("x"))
    _check(world, f"bcast_{s}",
           hvd.broadcast(x, root_rank=1, process_set=ps, stacked=True),
           members, _stack("x"))
    _check(world, f"bcast_bool_{s}",
           hvd.broadcast(jnp.asarray(_stack("b")), root_rank=0,
                         process_set=ps, stacked=True), members, _stack("b"))
    if s == "B":
        # Set rank 2 of (1, 2, 3) is global rank 3.
        want = hvd.broadcast(x, root_rank=2, process_set=ps, stacked=True)
        _check(world, "bcast_B_root2", want, members, _stack("x"))
        np.testing.assert_array_equal(world[1]["bcast_B_root2"],
                                      _stack("x")[3])


@pytest.mark.parametrize("s", ["A", "B", "w"])
def test_allgather_even_and_ragged_matches_jax(world, jax4, s):
    import jax.numpy as jnp
    hvd, sets = jax4
    ps = sets.get(s, hvd.global_process_set)
    members = _members(s)
    rag = [_rank_data(r)["rag"] for r in range(N)]
    want = hvd.allgather(jnp.asarray(_stack("x")), process_set=ps)
    _check(world, f"ag_{s}", want, members, _stack("x"))
    assert world[members[0]][f"ag_{s}"].shape == (3 * len(members), 5)
    want = hvd.allgather(rag, process_set=ps)   # ragged: per-rank lists
    for r in range(N):
        got = world[r][f"ag_rag_{s}"]
        np.testing.assert_array_equal(
            got, np.asarray(want[r]) if r in members else rag[r])
    assert world[members[0]][f"ag_rag_{s}"].shape[0] == sum(
        RAGGED_ROWS[r] for r in members)
    _same_bits(world, f"ag_rag_{s}", members)


def test_allgather_of_other_types_and_grouped(world, jax4):
    import jax.numpy as jnp
    hvd, _ = jax4
    world_ranks = tuple(range(N))
    _check(world, "ag_bool_w", hvd.allgather(jnp.asarray(_stack("b"))),
           world_ranks)
    want = hvd.allgather(jnp.asarray(_stack("x")).astype(jnp.bfloat16))
    _check(world, "ag_bf16_w", np.asarray(want, np.float32), world_ranks,
           rtol=0, atol=0)
    rag = [_rank_data(r)["rag"] for r in range(N)]
    _check(world, "gag_0", hvd.allgather(jnp.asarray(_stack("x"))),
           world_ranks)
    _check(world, "gag_1", [np.asarray(a) for a in hvd.allgather(rag)],
           world_ranks)


def test_alltoall_even_and_with_splits_matches_jax(world, jax4):
    import jax.numpy as jnp
    hvd, sets = jax4
    world_ranks = tuple(range(N))
    for key, data in (("a2a_w", "a2a_w"), ("a2a_i_w", "a2a_i"),
                      ("a2a_bool_w", "b")):
        _check(world, key, hvd.alltoall(jnp.asarray(_stack(data))),
               world_ranks)
    _check(world, "a2a_A", hvd.alltoall(jnp.asarray(_stack("a2a_w")),
                                        process_set=sets["A"]),
           A, _stack("a2a_w"))
    _check(world, "a2a_B", hvd.alltoall(jnp.asarray(_stack("a2a_s")),
                                        process_set=sets["B"]),
           B, _stack("a2a_s"))
    outs, received = hvd.alltoall(
        [_rank_data(r)["a2av"] for r in range(N)], splits=SPLITS)
    _check(world, "a2av", [np.asarray(o) for o in outs], world_ranks)
    _check(world, "a2av_recv", np.asarray(received).astype(np.int32),
           world_ranks)


def test_reducescatter_even_padded_sum_and_average_match_jax(world, jax4):
    import jax.numpy as jnp
    hvd, sets = jax4
    world_ranks = tuple(range(N))
    rs_e, rs_p = jnp.asarray(_stack("rs_e")), jnp.asarray(_stack("rs_p"))
    _check(world, "rs_e_w", hvd.reducescatter(rs_e), world_ranks)
    _check(world, "rs_p_w", hvd.reducescatter(
        rs_p, op=hvd.Average, prescale_factor=0.5, postscale_factor=3.0),
        world_ranks)
    assert world[0]["rs_p_w"].shape == (2, 3)   # 5 rows padded to 8
    _check(world, "rs_i_w", hvd.reducescatter(
        jnp.asarray(_stack("rs_i")), op=hvd.Average), world_ranks)
    _check(world, "rs_bf16_w", np.asarray(
        hvd.reducescatter(rs_e.astype(jnp.bfloat16)), np.float32),
        world_ranks, rtol=2 ** -7, atol=2 ** -7)
    for s in ("A", "B"):
        ps = sets[s]
        _check(world, f"rs_p_{s}", hvd.reducescatter(rs_p, process_set=ps),
               _members(s), _stack("rs_p"))
        _check(world, f"rs_avg_{s}", hvd.reducescatter(
            rs_e, op=hvd.Average, prescale_factor=2.0, postscale_factor=0.5,
            process_set=ps), _members(s), _stack("rs_e"))
    want = [hvd.reducescatter(t, op=hvd.Average, process_set=sets["A"])
            for t in (rs_e, rs_p)]
    _check(world, "grs_0", want[0], A, _stack("rs_e"))
    _check(world, "grs_1", want[1], A, _stack("rs_p"))


def test_in_place_and_async_forms_match_jax(world, jax4):
    import jax.numpy as jnp
    hvd, sets = jax4
    x = jnp.asarray(_stack("x"))
    xs = _stack("x")
    world_ranks = tuple(range(N))
    rag = [_rank_data(r)["rag"] for r in range(N)]
    cases = {
        "inplace_ar": (hvd.allreduce_(x, op=hvd.Sum, process_set=sets["B"]),
                       B, xs),
        "inplace_gar_0": (hvd.grouped_allreduce_(
            [x, 2 * x], op=hvd.Average, process_set=sets["A"])[0], A, xs),
        "inplace_gar_1": (hvd.grouped_allreduce_(
            [x, 2 * x], op=hvd.Average, process_set=sets["A"])[1], A,
            2 * xs),
        "inplace_bcast": (hvd.broadcast_(x, root_rank=1,
                                         process_set=sets["B"]), B, xs),
        "async_ar": (hvd.synchronize(hvd.allreduce_async(
            x, op=hvd.Sum, process_set=sets["B"])), B, xs),
        "async_ag": ([np.asarray(a) for a in hvd.synchronize(
            hvd.allgather_async(rag))], world_ranks, None),
        "async_a2a": (hvd.synchronize(hvd.alltoall_async(
            jnp.asarray(_stack("a2a_w")))), world_ranks, None),
        "async_rs": (hvd.synchronize(hvd.reducescatter_async(
            jnp.asarray(_stack("rs_p")), op=hvd.Sum)), world_ranks, None),
        "async_bcast": (hvd.synchronize(hvd.broadcast_async(
            x, root_rank=1, process_set=sets["A"])), A, xs),
        "async_inplace_ar": (hvd.synchronize(hvd.allreduce_async_(
            x, op=hvd.Average)), world_ranks, None),
    }
    grouped = hvd.synchronize(hvd.grouped_allreduce_async(
        [x, 2 * x], op=hvd.Sum, process_set=sets["B"]))
    cases["async_gar_0"] = (grouped[0], B, xs)
    cases["async_gar_1"] = (grouped[1], B, 2 * xs)
    for key, (want, members, inputs) in cases.items():
        _check(world, key, want, members, inputs)
    for r in range(N):
        assert int(world[r]["resync_raises"]) == 1
    h = hvd.allreduce_async(x)
    hvd.synchronize(h)
    with pytest.raises(ValueError, match="already-synchronized"):
        hvd.synchronize(h)


def test_object_helpers_match_jax(world, jax4):
    hvd, _ = jax4
    objs = [_obj(r) for r in range(N)]
    # The JAX package's emulated helpers hold every rank's object.
    assert hvd.allgather_object(objs) == objs
    assert hvd.broadcast_object(objs[2], root_rank=2) == objs[2]
    for r in range(N):
        for key in ("bobj_w", "bobj_B", "bobj_fn", "agobj_w", "agobj_B"):
            assert bool(world[r][key][0]), (key, r)


def test_sparse_allreduce_matches_jax_todense(world, jax4):
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse
    hvd, sets = jax4
    mats = [jsparse.BCOO.fromdense(jnp.asarray(_rank_data(r)["sparse"]))
            for r in range(N)]
    want = np.asarray(hvd.sparse_allreduce(mats, op=hvd.Sum).todense())
    _check(world, "sparse_sum_w", np.stack([want] * N), tuple(range(N)))
    want = np.asarray(hvd.sparse_allreduce(
        mats, op=hvd.Average, process_set=sets["B"]).todense())
    _check(world, "sparse_avg_B", np.stack([want] * N), B, _stack("sparse"))


def test_registration_removal_and_refusals(world):
    for r in range(N):
        w = world[r]
        assert w["ids_1"].tolist() == [1, 2]
        # Ids are never reused: (0, 2) was 1; (0, 1), (2, 3) and the
        # whole world follow (0, 1, 2) and (1, 3).
        assert w["ids_2"].tolist() == [3, 4, 5, 6, 7]
        assert w["ids_all"].tolist() == [0, 2, 3, 4, 5, 6, 7]
        assert w["included"].tolist() == [r < 2, r >= 2]
        for key in ("raises_unregistered", "raises_splits_subset",
                    "raises_indivisible", "raises_trailing",
                    "raises_removed"):
            assert int(w[key]) == 1, (key, r)
    xs = _stack("x")
    # Adasum no longer refuses: over (1, 2, 3), the zero-padded tree of
    # the float64 model (JAX's tolerance rtol 1e-4); rank 0 keeps x.
    _check(world, "adasum_B", np.stack([_np_adasum_tree(xs[list(B)])] * N),
           B, xs, rtol=1e-4)
    _same_bits(world, "adasum_B", B)
    for r in range(N):
        half = (r // 2) * 2
        np.testing.assert_allclose(world[r]["ar_half"],
                                   xs[half] + xs[half + 1], rtol=1e-6)
        np.testing.assert_allclose(world[r]["ar_whole"], xs.sum(0),
                                   rtol=1e-6, atol=1e-6)


def _np_adasum_tree(ts):
    ts = [t.astype(np.float64) for t in ts]
    while len(ts) & (len(ts) - 1):
        ts.append(np.zeros_like(ts[0]))
    while len(ts) > 1:
        pairs = []
        for a, b in zip(ts[0::2], ts[1::2]):
            dot, na, nb = (a * b).sum(), (a * a).sum(), (b * b).sum()
            pairs.append((1 - dot / (2 * na) if na else 1.0) * a
                         + (1 - dot / (2 * nb) if nb else 1.0) * b)
        ts = pairs
    return ts[0]


def test_optimizer_over_a_set_matches_jax(world, jax4):
    """Two SGD-momentum steps over (0, 1, 2): JAX's optimizer, eager on
    the per-rank stacks, against each port rank; rank 3 steps on its own
    gradient."""
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu_torch.models import resnet_params_from_jax
    hvd, sets = jax4
    model = _mlp()
    stk = jax.tree_util.tree_map(lambda p: jnp.stack([p] * N), _mlp_params())
    opt = hvd.DistributedOptimizer(optax.sgd(LR, momentum=MOMENTUM),
                                   process_set=sets["C"])
    state = opt.init(stk)
    xs = jnp.asarray(_stack("mlp_x"))

    def loss(p, xb):
        return jnp.mean(model.apply({"params": p}, xb) ** 2)

    for _ in range(STEPS):
        grads = jax.vmap(jax.grad(loss))(stk, xs)
        updates, state = opt.update(grads, state, stk)
        stk = optax.apply_updates(stk, updates)
    stk = jax.device_get(stk)
    for r in range(N):
        want = resnet_params_from_jax({"params": jax.tree_util.tree_map(
            lambda a: a[r], stk)})
        for k, w in want.items():
            np.testing.assert_allclose(world[r]["mlp." + k], w.numpy(),
                                       rtol=2e-5, atol=1e-6,
                                       err_msg=f"{k} rank {r}")
    for k in want:
        _same_bits(world, "mlp." + k, C)
        assert not np.array_equal(world[3]["mlp." + k],
                                  world[0]["mlp." + k])


def test_sync_batch_stats_over_a_set_match_jax(world, jax4):
    """``sync_batch_stats`` over (1, 3) inside JAX's shard_map, value and
    input gradient of each rank's loss, against each port rank; ranks 0
    and 2 keep their own statistics."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.sync_batch_norm import sync_batch_stats
    hvd, sets = jax4

    def body(x, c, d):
        def loss(x):
            mean, var = sync_batch_stats(x, process_set=sets["D"])
            return jnp.sum(mean * c[0]) + jnp.sum(var * d[0]), (mean, var)
        (_, (mean, var)), g = jax.value_and_grad(loss, has_aux=True)(x[0])
        return mean[None], var[None], g[None]

    mean, var, grad = jax.jit(jax.shard_map(
        body, mesh=hvd.mesh(), in_specs=(P("hvd"),) * 3,
        out_specs=P("hvd")))(*(jnp.asarray(_stack(k))
                               for k in ("bn_x", "bn_c", "bn_d")))
    world_ranks = tuple(range(N))
    for key, want in (("bn_mean", mean), ("bn_var", var), ("bn_grad", grad)):
        _check(world, key, np.asarray(want), world_ranks, rtol=2e-5,
               atol=1e-6)
    _same_bits(world, "bn_mean", D)
    xs = _stack("bn_x").astype(np.float64)
    np.testing.assert_allclose(world[1]["bn_mean"],
                               xs[[1, 3]].mean(axis=(0, 1, 2)), rtol=1e-5)
    np.testing.assert_allclose(world[0]["bn_mean"], xs[0].mean(axis=(0, 1)),
                               rtol=1e-5)
    for r in range(N):
        assert world[r]["bn_collectives"].tolist() == [1, 1]
        np.testing.assert_allclose(world[r]["bn_running_mean"],
                                   0.5 * world[r]["bn_mean"], rtol=1e-6)


# -- the table without a world (tests/test_basics.py:48-80) ------------------

@pytest.fixture()
def world8(monkeypatch):
    """An initialized port state of 8 ranks, this process rank 0, whose
    subset groups are stand-ins (no torch.distributed world)."""
    from horovod_tpu_torch import core, process_sets, topology
    made, destroyed = [], []
    monkeypatch.setattr(process_sets.dist, "new_group",
                        lambda ranks: made.append(list(ranks)) or object())
    monkeypatch.setattr(process_sets.dist, "destroy_process_group",
                        destroyed.append)
    monkeypatch.setattr(core._state, "initialized", True)
    monkeypatch.setattr(core._state, "topology", topology.Topology(
        rank=0, size=8, local_rank=0, local_size=8, cross_rank=0,
        cross_size=1))
    monkeypatch.setattr(core._state, "process_set_table",
                        process_sets.ProcessSetTable(8))
    return made, destroyed


def test_process_set_crud(world8):
    import horovod_tpu_torch as hvd
    made, destroyed = world8
    ps = hvd.add_process_set([0, 1, 2])
    assert ps.process_set_id is not None and ps.process_set_id > 0
    assert ps.size() == 3
    assert ps.rank() == 0
    assert ps.included()
    ps2 = hvd.add_process_set([2, 1, 0])
    assert ps2.process_set_id == ps.process_set_id
    assert made == [[0, 1, 2]]          # one group, made once
    ids = hvd.get_process_set_ids()
    pid = ps.process_set_id
    assert 0 in ids and pid in ids
    assert hvd.remove_process_set(ps)
    assert pid not in hvd.get_process_set_ids()
    assert len(destroyed) == 1
    whole = hvd.add_process_set(list(range(8)))
    assert whole.members() is None and made == [[0, 1, 2]]
    assert whole.process_set_id == pid + 1   # ids are never reused


def test_global_process_set_protected(world8):
    import horovod_tpu_torch as hvd
    assert not hvd.remove_process_set(hvd.global_process_set)
    assert hvd.global_process_set.size() == 8


def test_process_set_excluded_rank(world8):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import members_of
    ps = hvd.ProcessSet([3, 4])
    hvd.add_process_set(ps)
    assert ps.rank() is None
    assert not ps.included()
    assert ps.members() == (3, 4)
    m = members_of(ps)
    assert (m.ranks, m.set_rank, m.size) == ((3, 4), None, 2)
    hvd.remove_process_set(ps)


def test_process_set_validation(world8):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import members_of
    with pytest.raises(ValueError):
        hvd.add_process_set([0, 99])
    with pytest.raises(ValueError):
        hvd.add_process_set([])
    with pytest.raises(ValueError, match="add_process_set"):
        members_of(hvd.ProcessSet([1, 5]))
    with pytest.raises(ValueError, match="cannot partition"):
        hvd.partition_process_sets(9)
    sets = hvd.partition_process_sets(3)
    assert [p.ranks for p in sets] == [[0, 1, 2], [3, 4, 5], [6, 7]]


def test_exports_match_jax_but_for_the_listed_gap():
    """The port exports what the JAX package exports from its API modules
    (``horovod_tpu/__init__.py``), but for the names still to port."""
    import ast
    import os
    import horovod_tpu_torch as thvd
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "horovod_tpu", "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    modules = {"version", "core", "ops", "compression", "optimizer",
               "functions", "sync_batch_norm", "sparse", "process_sets",
               "exceptions", "parallel"}
    names = {a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) and node.module in modules
             for a in node.names}
    missing = {n for n in names if not hasattr(thvd, n)}
    assert missing == {"distributed_gradient_transformation"}
    assert len(names) > 70


def test_topology_slots_and_handles_without_a_world():
    import torch
    from horovod_tpu_torch import topology
    from horovod_tpu_torch.ops.eager import HandleManager
    topo = topology.Topology(rank=2, size=3, local_rank=0, local_size=2,
                             cross_rank=1, cross_size=2)
    assert (topo.num_slots, topo.local_slots, topo.is_homogeneous) == \
        (3, 1, True)
    handles = HandleManager()
    out = (torch.ones(2), [torch.zeros(1)])
    h = handles.allocate(out)
    assert handles.poll(h) and handles.wait(h) is out
    for call in (handles.poll, handles.wait):
        with pytest.raises(ValueError, match="unknown or already"):
            call(h)
