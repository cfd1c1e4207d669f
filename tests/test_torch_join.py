"""``join`` and negotiation in real gloo worlds, and the two-level
allreduce against the JAX package's.

World A (2 processes) follows ``tests/test_join.py`` and
``tests/test_negotiation_unit.py``: rank 1 joins early, the coordinator
joins early, the allgather family under a join, a cached-dispatch
stress, rejected mismatches (shape, dtype, op, process set) that leave
the world usable, ``DuplicateNameError``, and a stall report naming the
missing rank.  World B (4 processes): a staggered join (steps {0: 3,
1: 1, 2: 2, 3: 0}) in which every round sums exactly the live ranks, a
join under a registered process set, ``DistributedOptimizer`` over
uneven data held to a float64 numpy model, and
``hierarchical_allreduce(local_size=2)`` against JAX's
``collective_ops.hierarchical_allreduce`` under ``shard_map`` in the
emulated 4-rank world (f32 within f32 tolerance, int32 exactly).
"""

import os

import numpy as np
import pytest

from test_torch_collectives import run_gloo_world

STRESS_ROUNDS = 12

WORLD_A = '''
import os, sys, time
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.exceptions import (CollectiveRejectedError,
                                          DuplicateNameError)

os.environ["HOROVOD_STALL_CHECK_TIME_SECONDS"] = "1"
torch.set_num_threads(1)
hvd.init(device="cpu")
r = hvd.rank()
res = {}

# Rank 1 joins early: rank 0's three allreduces sum its own value.
if r == 1:
    res["last_a"] = hvd.join()
else:
    res["solo_a"] = [float(hvd.allreduce(torch.full((4,), 2.0), op=hvd.Sum,
                                         name="g")[0]) for _ in range(3)]
    res["last_a"] = hvd.join()

# The coordinator joins early.
if r == 0:
    res["last_b"] = hvd.join()
else:
    res["solo_b"] = [float(hvd.allreduce(torch.full((3,), 5.0), op=hvd.Sum,
                                         name="h")[0]) for _ in range(2)]
    res["last_b"] = hvd.join()

# The allgather family: a ragged gather and a ragged alltoall while
# rank 0 has joined (it sends no rows).
if r == 0:
    res["last_c"] = hvd.join()
else:
    res["ag"] = hvd.allgather(torch.full((3, 2), 7.0))
    out, recv = hvd.alltoall(torch.arange(4.0).view(4, 1), splits=[1, 3])
    res["a2av"], res["a2av_recv"] = out, recv
    res["last_c"] = hvd.join()

# Cached-dispatch stress: every round one rank dispatches k cached
# allreduces while the other has joined.
sums = []
for rnd in range(%(rounds)d):
    if r == rnd %% 2:
        for _ in range(rnd %% 3 + 1):
            sums.append(float(hvd.allreduce(torch.full((2,), float(rnd)),
                                            op=hvd.Sum, name="stress")[0]))
    hvd.join()
res["stress"] = sums

# Rejected mismatches: every rank raises the same verdict, and the world
# stays usable.
single = hvd.add_process_set([0])
for case, kw in (
        ("shape", dict(tensor=torch.ones(4 + r))),
        ("dtype", dict(tensor=torch.ones(4, dtype=torch.float32 if r == 0
                                         else torch.float64))),
        ("op", dict(tensor=torch.ones(4), op=hvd.Sum if r == 0
                    else hvd.Max)),
        ("ps", dict(tensor=torch.ones(4), process_set=single if r == 0
                    else hvd.global_process_set))):
    try:
        hvd.allreduce(name="m." + case, **kw)
        res["verdict_" + case] = "none"
    except CollectiveRejectedError as e:
        res["verdict_" + case] = str(e)
res["after"] = hvd.allreduce(torch.full((4,), float(r + 1)), op=hvd.Sum,
                             name="m.shape")

# A ragged alltoall whose trailing dims differ by rank: every rank sees
# every rank's split row, so every rank raises; then a matched one runs.
try:
    hvd.alltoall(torch.zeros(2, 1 + r), splits=[1, 1])
    res["a2av_trailing"] = "none"
except ValueError as e:
    res["a2av_trailing"] = str(e)
out, recv = hvd.alltoall(torch.full((3, 2), float(r)), splits=[1 + r, 2 - r])
res["a2av_after"], res["a2av_after_recv"] = out, recv

# A second op under a claimed name.
eng = hvd.core._state.engine
eng.claim_name("dup")
try:
    hvd.allreduce(torch.ones(2), name="dup")
    res["dup"] = [0]
except DuplicateNameError:
    res["dup"] = [1]
eng.release_name("dup")
res["dup_after"] = hvd.allreduce(torch.ones(2), name="dup", op=hvd.Sum)

# A stall: rank 1 arrives 2.5 s late; the coordinator reports it missing.
if r == 1:
    time.sleep(2.5)
hvd.allreduce(torch.ones(2), name="late")
neg = eng.negotiator
res["stall"] = [str(rep) for rep in neg.stall_reports]
res["counts"] = [neg.negotiated, neg.cached, neg.dispatch_seq]
np.savez(sys.argv[1], **{k: np.asarray(v.detach().numpy()
                                       if torch.is_tensor(v) else v)
                         for k, v in res.items()})
hvd.shutdown()
''' % {"rounds": STRESS_ROUNDS}


@pytest.fixture(scope="module")
def world_a(tmp_path_factory):
    return run_gloo_world(WORLD_A, tmp_path_factory.mktemp("join2"), size=2,
                          timeout=240)


def test_rank1_then_coordinator_join_early(world_a):
    assert list(world_a[0]["solo_a"]) == [2.0] * 3
    assert list(world_a[1]["solo_b"]) == [5.0] * 2
    for r in (0, 1):
        assert int(world_a[r]["last_a"]) == 0
        assert int(world_a[r]["last_b"]) == 1
        assert int(world_a[r]["last_c"]) == 1


def test_allgather_family_under_join(world_a):
    w = world_a[1]
    np.testing.assert_array_equal(w["ag"], np.full((3, 2), 7.0))
    # Rank 1 keeps rows 1..3 of its own [0, 1, 2, 3] and gets none from
    # the joined rank 0.
    np.testing.assert_array_equal(w["a2av"], [[1.0], [2.0], [3.0]])
    np.testing.assert_array_equal(w["a2av_recv"], [0, 3])


def test_cached_dispatch_stress(world_a):
    want = {0: [], 1: []}
    for rnd in range(STRESS_ROUNDS):
        want[rnd % 2] += [float(rnd)] * (rnd % 3 + 1)
    for r in (0, 1):
        assert list(world_a[r]["stress"]) == want[r]
    negotiated, cached, seq = world_a[0]["counts"]
    assert cached > negotiated and seq > 2 * STRESS_ROUNDS


def test_rejected_mismatches_leave_the_world_usable(world_a):
    marks = {"shape": "Mismatched shapes",
             "dtype": "Mismatched data types for collective m.dtype: rank 0 "
                      "sent float32, rank 1 sent float64",
             "op": "Mismatched ops",
             "ps": "process-set membership mismatch on 'm.ps': rank 1 "
                   "announced None vs [0]"}
    for case, mark in marks.items():
        v0, v1 = (str(world_a[r]["verdict_" + case]) for r in (0, 1))
        assert v0 == v1 and mark in v0, (case, v0, v1)
        assert v0.startswith(f"collective 'm.{case}' rejected by "
                             f"coordinator: ")
    for r in (0, 1):
        np.testing.assert_array_equal(world_a[r]["after"], np.full(4, 3.0))


def test_ragged_alltoall_trailing_mismatch_raises_on_every_rank(world_a):
    for r in (0, 1):
        assert "trailing dims" in str(world_a[r]["a2av_trailing"])
    # Rank 0 sends 1 row to itself and 2 to rank 1; rank 1 sends 2 and 1.
    np.testing.assert_array_equal(world_a[0]["a2av_after"],
                                  [[0.0, 0.0], [1.0, 1.0], [1.0, 1.0]])
    np.testing.assert_array_equal(world_a[0]["a2av_after_recv"], [1, 2])
    np.testing.assert_array_equal(world_a[1]["a2av_after"],
                                  [[0.0, 0.0], [0.0, 0.0], [1.0, 1.0]])
    np.testing.assert_array_equal(world_a[1]["a2av_after_recv"], [2, 1])


def test_duplicate_name_and_stall_report(world_a):
    for r in (0, 1):
        assert list(world_a[r]["dup"]) == [1]
        np.testing.assert_array_equal(world_a[r]["dup_after"], [2.0, 2.0])
    reports = list(world_a[0]["stall"])
    assert reports and all("'late'" in s and "[0], [1])" in s
                           for s in reports), reports
    assert len(world_a[1]["stall"]) == 0  # only the coordinator inspects


N = 4
STEPS = {0: 3, 1: 1, 2: 2, 3: 0}
OPT_STEPS = {0: 1, 1: 2, 2: 3, 3: 4}
LR = 0.1
HIER_LEN = 7  # odd: padded to 8 inside the two-level reduction


def _mlp_init():
    g = np.random.RandomState(11)
    return {"fc1.weight": (0.5 * g.randn(5, 6)).astype(np.float32),
            "fc1.bias": (0.1 * g.randn(5)).astype(np.float32),
            "fc2.weight": (0.5 * g.randn(3, 5)).astype(np.float32),
            "fc2.bias": (0.1 * g.randn(3)).astype(np.float32)}


def _batch(r, s):
    g = np.random.RandomState(100 * r + s)
    return g.randn(4, 6).astype(np.float32), g.randn(4, 3).astype(np.float32)


def _hier_data(r):
    g = np.random.RandomState(300 + r)
    return (g.randn(HIER_LEN).astype(np.float32),
            g.randint(-50, 50, HIER_LEN).astype(np.int32))


WORLD_B = '''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd

torch.set_num_threads(1)
hvd.init(device="cpu")
r = hvd.rank()
res = {}

# Staggered join: each round sums the ranks still live.
res["sums"] = [float(hvd.allreduce(torch.full((3,), float(r + 1)),
                                   op=hvd.Sum, name="s")[0])
               for _ in range(%(steps)r[r])]
res["last_stagger"] = hvd.join()

# A join under a registered process set: rank 2 reduces over (0, 2)
# while rank 0 has joined; ranks 1 and 3 only negotiate.
ps = hvd.add_process_set([0, 2])
if r == 2:
    res["ps_sums"] = [float(hvd.allreduce(torch.full((2,), 4.0), op=hvd.Sum,
                                          process_set=ps)[0])
                      for _ in range(2)]
res["last_ps"] = hvd.join()

# DistributedOptimizer over uneven data, then the last rank's parameters.
init = %(init)r
model = torch.nn.Sequential()
model.add_module("fc1", torch.nn.Linear(6, 5))
model.add_module("act", torch.nn.Tanh())
model.add_module("fc2", torch.nn.Linear(5, 3))
model.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                       for k, v in init.items()})
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                               lr=%(lr)r), op=hvd.Average)
for s in range(%(opt_steps)r[r]):
    g = np.random.RandomState(100 * r + s)
    x = torch.from_numpy(g.randn(4, 6).astype(np.float32))
    y = torch.from_numpy(g.randn(4, 3).astype(np.float32))
    opt.zero_grad()
    ((model(x) - y) ** 2).mean().backward()
    opt.step()
last = hvd.join()
hvd.broadcast_parameters(model, root_rank=last)
res["last_opt"] = last
for k, v in model.state_dict().items():
    res["mlp." + k] = v

# The two-level allreduce over nodes of 2 ranks, and its refusals.
g = np.random.RandomState(300 + r)
xf = torch.from_numpy(g.randn(%(n)d).astype(np.float32))
xi = torch.from_numpy(g.randint(-50, 50, %(n)d).astype(np.int32))
for op in ("SUM", "AVERAGE"):
    rop = getattr(hvd.ReduceOp, op)
    res["hier_f32_" + op] = hvd.hierarchical_allreduce(xf, op=rop,
                                                       local_size=2)
    res["hier_i32_" + op] = hvd.hierarchical_allreduce(xi, op=rop,
                                                       local_size=2)
res["flat_f32"] = hvd.allreduce(xf, op=hvd.Sum)
for bad, kw in (("max", dict(op=hvd.Max, local_size=2)),
                ("size3", dict(local_size=3))):
    try:
        hvd.hierarchical_allreduce(xf, **kw)
        res["raises_" + bad] = ""
    except ValueError as e:
        res["raises_" + bad] = str(e)
np.savez(sys.argv[1], **{k: np.asarray(v.detach().numpy()
                                       if torch.is_tensor(v) else v)
                         for k, v in res.items()})
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def world_b(tmp_path_factory):
    init = {k: v.tolist() for k, v in _mlp_init().items()}
    script = WORLD_B % {"steps": STEPS, "opt_steps": OPT_STEPS, "lr": LR,
                        "init": init, "n": HIER_LEN}
    return run_gloo_world(script, tmp_path_factory.mktemp("join4"), size=N,
                          timeout=240)


def test_staggered_join_sums_exactly_the_live_ranks(world_b):
    for r in range(N):
        want = [float(sum(q + 1 for q in range(N) if STEPS[q] > s))
                for s in range(STEPS[r])]
        assert list(world_b[r]["sums"]) == want
        assert int(world_b[r]["last_stagger"]) == 0  # the most steps
    assert list(world_b[2]["ps_sums"]) == [4.0, 4.0]
    assert {int(world_b[r]["last_ps"]) for r in range(N)} == {2}


def _model_grads(p, x, y):
    """Float64 gradients of mean((fc2(tanh(fc1(x))) - y)²)."""
    h = np.tanh(x @ p["fc1.weight"].T + p["fc1.bias"])
    out = h @ p["fc2.weight"].T + p["fc2.bias"]
    d_out = 2.0 * (out - y) / out.size
    d_h = (d_out @ p["fc2.weight"]) * (1.0 - h ** 2)
    return {"fc2.weight": d_out.T @ h, "fc2.bias": d_out.sum(0),
            "fc1.weight": d_h.T @ x, "fc1.bias": d_h.sum(0)}


def test_distributed_optimizer_over_uneven_data_matches_numpy(world_b):
    p = {k: v.astype(np.float64) for k, v in _mlp_init().items()}
    for s in range(max(OPT_STEPS.values())):
        total = {k: np.zeros_like(v) for k, v in p.items()}
        for r in range(N):
            if OPT_STEPS[r] > s:  # joined ranks add zeros
                x, y = (a.astype(np.float64) for a in _batch(r, s))
                for k, g in _model_grads(p, x, y).items():
                    total[k] += g
        p = {k: v - LR * total[k] / N for k, v in p.items()}  # Average
    assert {int(world_b[r]["last_opt"]) for r in range(N)} == {3}
    for k, want in p.items():
        for r in range(N):
            np.testing.assert_array_equal(world_b[r]["mlp." + k],
                                          world_b[0]["mlp." + k])
        np.testing.assert_allclose(world_b[0]["mlp." + k], want,
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def jax4():
    import horovod_tpu as hvd
    hvd.shutdown()
    old = os.environ.get("HVD_TPU_EMULATE_RANKS")
    os.environ["HVD_TPU_EMULATE_RANKS"] = str(N)
    try:
        hvd.init()
        assert hvd.size() == N
        yield hvd
    finally:
        hvd.shutdown()
        if old is None:
            os.environ.pop("HVD_TPU_EMULATE_RANKS", None)
        else:
            os.environ["HVD_TPU_EMULATE_RANKS"] = old


@pytest.mark.parametrize("op", ["SUM", "AVERAGE"])
def test_hierarchical_allreduce_matches_jax(world_b, jax4, op):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.ops import collective_ops as jc
    hvd = jax4
    rop = getattr(jc.ReduceOp, op)
    for kind, idx in (("f32", 0), ("i32", 1)):
        stack = jnp.asarray(np.stack([_hier_data(r)[idx] for r in range(N)]))
        want = np.asarray(jax.jit(jax.shard_map(
            lambda x: jc.hierarchical_allreduce(
                x[0], rop, axis_name="hvd", local_size=2)[None],
            mesh=hvd.mesh(), in_specs=P("hvd"), out_specs=P("hvd")))(stack))
        for r in range(N):
            got = world_b[r][f"hier_{kind}_{op}"]
            assert got.dtype == want.dtype and got.shape == (HIER_LEN,)
            if kind == "i32":
                np.testing.assert_array_equal(got, want[r])
            else:
                np.testing.assert_allclose(got, want[r], rtol=1e-6,
                                           atol=1e-6)
    np.testing.assert_allclose(world_b[0]["hier_f32_SUM"],
                               world_b[0]["flat_f32"], rtol=1e-6, atol=1e-6)


def test_hierarchical_allreduce_refusals_match_jax(world_b, jax4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.ops import collective_ops as jc
    x = jnp.zeros((N, HIER_LEN), jnp.float32)
    for bad, kw in (("max", dict(op=jc.ReduceOp.MAX, local_size=2)),
                    ("size3", dict(local_size=3))):
        with pytest.raises(ValueError) as e:
            jax.jit(jax.shard_map(
                lambda t: jc.hierarchical_allreduce(t[0], axis_name="hvd",
                                                    **kw)[None],
                mesh=jax4.mesh(), in_specs=P("hvd"),
                out_specs=P("hvd")))(x)
        for r in range(N):
            assert str(world_b[r]["raises_" + bad]) == str(e.value)
