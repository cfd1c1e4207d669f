"""The port's ``DistributedOptimizer`` in a real 2-process gloo world
against the JAX package's ``DistributedOptimizer`` under
``hvd.parallel.shard_step`` on the emulated 8-rank world.

Both train the same tiny BERT (dense attention, f32) from the same
weights (flax parameters drawn with numpy, converted with
``params_from_jax``) with ``backward_passes_per_step=2`` for 4 passes,
once with AdamW and once with SGD-momentum.  Emulated JAX rank r gets
the batch of port rank r mod 2, so the 8-rank average equals the 2-rank
one.  After 4 passes the parameters agree within rtol 2e-4 / atol 2e-6
(the two frameworks sum in other orders; Adam divides by the root of
the second moment), every port rank holds the same bits, and between
boundaries neither the parameters nor the optimizer state move.  The
same world checks the options (Sum, predivide, groups, fp16
compression) and ``broadcast_optimizer_state`` against closed forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

from horovod_tpu.models import transformer as jt
from test_torch_collectives import run_gloo_world

B, S, PASSES = 2, 16, 4
JCFG = jt.TransformerConfig(vocab_size=61, num_layers=2, num_heads=2,
                            d_model=32, d_ff=64, max_len=S, causal=False,
                            dtype=jnp.float32, scan_layers=False)

WORKER = '''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import Transformer, TransformerConfig, lm_loss

out_path, weights = sys.argv[1], sys.argv[2]
torch.set_num_threads(1)
hvd.init(device="cpu")
r = hvd.rank()
cfg = TransformerConfig(vocab_size=61, num_layers=2, num_heads=2, d_model=32,
                        d_ff=64, max_len=%(S)d, causal=False,
                        dtype=torch.float32)
state = {k: torch.from_numpy(v) for k, v in np.load(weights).items()}
res = {}


def batch(p):
    g = np.random.RandomState(1000 * p + r)
    tokens = g.randint(0, 61, (%(B)d, %(S)d))
    mask = (g.rand(%(B)d, %(S)d) < 0.3).astype(np.float32)
    inputs = np.where(mask > 0, 3, tokens)
    return (torch.from_numpy(inputs), torch.from_numpy(tokens),
            torch.from_numpy(mask))


for name in ("adamw", "sgd"):
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(state)
    inner = (torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=1e-4)
             if name == "adamw" else
             torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    opt = hvd.DistributedOptimizer(inner, backward_passes_per_step=2,
                                   named_parameters=model.named_parameters())
    for p in range(%(PASSES)d):
        before = [t.detach().clone() for t in model.parameters()]
        opt.zero_grad()
        inp, tgt, msk = batch(p)
        lm_loss(model(inp), tgt, msk).backward()
        out = opt.step()
        if p %% 2 == 0:   # not a boundary: nothing moves
            assert out is None
            assert all(torch.equal(a, b)
                       for a, b in zip(before, model.parameters()))
            res[f"{name}_state_len_{p}"] = np.array(len(opt.state))
    for k, v in model.state_dict().items():
        res[f"{name}/{k}"] = v.numpy()

# Options, on a 3-element parameter with rank-dependent gradients
# g_r = (r + 1) * [1, 2, 3] (SGD lr=1, one pass per step).
g = torch.tensor([1.0, 2.0, 3.0]) * (r + 1)
for name, kw in (("sum", dict(op=hvd.Sum)),
                 ("predivide", dict(gradient_predivide_factor=2.0)),
                 ("groups", dict(num_groups=2)),
                 ("fp16", dict(compression=hvd.Compression.fp16))):
    w = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(w, lr=1.0), **kw)
    w[0].grad, w[1].grad = g.clone(), g[:2].clone() * 10
    opt.step()
    res[f"opt_{name}_0"] = w[0].detach().numpy().copy()
    res[f"opt_{name}_1"] = w[1].detach().numpy().copy()

# broadcast_optimizer_state: rank-dependent AdamW state, root 1's wins.
w = torch.nn.Parameter(torch.zeros(4))
adam = torch.optim.AdamW([w], lr=0.01 * (r + 1))
for _ in range(r + 1):
    w.grad = torch.full((4,), float(r + 1))
    adam.step()
hvd.broadcast_optimizer_state(adam, root_rank=1)
st = adam.state[w]
res["bos_exp_avg"] = st["exp_avg"].numpy().copy()
res["bos_step"] = np.array(float(st["step"]))
res["bos_lr"] = np.array(adam.param_groups[0]["lr"])
np.savez(out_path, **res)
hvd.shutdown()
''' % {"S": S, "B": B, "PASSES": PASSES}


def _numpy_params(tree, seed=0):
    rng = np.random.RandomState(seed)
    std = {"scale": 0.1, "bias": 0.1, "embedding": 0.5, "kernel": 0.2}

    def leaf(path, x):
        name = path[-1].key
        return np.asarray(std[name] * rng.randn(*x.shape) + (name == "scale"),
                          np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _batch(p, r):
    g = np.random.RandomState(1000 * p + r)
    tokens = g.randint(0, 61, (B, S))
    mask = (g.rand(B, S) < 0.3).astype(np.float32)
    return np.where(mask > 0, 3, tokens), tokens, mask


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from horovod_tpu_torch.models import params_from_jax
    tmp = tmp_path_factory.mktemp("opt")
    model = jt.Transformer(JCFG)
    tree = model.init(jax.random.PRNGKey(0), jnp.zeros((1, S), jnp.int32))
    params = _numpy_params(jax.device_get(tree["params"]))
    state = {k: v.numpy() for k, v in params_from_jax(params).items()}
    np.savez(tmp / "weights.npz", **state)
    world = run_gloo_world(
        WORKER.replace("sys.argv[2]", repr(str(tmp / "weights.npz"))), tmp)
    return model, params, world


def _jax_train(hvd, model, params, inner):
    opt = hvd.DistributedOptimizer(inner, backward_passes_per_step=2)

    def local_step(p, s, inp, tgt, msk):
        def loss_fn(q):
            return jt.lm_loss(model.apply({"params": q}, inp), tgt, msk)

        grads = jax.grad(loss_fn)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s

    step = hvd.parallel.shard_step(
        local_step, in_specs=(P(), P(), P("hvd"), P("hvd"), P("hvd")),
        out_specs=(P(), P()))
    n = hvd.size()
    state = opt.init(params)
    for p in range(PASSES):
        parts = [_batch(p, r % 2) for r in range(n)]
        inp, tgt, msk = (np.concatenate([x[i] for x in parts])
                         for i in range(3))
        params, state = step(params, state, jnp.asarray(inp),
                             jnp.asarray(tgt), jnp.asarray(msk))
    return jax.device_get(params)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_parameters_after_four_passes_match_jax(setup, hvd8, name):
    from horovod_tpu_torch.models import params_from_jax
    model, params, world = setup
    assert hvd8.size() == 8
    inner = optax.adamw(1e-3, weight_decay=1e-4) if name == "adamw" \
        else optax.sgd(0.1, momentum=0.9)
    want = params_from_jax(_jax_train(hvd8, model, params, inner))
    init = params_from_jax(params)
    moved = 0
    for key, w in want.items():
        got, w = world[0][f"{name}/{key}"], w.numpy()
        if name == "adamw" and key.endswith("attn.qkv.bias"):
            # The key bias shifts every score of a query equally, so its
            # gradient is 0 in exact arithmetic and round-off in either
            # framework; Adam turns round-off into steps of up to lr.
            # Hold it to the 2 updates' reach, the rest to the tolerance.
            np.testing.assert_allclose(got[1], w[1], rtol=0, atol=2 * 2e-3)
            got, w = got[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(got, w, rtol=2e-4, atol=2e-6,
                                   err_msg=key)
        got = world[0][f"{name}/{key}"]
        moved += int(not np.array_equal(got, init[key].numpy()))
        np.testing.assert_array_equal(got, world[1][f"{name}/{key}"])
    assert moved == len(want)
    # Between boundaries the wrapped optimizer holds no state yet / the
    # same state as after the last boundary.
    assert int(world[0][f"{name}_state_len_0"]) == 0
    assert int(world[0][f"{name}_state_len_2"]) == len(want)


def test_options_sum_predivide_groups_compression(setup):
    world = setup[2]
    g = np.array([1.0, 2.0, 3.0])
    mean0, sum0 = 1.5 * g, 3.0 * g
    for r in (0, 1):
        w = world[r]
        np.testing.assert_allclose(w["opt_sum_0"], -sum0)
        np.testing.assert_allclose(w["opt_sum_1"], -sum0[:2] * 10)
        for name in ("predivide", "groups", "fp16"):
            np.testing.assert_allclose(w[f"opt_{name}_0"], -mean0,
                                       err_msg=name)
            np.testing.assert_allclose(w[f"opt_{name}_1"], -mean0[:2] * 10,
                                       err_msg=name)


def test_broadcast_optimizer_state_takes_the_roots_state(setup):
    world = setup[2]
    for r in (0, 1):
        assert float(world[r]["bos_step"]) == 2.0
        assert float(world[r]["bos_lr"]) == pytest.approx(0.02)
        np.testing.assert_array_equal(world[r]["bos_exp_avg"],
                                      world[1]["bos_exp_avg"])


def test_wrapper_refuses_what_is_not_ported():
    """Adasum still refuses; a process set does not: in a gloo world of
    one, a step over the registered set (0,) applies the gradient."""
    import torch
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.process_sets import ProcessSet
    w = torch.nn.Parameter(torch.zeros(2))
    sgd = torch.optim.SGD([w], lr=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        thvd.DistributedOptimizer(sgd, op=thvd.Adasum)
    ps = ProcessSet([0])
    opt = thvd.DistributedOptimizer(sgd, process_set=ps)
    assert opt.process_set is ps
    thvd.shutdown()
    thvd.init(device="cpu", process_sets=[ps])
    try:
        w.grad = torch.tensor([1.0, -2.0])
        opt.step()
        torch.testing.assert_close(w.detach(), torch.tensor([-0.1, 0.2]))
    finally:
        thvd.shutdown()
    with pytest.raises(ValueError, match="predivide"):
        thvd.DistributedOptimizer(sgd, op=thvd.Sum,
                                  gradient_predivide_factor=2.0)
