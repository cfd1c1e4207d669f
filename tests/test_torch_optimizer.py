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
# Per rank gradients of two parameters whose largest magnitudes differ by
# 10**3.4: quantized under one scale, the second would vanish.
QUANT0 = ([1000.0, -500.0], [-500.0, 1000.0])
QUANT1 = ([0.3, -0.7, 0.011], [0.011, -0.7, 0.3])
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


class MaxAbsQuantizer(hvd.compression.Compressor):
    """Each tensor scaled by its own largest magnitude to [-127, 127]."""

    @staticmethod
    def compress(t):
        s = t.abs().max()
        return torch.round(t / s * 127), s

    @staticmethod
    def decompress(t, s):
        return t * s / 127


w = [torch.nn.Parameter(torch.zeros(2)), torch.nn.Parameter(torch.zeros(3))]
opt = hvd.DistributedOptimizer(torch.optim.SGD(w, lr=1.0),
                               compression=MaxAbsQuantizer)
w[0].grad = torch.tensor(%(quant0)r[r])
w[1].grad = torch.tensor(%(quant1)r[r])
opt.step()
res["opt_quant_0"] = w[0].detach().numpy().copy()
res["opt_quant_1"] = w[1].detach().numpy().copy()

# The gradient-tape functions, PartialDistributedOptimizer and the
# callbacks on the MLP (6 -> 8 -> 3).
from types import SimpleNamespace
from horovod_tpu_torch.models.mlp import MLP
mlp_state = {k: torch.from_numpy(v) for k, v in np.load(MLP_WEIGHTS).items()}
xb = torch.from_numpy(np.random.RandomState(40 + r).randn(5, 6)
                      .astype(np.float32))
mlp = MLP(6, (8, 3))
mlp.load_state_dict(mlp_state)
params = dict(mlp.named_parameters())


def mlp_loss(p, x):
    return (torch.func.functional_call(mlp, p, (x,)) ** 2).mean()


value, grads = hvd.value_and_grad(mlp_loss)(params, xb)
res["vg_value"] = value.numpy().copy()
grads2 = hvd.grad(mlp_loss)(params, xb)
lvalue, lgrads = hvd.local_value_and_grad(mlp_loss)(params, xb)
res["lvg_value"] = lvalue.numpy().copy()
for k in params:
    res[f"vg_grad/{k}"] = grads[k].numpy().copy()
    res[f"g_grad/{k}"] = grads2[k].numpy().copy()
    res[f"lvg_grad/{k}"] = lgrads[k].numpy().copy()
    assert params[k].grad is None
part = MLP(6, (8, 3))
part.load_state_dict(mlp_state)
opt = hvd.PartialDistributedOptimizer(
    torch.optim.SGD(part.parameters(), lr=0.1, momentum=0.9),
    local_filter=lambda name, p: name.startswith("Dense_1"),
    named_parameters=part.named_parameters())
for _ in range(2):
    opt.zero_grad()
    (part(xb) ** 2).mean().backward()
    opt.step()
for k, v in part.state_dict().items():
    res[f"partial/{k}"] = v.numpy().copy()

logs = {"loss": 1.5 * (r + 1), "acc": 0.25 * r}
hvd.callbacks.MetricAverageCallback().on_epoch_end(0, logs)
res["metric_loss"], res["metric_acc"] = np.array(logs["loss"]), \
    np.array(logs["acc"])
bmodel = MLP(6, (8, 3))
bmodel.load_state_dict({k: v * (r + 1) for k, v in mlp_state.items()})
badam = torch.optim.AdamW(bmodel.parameters(), lr=1e-3, weight_decay=1e-4)
(bmodel(xb) ** 2).mean().backward()
badam.step()
cbs = hvd.callbacks.CallbackList(
    [hvd.callbacks.BroadcastGlobalVariablesCallback(root_rank=1)])
cbs.on_train_begin(SimpleNamespace(model=bmodel, optimizer=badam))
for k, v in bmodel.named_parameters():
    res[f"bcast/{k}"] = v.detach().numpy().copy()
    res[f"bcast_mu/{k}"] = badam.state[v]["exp_avg"].numpy().copy()
np.savez(out_path, **res)
hvd.shutdown()
''' % {"S": S, "B": B, "PASSES": PASSES, "quant0": QUANT0,
       "quant1": QUANT1}


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
    from horovod_tpu_torch.models import params_from_jax, \
        resnet_params_from_jax
    tmp = tmp_path_factory.mktemp("opt")
    model = jt.Transformer(JCFG)
    tree = model.init(jax.random.PRNGKey(0), jnp.zeros((1, S), jnp.int32))
    params = _numpy_params(jax.device_get(tree["params"]))
    state = {k: v.numpy() for k, v in params_from_jax(params).items()}
    np.savez(tmp / "weights.npz", **state)
    np.savez(tmp / "mlp.npz", **{k: v.numpy() for k, v in
                                 resnet_params_from_jax(
                                     {"params": _mlp_params()}).items()})
    world = run_gloo_world(
        WORKER.replace("sys.argv[2]", repr(str(tmp / "weights.npz")))
        .replace("MLP_WEIGHTS", repr(str(tmp / "mlp.npz"))), tmp)
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
    """Adasum no longer refuses: in a gloo world of one, a step with
    op=Adasum applies the gradient as it is.  A process set does not
    refuse: a step over the registered set (0,) applies the gradient.
    Min is no gradient reduction, and a predivide needs Average."""
    import torch
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.process_sets import ProcessSet
    w = torch.nn.Parameter(torch.zeros(2))
    sgd = torch.optim.SGD([w], lr=0.1)
    ada = thvd.DistributedOptimizer(sgd, op=thvd.Adasum)
    with pytest.raises(ValueError, match="Average, Sum or Adasum"):
        thvd.DistributedOptimizer(sgd, op=thvd.Min)
    thvd.init(device="cpu")
    try:
        w.grad = torch.tensor([1.0, -2.0])
        ada.step()
        torch.testing.assert_close(w.detach(), torch.tensor([-0.1, 0.2]))
    finally:
        thvd.shutdown()
    with torch.no_grad():
        w.zero_()
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


def _jax_mlp():
    from horovod_tpu.models import mlp as jmlp
    return jmlp.create_mlp((8, 3))


def _mlp_params():
    params = _jax_mlp().init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 6)))["params"]
    rng = np.random.RandomState(5)
    return jax.tree_util.tree_map(
        lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32),
        jax.device_get(params))


def _mlp_x(n=8):
    return np.stack([np.random.RandomState(40 + r % 2).randn(5, 6)
                     .astype(np.float32) for r in range(n)])


def _as_port(tree):
    from horovod_tpu_torch.models import resnet_params_from_jax
    return {k: v.numpy() for k, v in resnet_params_from_jax(
        {"params": jax.device_get(tree)}).items()}


def test_custom_compressor_reduces_tensor_by_tensor_as_jax(setup, hvd8):
    """A per-tensor max-abs quantizer: JAX reduces under any compressor
    but the elementwise casts tensor by tensor, so each gradient keeps
    its own scale.  The port's step must give JAX's parameters (packed
    into one bucket, the second gradient would round to 0 under the
    first's scale)."""
    from horovod_tpu.compression import Compressor

    class MaxAbsQuantizer(Compressor):
        @staticmethod
        def compress(t):
            s = jnp.max(jnp.abs(t))
            return jnp.round(t / s * 127), s

        @staticmethod
        def decompress(t, s):
            return t * s / 127

    world = setup[2]
    opt = hvd8.DistributedOptimizer(optax.sgd(1.0),
                                    compression=MaxAbsQuantizer)
    params = [jnp.zeros((8, 2)), jnp.zeros((8, 3))]
    grads = [jnp.asarray([q[r % 2] for r in range(8)], jnp.float32)
             for q in (QUANT0, QUANT1)]
    updates, _ = opt.update(grads, opt.init(params), params)
    for i, u in enumerate(updates):
        for r in (0, 1):
            np.testing.assert_allclose(world[r][f"opt_quant_{i}"],
                                       np.asarray(u)[r], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{i} rank {r}")
    assert np.abs(world[0]["opt_quant_1"]).min() > 0.1


def test_value_and_grad_grad_and_local_value_and_grad_match_jax(setup,
                                                                  hvd8):
    """On the MLP, each rank's loss and local gradients, and the
    gradients averaged over the world, against JAX's functions inside
    shard_map (emulated rank r holds port rank r mod 2's batch)."""
    from jax.sharding import PartitionSpec as P
    world = setup[2]
    model = _jax_mlp()

    def loss(p, x):
        return jnp.mean(model.apply({"params": p}, x) ** 2)

    def body(p, x):
        value, grads = hvd8.value_and_grad(loss)(p, x)
        grads2 = hvd8.grad(loss)(p, x)
        lvalue, lgrads = hvd8.local_value_and_grad(loss)(p, x)
        return (value[None], grads, grads2, lvalue[None],
                jax.tree_util.tree_map(lambda a: a[None], lgrads))

    step = hvd8.parallel.shard_step(
        body, in_specs=(P(), P("hvd")),
        out_specs=(P("hvd"), P(), P(), P("hvd"), P("hvd")))
    value, grads, grads2, lvalue, lgrads = step(
        _mlp_params(), jnp.asarray(_mlp_x().reshape(-1, 6)))
    tol = dict(rtol=2e-5, atol=1e-6)
    for r in (0, 1):
        w = world[r]
        np.testing.assert_allclose(w["vg_value"], np.asarray(value)[r], **tol)
        np.testing.assert_allclose(w["lvg_value"], np.asarray(lvalue)[r],
                                   **tol)
        local = _as_port(jax.tree_util.tree_map(lambda a: a[r], lgrads))
        for key, want in _as_port(grads).items():
            np.testing.assert_allclose(w[f"vg_grad/{key}"], want,
                                       err_msg=key, **tol)
            np.testing.assert_allclose(w[f"g_grad/{key}"], want,
                                       err_msg=key, **tol)
            np.testing.assert_allclose(w[f"lvg_grad/{key}"], local[key],
                                       err_msg=key, **tol)
    assert not np.allclose(world[0]["lvg_grad/Dense_0.kernel"],
                           world[1]["lvg_grad/Dense_0.kernel"])


def test_partial_optimizer_keeps_the_last_layer_local_as_jax(setup, hvd8):
    """Two SGD-momentum steps of ``PartialDistributedOptimizer`` with
    Dense_1 local: JAX's, eager on the per-rank stacks, against each
    port rank; Dense_0 equal on both ranks, Dense_1 not."""
    world = setup[2]
    model = _jax_mlp()
    stk = jax.tree_util.tree_map(lambda p: jnp.stack([p] * 8),
                                 _mlp_params())
    opt = hvd8.PartialDistributedOptimizer(
        optax.sgd(0.1, momentum=0.9),
        local_filter=lambda path, leaf: path[0].key == "Dense_1")
    state = opt.init(stk)
    xs = jnp.asarray(_mlp_x())

    def loss(p, x):
        return jnp.mean(model.apply({"params": p}, x) ** 2)

    for _ in range(2):
        grads = jax.vmap(jax.grad(loss))(stk, xs)
        updates, state = opt.update(grads, state, stk)
        stk = optax.apply_updates(stk, updates)
    for r in (0, 1):
        want = _as_port(jax.tree_util.tree_map(lambda a: a[r], stk))
        for key, w in want.items():
            np.testing.assert_allclose(world[r][f"partial/{key}"], w,
                                       rtol=2e-5, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(world[0]["partial/Dense_0.kernel"],
                                  world[1]["partial/Dense_0.kernel"])
    assert not np.allclose(world[0]["partial/Dense_1.kernel"],
                           world[1]["partial/Dense_1.kernel"])


def test_metric_average_and_broadcast_callbacks_match_jax(setup, hvd8):
    """``MetricAverageCallback`` averages each log over the ranks, and
    ``BroadcastGlobalVariablesCallback`` gives every rank root 1's model
    and AdamW moments: JAX's callbacks on the same values."""
    import types
    world = setup[2]
    logs = {"loss": jnp.asarray([1.5 * (r % 2 + 1) for r in range(8)]),
            "acc": jnp.asarray([0.25 * (r % 2) for r in range(8)])}
    hvd8.callbacks.MetricAverageCallback().on_epoch_end(0, logs)
    for r in (0, 1):
        assert float(world[r]["metric_loss"]) == pytest.approx(logs["loss"])
        assert float(world[r]["metric_acc"]) == pytest.approx(logs["acc"])
    model = _jax_mlp()
    root = jax.tree_util.tree_map(lambda a: a * 2, _mlp_params())
    adam = optax.adamw(1e-3, weight_decay=1e-4)
    x = jnp.asarray(_mlp_x()[1])
    g = jax.grad(lambda p: jnp.mean(model.apply({"params": p}, x) ** 2))(
        root)
    updates, opt_state = adam.update(g, adam.init(root), root)
    root = optax.apply_updates(root, updates)
    state = types.SimpleNamespace(params=root, opt_state=opt_state)
    hvd8.callbacks.BroadcastGlobalVariablesCallback(
        root_rank=1).on_train_begin(state)
    want = _as_port(state.params)
    mu = _as_port(state.opt_state[0].mu)
    # Root 1's AdamW step rounds differently in torch and optax: hold
    # the values to the optimizer tolerance, the ranks to the same bits.
    for key in want:
        for r in (0, 1):
            np.testing.assert_allclose(world[r][f"bcast/{key}"], want[key],
                                       rtol=2e-5, atol=1e-7, err_msg=key)
            np.testing.assert_allclose(world[r][f"bcast_mu/{key}"], mu[key],
                                       rtol=2e-5, atol=1e-9, err_msg=key)
        for name in ("bcast", "bcast_mu"):
            np.testing.assert_array_equal(world[0][f"{name}/{key}"],
                                          world[1][f"{name}/{key}"])


def test_learning_rate_and_early_stopping_callbacks_match_jax(hvd8,
                                                               monkeypatch):
    """Without a world (the slot count stubbed to JAX's 8): the warm-up
    and schedule multipliers epoch by epoch, ``momentum_correction``'s
    warning, and early stopping's decisions, against JAX's callbacks."""
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch import callbacks as tcb
    monkeypatch.setattr(tcb._core, "num_slots", lambda: 8)
    runs = {}
    for name, mod in (("jax", hvd8.callbacks), ("port", tcb)):
        lrs = []
        with pytest.warns(UserWarning, match="momentum_correction"):
            warm = mod.LearningRateWarmupCallback(lrs.append, 0.1,
                                                  warmup_epochs=3)
        sched = mod.LearningRateScheduleCallback(
            lrs.append, 0.1, lambda e: 0.5 ** e, start_epoch=2,
            end_epoch=4)
        cbs = mod.CallbackList([warm, sched])
        stop = mod.EarlyStoppingCallback(monitor="loss", patience=2,
                                         min_delta=0.01)
        decisions = []
        for epoch, loss in enumerate([1.0, 0.9, 0.895, 0.95, 0.85, 0.9,
                                      0.91]):
            cbs.on_epoch_begin(epoch)
            stop.on_epoch_end(epoch, {"loss": loss})
            decisions.append((stop.stop_training, stop.stopped_epoch,
                              stop.best, stop.wait))
        runs[name] = (lrs, decisions)
    assert runs["port"] == runs["jax"]
    assert runs["port"][1][-1][0]      # it stopped
    assert thvd.callbacks is tcb
