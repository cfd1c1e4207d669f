"""Synchronized batch norm of the port in a real 2-process gloo world,
against the JAX package on the whole batch.

One world serves every check: a module fixture starts two worker
processes (``hvd.init(device="cpu")`` from the launcher's environment),
each runs the checks on its half of the data and saves the results.

* ``sync_batch_stats`` over any ``reduction_axes`` equals numpy's
  statistics of the global batch, from exactly one collective, and its
  input gradient equals JAX's gradient of the summed rank losses (the
  backward allreduces the statistics' cotangent).
* Two SGD-momentum steps of a small sync-BN ResNet, each rank holding
  half the batch, equal two steps of JAX's non-sync ResNet on the whole
  batch (loss, parameters and running statistics within 2e-4 / 2e-4,
  the JAX package's ResNet pin): a statistics allreduce without its
  backward would miss the cross-rank gradient terms.  Both ranks end
  bit-identical.
* Sync without ``hvd.init()`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from horovod_tpu.models import resnet as jr
from test_torch_collectives import run_gloo_world
from test_torch_resnet import _numpy_variables

from horovod_tpu_torch.models import resnet_params_from_jax

STATS_SHAPE, STATS_AXES = (3, 4, 5, 6), (0, 2)
LR, MOMENTUM, STEPS = 0.1, 0.9, 2

WORKER = '''
import sys
import numpy as np
import torch
from torch.nn import functional as F
import horovod_tpu_torch as hvd
from horovod_tpu_torch import sync_batch_norm as sbn
from horovod_tpu_torch.models.resnet import ResNet

torch.set_num_threads(1)
out_path = sys.argv[1]
data = dict(np.load(sys.argv[2]))
res = {}
try:
    sbn.SyncBatchNorm(4)(torch.ones(3, 4), use_running_average=False)
    res["raises_uninitialized"] = 0
except ValueError:
    res["raises_uninitialized"] = 1
hvd.init(device="cpu")
r = hvd.rank()
assert hvd.size() == 2 and hvd.gloo_enabled()

x = torch.from_numpy(data[f"stats_x{r}"]).requires_grad_()
n0 = dict(sbn.STATS_ALLREDUCES)
mean, var = sbn.sync_batch_stats(x, reduction_axes=%(axes)r)
res["stats_forward_collectives"] = sbn.STATS_ALLREDUCES["forward"] - n0["forward"]
loss = (mean * torch.from_numpy(data[f"c{r}"])).sum() \\
    + (var * torch.from_numpy(data[f"d{r}"])).sum()
loss.backward()
res["stats_backward_collectives"] = sbn.STATS_ALLREDUCES["backward"] - n0["backward"]
res["mean"], res["var"], res["x_grad"] = mean, var, x.grad
res["mean_default_axes"], res["var_default_axes"] = sbn.sync_batch_stats(x)

model = ResNet([1, 1], num_classes=10, num_filters=8, dtype=torch.float32,
               sync_bn=True)
model.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in data.items()
                       if k.startswith("w.")})
opt = hvd.DistributedOptimizer(torch.optim.SGD(
    model.parameters(), lr=%(lr)r, momentum=%(momentum)r))
half = len(data["labels"]) // 2
xb = torch.from_numpy(data["images"][r * half:(r + 1) * half])
yb = torch.from_numpy(data["labels"][r * half:(r + 1) * half])
for i in range(%(steps)r):
    opt.zero_grad()
    loss = F.cross_entropy(model(xb, train=True), yb)
    loss.backward()
    opt.step()
    res[f"loss{i}"] = hvd.allreduce(loss.detach(), op=hvd.Average)
for k, v in model.state_dict().items():
    res["w." + k] = v
np.savez(out_path, **{k: np.asarray(v.detach().numpy() if
                                    isinstance(v, torch.Tensor) else v)
                      for k, v in res.items()})
hvd.shutdown()
''' % {"axes": STATS_AXES, "lr": LR, "momentum": MOMENTUM, "steps": STEPS}


def _data():
    rng = np.random.RandomState(11)
    data = {f"stats_x{r}": rng.randn(*STATS_SHAPE).astype(np.float32) * 2
            + r for r in (0, 1)}
    stat_shape = tuple(n for i, n in enumerate(STATS_SHAPE)
                       if i not in STATS_AXES)
    for r in (0, 1):
        data[f"c{r}"] = rng.randn(*stat_shape).astype(np.float32)
        data[f"d{r}"] = rng.randn(*stat_shape).astype(np.float32)
    data["images"] = rng.randn(4, 32, 32, 3).astype(np.float32)
    data["labels"] = rng.randint(0, 10, (4,)).astype(np.int64)
    return data


def _jax_model():
    return jr.ResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10,
                     dtype=jnp.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("syncbn")
    data = _data()
    variables = _numpy_variables(_jax_model().init(
        jax.random.PRNGKey(0), jnp.asarray(data["images"]), train=False), 3)
    for k, v in resnet_params_from_jax(variables).items():
        data["w." + k] = v.numpy()
    np.savez(tmp / "data.npz", **data)
    world = run_gloo_world(
        WORKER.replace("sys.argv[2]", repr(str(tmp / "data.npz"))), tmp)
    return world, data, variables


def test_sync_batch_stats_match_the_global_batch(setup):
    world, data, _ = setup
    x = np.concatenate([data["stats_x0"], data["stats_x1"]], axis=0)
    x64 = x.astype(np.float64)
    for key, axes in (("", STATS_AXES), ("_default_axes", (0, 1, 2))):
        for r in (0, 1):
            np.testing.assert_allclose(world[r]["mean" + key],
                                       x64.mean(axis=axes), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(world[r]["var" + key],
                                       x64.var(axis=axes), rtol=1e-5,
                                       atol=1e-6)
    for r in (0, 1):
        assert int(world[r]["stats_forward_collectives"]) == 1
        assert int(world[r]["stats_backward_collectives"]) == 1


def test_sync_batch_stats_gradient_sums_every_ranks_cotangent(setup):
    """Rank r's input gradient is that of the sum of both ranks' losses,
    each a function of the global statistics."""
    world, data, _ = setup
    n = STATS_SHAPE[0]

    def total(x):
        mean = jnp.mean(x, axis=STATS_AXES)
        var = jnp.mean(jnp.square(x), axis=STATS_AXES) - jnp.square(mean)
        return sum(jnp.sum(mean * data[f"c{r}"] + var * data[f"d{r}"])
                   for r in (0, 1))

    x = jnp.concatenate([data["stats_x0"], data["stats_x1"]], axis=0)
    grad = np.asarray(jax.grad(total)(x))
    for r in (0, 1):
        np.testing.assert_allclose(world[r]["x_grad"],
                                   grad[r * n:(r + 1) * n], rtol=2e-4,
                                   atol=2e-5)


def test_two_sync_bn_steps_equal_jax_on_the_whole_batch(setup):
    world, data, variables = setup
    model = _jax_model()
    params, stats = variables["params"], variables["batch_stats"]
    opt = optax.sgd(LR, momentum=MOMENTUM)
    state = opt.init(params)
    images, labels = jnp.asarray(data["images"]), jnp.asarray(data["labels"])

    def loss_fn(p, s):
        logits, mut = model.apply({"params": p, "batch_stats": s}, images,
                                  train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean(), mut["batch_stats"]

    for i in range(STEPS):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for r in (0, 1):
            np.testing.assert_allclose(world[r][f"loss{i}"], float(loss),
                                       rtol=2e-4, atol=2e-4)
    want = resnet_params_from_jax(jax.device_get(
        {"params": params, "batch_stats": stats}))
    for k, w in want.items():
        np.testing.assert_allclose(world[0]["w." + k], w.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=k)


def test_ranks_end_bit_identical(setup):
    world, _, _ = setup
    keys = [k for k in world[0] if k.startswith("w.") or k.startswith("loss")]
    assert len(keys) > 40
    for k in keys:
        np.testing.assert_array_equal(world[0][k], world[1][k], err_msg=k)


def test_sync_without_init_raises(setup):
    world, _, _ = setup
    assert int(world[0]["raises_uninitialized"]) == 1
    assert int(world[1]["raises_uninitialized"]) == 1
