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
* Each flax-only option of ``SyncBatchNorm`` (``FlaxBatchNorm``: feature
  ``axis`` 1 and (1, 2), ``param_dtype``, both variance forms,
  ``axis_index_groups`` [[0], [1]] and [[0, 1]], a call-time ``mask``,
  bf16 inputs with and without f32 reductions) equals the JAX package's
  ``SyncBatchNorm`` (``flax.linen.BatchNorm`` under ``jax.pmap`` over 2
  CPU devices) on the same inputs: outputs, input and parameter
  gradients, running statistics and the eval output within 2e-4 / 2e-4
  (bf16 inputs 0.1 / 0.05), from one statistics collective per call
  (two for the two-pass variance).  Without the world, the same math
  with ``axis_name=None`` equals ``flax.linen.BatchNorm``.
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
# SyncBatchNorm's flax-only options, each on a [3, 4, 5, 6] input per rank:
# the feature sizes, the input type, a mask or not, and the keywords
# (``param_dtype`` by name).
FLAX = {
    "axis_1": ((4,), "float32", False, {"axis": 1}),
    "axis_1_2": ((4, 5), "float32", False, {"axis": (1, 2)}),
    "param_dtype_bf16": ((6,), "float32", False,
                         {"param_dtype": "bfloat16"}),
    "two_pass_variance": ((6,), "float32", False,
                          {"use_fast_variance": False}),
    "groups_each_rank": ((6,), "float32", False,
                         {"axis_index_groups": [[0], [1]]}),
    "groups_world_two_pass": ((4,), "float32", False,
                              {"axis_index_groups": [[0, 1]], "axis": 1,
                               "use_fast_variance": False}),
    "mask": ((6,), "float32", True, {"use_fast_variance": True,
                                     "axis": -1}),
    "mask_two_pass_axis_1": ((4,), "float32", True,
                             {"axis": 1, "use_fast_variance": False}),
    "bf16_input": ((4,), "bfloat16", False, {"axis": 1}),
    "bf16_no_f32_reductions": ((6,), "bfloat16", True,
                               {"force_float32_reductions": False,
                                "param_dtype": "bfloat16"}),
}
FLAX_SHAPE = (3, 4, 5, 6)

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

for name, (features, dtype, masked, kw) in %(flax)r.items():
    kw = dict(kw)
    if "param_dtype" in kw:
        kw["param_dtype"] = getattr(torch, kw["param_dtype"])
    bn = sbn.SyncBatchNorm(features if len(features) > 1 else features[0],
                           **kw)
    assert type(bn) is sbn.FlaxBatchNorm and bn.axis_name == "hvd"
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(data[f"flax_{name}_scale"]))
        bn.bias.copy_(torch.from_numpy(data[f"flax_{name}_bias"]))
    x = torch.from_numpy(data[f"flax_{name}_x{r}"]).to(
        getattr(torch, dtype)).requires_grad_()
    mask = torch.from_numpy(data[f"flax_{name}_m{r}"]) if masked else None
    n0 = dict(sbn.STATS_ALLREDUCES)
    y = bn(x, use_running_average=False, mask=mask)
    (y.float() * torch.from_numpy(data[f"flax_{name}_c{r}"])).sum().backward()
    res[f"flax_{name}_collectives"] = [
        sbn.STATS_ALLREDUCES[k] - n0[k] for k in ("forward", "backward")]
    res[f"flax_{name}_dtype"] = str(y.dtype).split(".")[-1]
    for key, t in (("y", y), ("x_grad", x.grad), ("scale_grad", bn.scale.grad),
                   ("bias_grad", bn.bias.grad), ("mean", bn.mean),
                   ("var", bn.var),
                   ("eval", bn(x.detach(), use_running_average=True))):
        res[f"flax_{name}_{key}"] = t.detach().float()
np.savez(out_path, **{k: np.asarray(v.detach().numpy() if
                                    isinstance(v, torch.Tensor) else v)
                      for k, v in res.items()})
hvd.shutdown()
''' % {"axes": STATS_AXES, "lr": LR, "momentum": MOMENTUM, "steps": STEPS,
       "flax": FLAX}


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
    for name, (features, _, masked, _) in FLAX.items():
        data[f"flax_{name}_scale"] = (
            1 + 0.5 * rng.randn(*features)).astype(np.float32)
        data[f"flax_{name}_bias"] = rng.randn(*features).astype(np.float32)
        for r in (0, 1):
            data[f"flax_{name}_x{r}"] = (
                rng.randn(*FLAX_SHAPE) * (2 + r) + r).astype(np.float32)
            data[f"flax_{name}_c{r}"] = rng.randn(*FLAX_SHAPE).astype(
                np.float32)
            if masked:
                data[f"flax_{name}_m{r}"] = rng.rand(3, 1, 5, 6) < 0.6
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


# -- SyncBatchNorm's flax-only options (FlaxBatchNorm) ------------------------

def _jax_kwargs(kw):
    kw = dict(kw)
    if "param_dtype" in kw:
        kw["param_dtype"] = jnp.dtype(kw["param_dtype"])
    return kw


def _jax_flax_bn(name, data):
    """The JAX package's SyncBatchNorm with the same keywords under
    ``jax.pmap`` over 2 CPU devices (axis "hvd"): per device the output,
    the gradients of sum(y * c), the new running statistics and the eval
    output on them."""
    import flax.linen as fnn
    from horovod_tpu import sync_batch_norm as jsbn
    features, dtype, masked, kw = FLAX[name]
    bn = jsbn.SyncBatchNorm(**_jax_kwargs(kw))
    assert isinstance(bn, fnn.BatchNorm)
    xs = jnp.stack([data[f"flax_{name}_x{r}"] for r in (0, 1)]).astype(dtype)
    cs = jnp.stack([data[f"flax_{name}_c{r}"] for r in (0, 1)])
    ms = jnp.stack([data[f"flax_{name}_m{r}"] for r in (0, 1)]) \
        if masked else None
    variables = bn.init(jax.random.PRNGKey(0), xs[0],
                        use_running_average=False)
    pdt = variables["params"]["scale"].dtype
    params = {"scale": jnp.asarray(data[f"flax_{name}_scale"], pdt),
              "bias": jnp.asarray(data[f"flax_{name}_bias"], pdt)}

    def per_device(x, c, m=None):
        def loss(x, p):
            y, mut = bn.apply({"params": p,
                               "batch_stats": variables["batch_stats"]}, x,
                              use_running_average=False, mask=m,
                              mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * c), (y, mut["batch_stats"])

        (_, (y, stats)), (gx, gp) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(x, params)
        y_eval = bn.apply({"params": params, "batch_stats": stats}, x,
                          use_running_average=True)
        return {"y": y, "x_grad": gx, "scale_grad": gp["scale"],
                "bias_grad": gp["bias"], "mean": stats["mean"],
                "var": stats["var"], "eval": y_eval}

    args = (xs, cs) + ((ms,) if masked else ())
    out = jax.pmap(per_device, axis_name="hvd",
                   devices=jax.devices()[:2])(*args)
    return jax.device_get(out)


@pytest.mark.parametrize("name", sorted(FLAX))
def test_flax_option_matches_jax_sync_batch_norm(setup, name):
    world, data, _ = setup
    features, dtype, masked, kw = FLAX[name]
    want = _jax_flax_bn(name, data)
    rtol, atol = (2e-4, 2e-4) if dtype == "float32" else (0.1, 0.05)
    fast = kw.get("use_fast_variance", True)
    for r in (0, 1):
        assert world[r][f"flax_{name}_collectives"].tolist() == (
            [1, 1] if fast else [2, 2])
        assert str(world[r][f"flax_{name}_dtype"]) == str(want["y"].dtype)
        for key in ("y", "x_grad", "scale_grad", "bias_grad", "mean", "var",
                    "eval"):
            np.testing.assert_allclose(
                world[r][f"flax_{name}_{key}"],
                np.asarray(want[key][r]).astype(np.float32), rtol=rtol,
                atol=atol, err_msg=f"{name} rank {r} {key}")
    # Each rank's statistics are its group's: [[0], [1]] keeps them apart.
    apart = kw.get("axis_index_groups") == [[0], [1]]
    same = np.array_equal(world[0][f"flax_{name}_mean"],
                          world[1][f"flax_{name}_mean"])
    assert same != apart


@pytest.mark.parametrize("name", ["axis_1_2", "mask_two_pass_axis_1",
                                  "bf16_no_f32_reductions"])
def test_flax_math_without_sync_matches_flax(name):
    """``axis_name=None``: no collective, no world; the module against
    ``flax.linen.BatchNorm`` on one rank's input."""
    import flax.linen as fnn
    import torch
    from horovod_tpu_torch import sync_batch_norm as tsbn
    data = _data()
    features, dtype, masked, kw = FLAX[name]
    tkw = dict(kw)
    if "param_dtype" in tkw:
        tkw["param_dtype"] = getattr(torch, tkw["param_dtype"])
    bn = tsbn.SyncBatchNorm(features, axis_name=None, **tkw)
    jbn = fnn.BatchNorm(**_jax_kwargs(kw))
    x = data[f"flax_{name}_x0"]
    m = data[f"flax_{name}_m0"] if masked else None
    jx = jnp.asarray(x).astype(dtype)
    v = jbn.init(jax.random.PRNGKey(0), jx, use_running_average=False)
    want, mut = jbn.apply(v, jx, use_running_average=False,
                          mask=None if m is None else jnp.asarray(m),
                          mutable=["batch_stats"])
    n0 = dict(tsbn.STATS_ALLREDUCES)
    got = bn(torch.from_numpy(x).to(getattr(torch, dtype)),
             use_running_average=False,
             mask=None if m is None else torch.from_numpy(m))
    assert tsbn.STATS_ALLREDUCES == n0
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    rtol, atol = (2e-4, 2e-4) if dtype == "float32" else (0.1, 0.05)
    for g, w in ((got, want), (bn.mean, mut["batch_stats"]["mean"]),
                 (bn.var, mut["batch_stats"]["var"])):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=rtol, atol=atol)


def test_flax_options_refuse_what_flax_cannot_do():
    """Groups are registered when the module is built, which needs a
    world; a keyword of neither module is a TypeError."""
    import torch
    from horovod_tpu_torch import sync_batch_norm as tsbn
    with pytest.raises(ValueError, match="hvd.init"):
        tsbn.SyncBatchNorm(4, axis_index_groups=[[0]])
    bn = tsbn.SyncBatchNorm(4, axis=1, axis_name=None)
    with pytest.raises(ValueError, match="features"):
        bn(torch.zeros(2, 3, 4), use_running_average=False)
    with pytest.raises(TypeError, match="unexpected"):
        tsbn.SyncBatchNorm(4, axes=1)
