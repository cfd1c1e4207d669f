"""The port's ResNet path against the JAX package's, on the CPU.

The same inputs, drawn with numpy from seeds, go through the JAX
function and its counterpart in the port (``horovod_tpu_torch``):
the stem, the max pools, ``FusedBatchNorm``, ResNet-50 on converted
weights, a bf16 ResNet, ``MLP`` / ``MnistCNN``, the converter, and the
port's entry points.  Tolerances are the JAX package's own pins:
the stem 1e-5 and the tie-free pool gradient 1e-6 (``tests/test_models.py
:183, :207``), batch norm outputs 5e-6 and statistics 1e-6 (``:281-288``),
ResNet logits, loss and statistics 2e-4 / 2e-4 (``:249``), f32 gradients
2e-3 / 2e-4 (``tests/test_flash.py:115``).  A bf16 step is held
norm-wise to 2**-5 (its gradients as derived in ``PERF.md`` §6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn
from horovod_tpu.models import mlp as jmlp
from horovod_tpu.models import resnet as jr
from horovod_tpu.sync_batch_norm import FusedBatchNorm as JFusedBatchNorm

import horovod_tpu_torch as hvd
from horovod_tpu_torch import sync_batch_norm as tsbn
from horovod_tpu_torch.models import mlp as tmlp
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.models import resnet_params_from_jax

torch.set_num_threads(2)

# The norm-wise bound of a bf16 step against the reference's bf16 step
# (chip_smoke.py's BF16_STEP_BOUND).
BF16_STEP_BOUND = 2**-5


def _nhwc(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


# -- the stem and SAME padding ---------------------------------------------

def test_s2d_stem_matches_jax_and_the_naive_conv():
    x = _nhwc(0, 2, 32, 32, 3)
    stem = jr.SpaceToDepthStem(features=16, dtype=jnp.float32)
    params = jax.device_get(stem.init(jax.random.PRNGKey(1),
                                      jnp.asarray(x)))
    want = stem.apply(params, jnp.asarray(x))
    kernel = _t(params["params"]["kernel"])
    s2d = tr.SpaceToDepthStem(3, 16, dtype=torch.float32)
    naive = tr.NaiveStem(3, 16, dtype=torch.float32)
    for m in (s2d, naive):
        m.kernel.data.copy_(kernel)
        got = m(_t(x))
        assert got.shape == (2, 16, 16, 16)
        _close(got.detach(), want, 1e-5, 1e-5, type(m).__name__)
    with pytest.raises(ValueError, match="even"):
        s2d(torch.zeros(1, 31, 32, 3))


@pytest.mark.parametrize("n,k,s,pads", [
    (224, 7, 2, (2, 3)),    # the naive stem
    (56, 3, 2, (0, 1)),     # every stride-2 3x3 on an even extent
    (112, 3, 2, (0, 1)),    # the max pool
    (56, 1, 2, (0, 0)),     # a stride-2 projection
    (28, 3, 1, (1, 1)),
    (7, 3, 2, (1, 1)),
    (7, 7, 2, (3, 3))])
def test_same_pads_are_xla_split(n, k, s, pads):
    assert tr.same_pads(n, k, s) == pads


@pytest.mark.parametrize("hw,k,s", [(8, 3, 2), (9, 3, 2), (10, 7, 2),
                                    (6, 1, 2), (7, 3, 1)])
def test_conv_same_padding_matches_xla(hw, k, s):
    """Asymmetric SAME at stride 2: the port's conv equals flax's, and
    PyTorch's symmetric ``padding=k // 2`` would not."""
    x = _nhwc(1, 2, hw, hw, 4)
    w = _nhwc(2, k, k, 4, 5)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    w_oihw = _t(w).permute(3, 2, 0, 1)
    got = tr.conv_nhwc(_t(x), w_oihw, s)
    _close(got, want, 1e-5, 1e-5)
    lo, hi = tr.same_pads(hw, k, s)
    if lo != hi:
        sym = torch.nn.functional.conv2d(
            _t(x).permute(0, 3, 1, 2), w_oihw, stride=s,
            padding=k // 2).permute(0, 2, 3, 1)
        assert sym.shape != got.shape or not torch.allclose(sym, got,
                                                            atol=1e-3)


# -- max pools ---------------------------------------------------------------

def _pool_grad_jax(fn, x, g):
    return np.asarray(jax.grad(lambda v: jnp.sum(fn(v) * g))(jnp.asarray(x)))


def _pool_grad_port(fn, x, g):
    xt = _t(x).requires_grad_()
    (fn(xt) * _t(g)).sum().backward()
    return xt.grad.numpy()


def _flax_pool(v):
    return fnn.max_pool(v, (3, 3), strides=(2, 2), padding="SAME")


def test_max_pool_eq_grad_tie_free_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.permutation(2 * 12 * 12 * 3).reshape(2, 12, 12, 3) \
        .astype(np.float32)
    g = rng.randn(2, 6, 6, 3).astype(np.float32)
    _close(tr.max_pool_eq_grad(_t(x)), _flax_pool(jnp.asarray(x)), 0, 0)
    want = _pool_grad_jax(jr.max_pool_eq_grad, x, g)
    _close(_pool_grad_port(tr.max_pool_eq_grad, x, g), want, 1e-6, 1e-6)
    # Without ties the 1/n rule is the naive pool's backward.
    _close(_pool_grad_port(tr.max_pool_3x3s2, x, g), want, 1e-6, 1e-6)


def _post_relu(seed, shape):
    """bn_init -> ReLU output: negative windows are nine tied zeros."""
    x = np.maximum(_nhwc(seed, *shape), 0.0)
    x[:, :4, :4] = 0.0           # whole windows of zeros
    x[:, 6:, 6:] = 1.5           # ties at a positive value
    return x


@pytest.mark.parametrize("case", ["ones", "post_relu"])
def test_max_pool_eq_grad_ties_match_jax_and_keep_the_sum(case):
    x = np.ones((1, 8, 8, 2), np.float32) if case == "ones" \
        else _post_relu(3, (2, 12, 10, 3))
    oh, ow = x.shape[1] // 2, x.shape[2] // 2
    g = np.random.RandomState(4).rand(x.shape[0], oh, ow,
                                      x.shape[3]).astype(np.float32)
    got = _pool_grad_port(tr.max_pool_eq_grad, x, g)
    _close(got, _pool_grad_jax(jr.max_pool_eq_grad, x, g), 1e-6, 1e-6)
    _close(got.sum(), g.sum(), 1e-6, 0)


def test_max_pool_eq_grad_rejects_odd_extent():
    x = torch.ones((1, 7, 8, 1), requires_grad=True)
    with pytest.raises(ValueError, match="even"):
        tr.max_pool_eq_grad(x)


def test_naive_pool_ties_pick_the_element_flax_picks():
    """The naive pool (fast_stem=False) with ties: PyTorch's max_pool2d
    backward and XLA's select_and_scatter each send a window's gradient
    to one maximum, the same one."""
    x = _post_relu(5, (2, 12, 10, 3))
    g = np.random.RandomState(6).rand(2, 6, 5, 3).astype(np.float32)
    _close(tr.max_pool_3x3s2(_t(x)), _flax_pool(jnp.asarray(x)), 0, 0)
    got = _pool_grad_port(tr.max_pool_3x3s2, x, g)
    _close(got, _pool_grad_jax(_flax_pool, x, g), 0, 0)


# -- FusedBatchNorm ------------------------------------------------------------

_BN_DTYPES = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16), "none": (None, None)}


@pytest.mark.parametrize("dtype", list(_BN_DTYPES))
@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_fused_bn_matches_jax(dtype, x_dtype):
    """Train mode (output, new running statistics), then eval mode on
    those statistics: outputs (bf16 ones too: both sides fold in f32 and
    round the same products) within 5e-6, statistics within 1e-6."""
    jdt, tdt = _BN_DTYPES[dtype]
    xdt = (jnp.bfloat16, torch.bfloat16) if x_dtype == "bf16" \
        else (jnp.float32, torch.float32)
    x32 = _nhwc(0, 8, 6, 6, 16) * 2.0 + 0.5
    jx = jnp.asarray(x32).astype(xdt[0])
    tx = _t(x32).to(xdt[1])
    kw = dict(momentum=0.9, epsilon=1e-5)
    jbn = JFusedBatchNorm(dtype=jdt, **kw)
    v = jax.device_get(jbn.init(jax.random.PRNGKey(0), jx,
                                use_running_average=False))
    params = jax.tree.map(lambda a: a + 0.3 * np.random.RandomState(1)
                          .randn(*a.shape).astype(np.float32), v["params"])
    tbn = tsbn.FusedBatchNorm(16, dtype=tdt, **kw)
    tbn.load_state_dict({"scale": _t(params["scale"]),
                         "bias": _t(params["bias"]),
                         "mean": _t(v["batch_stats"]["mean"]),
                         "var": _t(v["batch_stats"]["var"])})
    want, mut = jbn.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, jx,
                          use_running_average=False,
                          mutable=["batch_stats"])
    got = tbn(tx, use_running_average=False)
    want_eval = jbn.apply({"params": params,
                           "batch_stats": mut["batch_stats"]}, jx,
                          use_running_average=True)
    got_eval = tbn(tx, use_running_average=True)
    out_dtype = tdt or torch.promote_types(tx.dtype, torch.float32)
    for g, w in ((got, want), (got_eval, want_eval)):
        assert g.dtype == out_dtype
        assert str(w.dtype) == str(out_dtype).split(".")[-1]
        _close(g.detach().float(), w.astype(jnp.float32), 0, 5e-6)
    _close(tbn.mean, mut["batch_stats"]["mean"], 0, 1e-6)
    _close(tbn.var, mut["batch_stats"]["var"], 0, 1e-6)


def test_fused_bn_takes_use_running_average_once():
    bn = tsbn.FusedBatchNorm(4)
    with pytest.raises(ValueError, match="exactly once"):
        bn(torch.zeros(2, 4))
    with pytest.raises(ValueError, match="exactly once"):
        tsbn.FusedBatchNorm(4, use_running_average=True)(
            torch.zeros(2, 4), use_running_average=True)


def test_sync_batch_norm_routes_and_refuses():
    bn = tsbn.SyncBatchNorm(4, momentum=0.9)
    assert isinstance(bn, tsbn.FusedBatchNorm) and bn.axis_name == "hvd"
    assert tsbn.SyncBatchNorm(4, axis_name=None).axis_name is None
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        tsbn.SyncBatchNorm(4, axis_index_groups=[[0]])
    hvd.shutdown()
    with pytest.raises(ValueError, match="initialized"):
        bn(torch.ones(3, 4), use_running_average=False)


# -- ResNet-50 on converted weights ----------------------------------------------

def _jax_step(model, variables, x, labels):
    """JAX loss, train logits, new batch stats and gradients, then eval
    logits on the original statistics."""
    def loss_fn(p):
        logits, mut = model.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        return loss, (logits, mut["batch_stats"])

    (loss, (logits, stats)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    eval_logits = model.apply(variables, x, train=False)
    return jax.device_get((loss, logits, stats, grads, eval_logits))


def _port_step(model, x, labels):
    eval_logits = model(x, train=False).detach()
    logits = model(x, train=True)
    loss = torch.nn.functional.cross_entropy(logits.float(), labels)
    loss.backward()
    return loss.detach(), logits.detach(), eval_logits


@pytest.mark.parametrize("fast_stem", [False, True])
def test_resnet50_on_converted_weights_matches_jax(fast_stem):
    jm = jr.create_resnet50(num_classes=10, dtype=jnp.float32,
                            fast_stem=fast_stem)
    x = _nhwc(4, 2, 64, 64, 3)
    labels = np.array([3, 7])
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               train=False))
    loss, logits, stats, grads, eval_logits = _jax_step(
        jm, v, jnp.asarray(x), jnp.asarray(labels))
    tm = tr.create_resnet50(num_classes=10, dtype=torch.float32,
                            fast_stem=fast_stem, device="cpu", seed=None)
    tm.load_state_dict(resnet_params_from_jax(v))
    tl, tlogits, teval = _port_step(tm, _t(x), torch.from_numpy(labels))
    _close(teval, eval_logits, 2e-4, 2e-4, "eval logits")
    _close(tlogits, logits, 2e-4, 2e-4, "train logits")
    _close(tl, loss, 2e-4, 2e-4, "loss")
    want_stats = resnet_params_from_jax({"batch_stats": stats})
    buffers = dict(tm.named_buffers())
    assert set(want_stats) == set(buffers)
    for k, w in want_stats.items():
        _close(buffers[k], w, 2e-4, 2e-4, k)
    want_grads = resnet_params_from_jax({"params": grads})
    named = dict(tm.named_parameters())
    assert set(want_grads) == set(named)
    for k, w in want_grads.items():
        _close(named[k].grad, w, 2e-3, 2e-4, k)


def _numpy_variables(variables, seed):
    """Random flax variables: kernels and biases drawn from a seed,
    scales about one, running variances positive."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = path[-1].key
        r = rng.randn(*a.shape).astype(np.float32)
        if name == "kernel":
            return r * np.float32(1.0 / np.sqrt(np.prod(a.shape[:-1])))
        if name in ("scale", "var"):
            return 1.0 + 0.2 * np.abs(r) if name == "var" else 1.0 + 0.2 * r
        return 0.1 * r

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def test_bf16_resnet_step_matches_jax_normwise():
    """bf16 products, f32 statistics and weights.  Logits and loss within
    BF16_STEP_BOUND of JAX's bf16 step, norm-wise.  Each parameter's
    gradient is no further from the f32 step's gradient than JAX's bf16
    gradient is, plus BF16_STEP_BOUND of its norm: the batch norms'
    backward cancels (a bias gradient is a sum of terms of both signs),
    so a bf16 gradient of this network sits 1e-2 to 4e-1 of its norm
    from the f32 one in JAX as in the port, and the two bf16 backwards,
    which round at different places, differ by as much (PERF.md §6)."""
    x = _nhwc(7, 4, 32, 32, 3)
    labels = np.array([1, 2, 3, 4])
    steps = {}
    for dt in (jnp.bfloat16, jnp.float32):
        jm = jr.ResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10,
                       dtype=dt)
        v = _numpy_variables(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                     train=False), 8)
        steps[dt] = _jax_step(jm, v, jnp.asarray(x), jnp.asarray(labels))
    loss, logits, _, grads, _ = steps[jnp.bfloat16]
    tm = tr.ResNet([1, 1], num_classes=10, num_filters=8,
                   dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict(resnet_params_from_jax(v))
    tl, tlogits, _ = _port_step(tm, _t(x), torch.from_numpy(labels))

    def dist(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.linalg.norm(a - b)

    want = np.asarray(logits, np.float32)
    assert dist(tlogits.float(), want) <= BF16_STEP_BOUND * dist(want, 0)
    assert dist(tl, loss) <= BF16_STEP_BOUND * abs(float(loss))
    named = dict(tm.named_parameters())
    g32 = resnet_params_from_jax({"params": steps[jnp.float32][3]})
    for k, w in resnet_params_from_jax({"params": grads}).items():
        assert named[k].grad.dtype == torch.float32
        assert dist(named[k].grad, g32[k]) <= dist(w, g32[k]) \
            + BF16_STEP_BOUND * dist(g32[k], 0), k


# -- MLP / MnistCNN ---------------------------------------------------------

@pytest.mark.parametrize("which", ["mlp", "cnn"])
def test_mlp_and_mnist_cnn_match_jax(which):
    x = _nhwc(9, 3, 28, 28, 1)
    labels = np.array([0, 5, 9])
    if which == "mlp":
        jm, tm = jmlp.create_mlp((32, 10)), tmlp.create_mlp(
            (32, 10), device="cpu", seed=None)
    else:
        jm, tm = jmlp.MnistCNN(), tmlp.MnistCNN()
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        v["params"])
    tm.load_state_dict(resnet_params_from_jax(v))
    tlogits = tm(_t(x))
    tl = torch.nn.functional.cross_entropy(tlogits, torch.from_numpy(labels))
    tl.backward()
    _close(tlogits.detach(), logits, 2e-4, 2e-5)
    named = dict(tm.named_parameters())
    for k, w in resnet_params_from_jax(
            {"params": jax.device_get(grads)}).items():
        _close(named[k].grad, w, 2e-3, 2e-4, k)


# -- the converter -------------------------------------------------------------

def test_converter_maps_every_leaf_once_and_refuses_unknown_names():
    jm = jr.ResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10,
                   dtype=jnp.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)), train=False))
    state = resnet_params_from_jax(v)
    assert len(state) == len(jax.tree_util.tree_leaves(v))
    tm = tr.ResNet([1, 1], num_classes=10, num_filters=8,
                   dtype=torch.float32)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)          # strict: every key, every shape
    conv = v["params"]["BottleneckBlock_1"]["Conv_1"]["kernel"]
    assert torch.equal(state["BottleneckBlock_1.Conv_1.kernel"],
                       _t(conv).permute(3, 2, 0, 1))
    assert state["conv_init.kernel"].shape == (7, 7, 3, 8)
    assert state["Dense_0.kernel"].shape == (64, 10)
    for bad in ({"params": {"Dense_0": {"weight": np.zeros(2)}}},
                {"params": {"Attention_0": {"kernel": np.zeros(2)}}},
                {"cache": {"Dense_0": {"bias": np.zeros(2)}}}):
        with pytest.raises(KeyError):
            resnet_params_from_jax(bad)


def test_migrate_pre_r3_checkpoint_drops_the_stem_bias():
    state = {"conv_init.kernel": torch.ones(1), "conv_init.bias":
             torch.ones(1), "Dense_0.bias": torch.ones(1)}
    assert set(tr.migrate_pre_r3_checkpoint(state)) == {
        "conv_init.kernel", "Dense_0.bias"}


# -- entry points ------------------------------------------------------------

def test_entry_runs_on_the_cpu():
    from horovod_tpu_torch.entry import entry
    forward, (model, x) = entry(device="cpu")
    assert x.shape == (8, 224, 224, 3) and not model.training
    with torch.no_grad():
        logits = forward(model, x)
    assert logits.shape == (8, 1000) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from horovod_tpu_torch.entry import dryrun_step, entry
    from horovod_tpu_torch.examples import synthetic_benchmark as sb
    for call in (entry, dryrun_step, tr.create_resnet50, tmlp.create_mlp,
                 lambda: sb.build(sb.parse_args([]))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("argv,stats_per_step", [
    (["--image-size", "32"], 53),
    (["--image-size", "32", "--no-sync-bn"], 0),
    (["--image-size", "32", "--fast-stem"], 53),
    (["--model", "mlp"], 0)])
def test_synthetic_benchmark_trains_on_the_cpu(argv, stats_per_step):
    """Two steps of ResNet-50 (sync BN: 53 statistics allreduces forward
    and 53 backward per step) or the MLP, in a gloo world of one."""
    from horovod_tpu_torch.examples import synthetic_benchmark as sb
    before = dict(tsbn.STATS_ALLREDUCES)
    try:
        losses, img_s = sb.main(["--device", "cpu", "--batch-size", "2",
                                 "--num-warmup-batches", "1",
                                 "--num-iters", "1"] + argv)
    finally:
        hvd.shutdown()
    assert len(losses) == 2 and np.all(np.isfinite(losses)) and img_s > 0
    assert {k: tsbn.STATS_ALLREDUCES[k] - before[k] for k in before} == {
        "forward": 2 * stats_per_step, "backward": 2 * stats_per_step}


def test_dryrun_step_in_a_world_of_one():
    from horovod_tpu_torch.entry import dryrun_step
    try:
        loss = dryrun_step(device="cpu")
    finally:
        hvd.shutdown()
    assert np.isfinite(loss)
