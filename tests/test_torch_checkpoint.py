"""The port's checkpoints (``horovod_tpu_torch/checkpoint.py``) and the
state of ``DistributedOptimizer`` they carry.

* A save taken mid-way through a ``backward_passes_per_step=2`` cycle
  resumes the uninterrupted run's losses exactly (atol 0), the
  counterpart of ``tests/test_checkpoint.py:87``: the optimizer's
  ``state_dict`` carries its accumulators and pass count.
* The JAX package's TINY MLP, trained 3 Adam steps and written by its
  ``checkpoint.save_model``, restored with orbax and converted
  (``params_from_jax_checkpoint``), continues 4 steps in the port on
  JAX's continued trajectory (rtol 1e-5 / atol 1e-6); the converted
  parameters are bit-equal, and ``params_to_jax`` gives them back.
* One 2-process gloo world through the port's launcher (``-np 2``):
  rank 0 writes, the ``extra.json`` sidecar is there before the barrier
  releases rank 1, and ``load_model`` gives both ranks rank 0's model
  and optimizer state; then bayes autotune over 4 rounds converges to
  one fusion threshold on both ranks (``tests/test_autotune.py:182``).
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def thvd():
    import horovod_tpu_torch as thvd
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _data():
    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    y = np.random.RandomState(1).randn(16, 4).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _mlp(seed):
    from horovod_tpu_torch.models.mlp import create_mlp
    return create_mlp(features=(16, 4), in_features=8, device="cpu",
                      seed=seed)


def _step(model, opt, x, y) -> float:
    opt.zero_grad()
    loss = ((model(x) - y) ** 2).mean()
    loss.backward()
    opt.step()
    return float(loss.detach())


def test_mid_cycle_save_model_load_model_resumes_exactly(thvd, tmp_path):
    x, y = _data()
    model = _mlp(0)
    opt = thvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-2),
        backward_passes_per_step=2)
    for _ in range(3):
        _step(model, opt, x, y)
    ref = [_step(model, opt, x, y) for _ in range(4)]

    model = _mlp(0)
    opt = thvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-2),
        backward_passes_per_step=2)
    for _ in range(3):
        _step(model, opt, x, y)
    assert opt.state_dict()["hvd_passes"] == 1  # mid-cycle
    path = str(tmp_path / "model_ckpt")
    thvd.checkpoint.save_model(path, model, opt, extra={"epoch": 3})
    fresh = _mlp(1)
    params, opt2, opt_state, extra = thvd.checkpoint.load_model(
        path, fresh, torch.optim.Adam(fresh.parameters(), lr=1e-2),
        backward_passes_per_step=2)
    assert extra == {"epoch": 3}
    for name, t in model.state_dict().items():
        torch.testing.assert_close(params[name], t, rtol=0, atol=0)
        torch.testing.assert_close(fresh.state_dict()[name], t,
                                   rtol=0, atol=0)
    assert opt2._passes == 1 and opt2._acc is not None
    resumed = [_step(fresh, opt2, x, y) for _ in range(4)]
    np.testing.assert_allclose(resumed, ref, rtol=0, atol=0)


def test_optimizer_state_dict_round_trip_carries_the_cycle(thvd):
    x, y = _data()
    model = _mlp(0)
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        backward_passes_per_step=3)
    sd = opt.state_dict()
    assert sd["hvd_acc"] is None and sd["hvd_passes"] == 0
    for _ in range(4):
        _step(model, opt, x, y)
    sd = opt.state_dict()
    assert sd["hvd_passes"] == 1 and len(sd["hvd_acc"]) == 4
    other = _mlp(0)
    opt2 = thvd.DistributedOptimizer(
        torch.optim.SGD(other.parameters(), lr=0.1, momentum=0.9),
        backward_passes_per_step=3)
    opt2.load_state_dict(sd)
    for a, b in zip(opt2._acc, opt._acc):
        assert a is not b
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # A plain optimizer's dict (no hvd_ keys) starts a fresh cycle.
    opt2.load_state_dict(opt.optimizer.state_dict())
    assert opt2._acc is None and opt2._passes == 0


def test_save_restore_roundtrip(thvd, tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3), "step": torch.tensor(7)}
    path = str(tmp_path / "ckpt")
    thvd.checkpoint.save(path, state)
    restored = thvd.checkpoint.restore(path, template=state)
    torch.testing.assert_close(restored["w"],
                               torch.arange(6.0).reshape(2, 3))
    assert int(restored["step"]) == 7
    bare = thvd.checkpoint.restore(path)
    torch.testing.assert_close(bare["w"], state["w"])
    with pytest.raises(FileExistsError):
        thvd.checkpoint.save(path, state, force=False)


def test_load_params_needs_no_init(tmp_path):
    import horovod_tpu_torch as thvd
    thvd.shutdown()
    thvd.init(device="cpu")
    try:
        model = _mlp(0)
        thvd.checkpoint.save_model(str(tmp_path / "m"), model)
    finally:
        thvd.shutdown()
    params = thvd.checkpoint.load_params(str(tmp_path / "m"))
    for name, t in model.state_dict().items():
        torch.testing.assert_close(params[name], t, rtol=0, atol=0)


def test_jax_checkpoint_continues_in_the_port(tmp_path, hvd8):
    """JAX trains 3 Adam steps of its TINY MLP over the emulated 8-rank
    world and writes ``save_model``; orbax restores the tree, the port
    converts and continues 4 steps on JAX's trajectory."""
    import jax
    import jax.numpy as jnp
    import optax
    import orbax.checkpoint as ocp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.models import create_mlp
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.checkpoint import (load_adam_state,
                                              params_from_jax_checkpoint,
                                              params_to_jax)

    model = create_mlp(features=(16, 4))
    x, y = _data()
    X, Y = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    params0 = model.init(jax.random.PRNGKey(0), X[:1])
    opt = hvd8.DistributedOptimizer(optax.adam(1e-2))

    def local_step(p, s, xb, yb):
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean((model.apply(p, xb) - yb) ** 2))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, hvd8.allreduce(
            loss, op=hvd8.Average)

    step = hvd8.parallel.shard_step(
        local_step, in_specs=(P(), P(), P("hvd"), P("hvd")),
        out_specs=(P(), P(), P()))
    p, s = params0, opt.init(params0)
    for _ in range(3):
        p, s, _loss = step(p, s, X, Y)
    path = str(tmp_path / "jax_ckpt")
    hvd8.checkpoint.save_model(path, p, s, extra={"epoch": 3})
    jax_losses = []
    for _ in range(4):
        p2, s, loss = step(p, s, X, Y)
        jax_losses.append(float(loss))
        p = p2

    tree = ocp.PyTreeCheckpointer().restore(os.path.abspath(path))
    conv = params_from_jax_checkpoint(tree)
    saved = jax.tree_util.tree_map(np.asarray, tree["params"]["params"])
    back = params_to_jax(conv["params"])["params"]
    for layer, leaves in saved.items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(
                conv["params"][f"{layer}.{leaf}"].numpy(), value)
            np.testing.assert_array_equal(back[layer][leaf], value)
    assert float(conv["adam"]["Dense_0.kernel"]["step"]) == 3.0

    thvd.shutdown()
    thvd.init(device="cpu")
    try:
        tmodel = _mlp(None)
        tmodel.load_state_dict(conv["params"])
        topt = thvd.DistributedOptimizer(
            torch.optim.Adam(tmodel.parameters(), lr=1e-2))
        load_adam_state(topt, tmodel.named_parameters(), conv["adam"])
        port_losses = [_step(tmodel, topt, x, y) for _ in range(4)]
    finally:
        thvd.shutdown()
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# One 2-process gloo world through the port's launcher
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent('''
    import os
    import sys
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.mlp import create_mlp

    hvd.init(device="cpu")
    r = hvd.rank()
    path = os.path.join(sys.argv[1], "model")
    model = create_mlp(features=(4,), in_features=4, device="cpu", seed=r)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(1.0 if r == 0 else 99.0)
    base = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    opt = hvd.DistributedOptimizer(base)
    opt.zero_grad()
    # Per-rank gradients: the momentum after the step is the average.
    (model(torch.full((2, 4), float(r + 1))).sum()).backward()
    opt.step()
    mom0 = [base.state[p]["momentum_buffer"].clone()
            for p in model.parameters()]
    with torch.no_grad():  # rank 1's model differs from rank 0's again
        for p in model.parameters():
            p.add_(100.0 * r)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    want = hvd.broadcast_object(want, root_rank=0)
    hvd.checkpoint.save_model(path, model, opt, extra={"epoch": 7})
    # rank 0 wrote; the sidecar must be there before the barrier let
    # this rank go, so a coordinated immediate load sees it.
    assert os.path.exists(os.path.join(path, "extra.json"))
    fresh = create_mlp(features=(4,), in_features=4, device="cpu", seed=5)
    base2 = torch.optim.SGD(fresh.parameters(), lr=0.1, momentum=0.9)
    params, opt2, opt_state, extra = hvd.checkpoint.load_model(
        path, fresh, base2)
    assert extra == {"epoch": 7}, f"rank {r} got extra={extra}"
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), (r, k)
    for p, m in zip(fresh.parameters(), mom0):
        assert torch.equal(base2.state[p]["momentum_buffer"], m), r
    print(f"CKPT_OK rank={r}", flush=True)

    # Bayes autotune, 4 rounds: rank 0's GP explores, the other rank
    # fetches each candidate; both converge on rank 0's decision.
    pm = hvd.core._state.param_manager
    assert pm.enabled and pm.search == "bayes"
    params = [torch.nn.Parameter(torch.zeros(64, 64)) for _ in range(6)]
    sgd = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.01))
    seen = []
    steps = 0
    while not pm.converged and steps < 80:
        seen.append(pm.fusion_threshold_bytes)
        for p in params:
            p.grad = torch.ones(64, 64)
        sgd.step()
        steps += 1
    print(f"rank{r} BAYES converged={pm.converged} "
          f"threshold={pm.fusion_threshold_bytes} "
          f"explored={sorted(set(seen))}", flush=True)
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_world")
    script = tmp / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({"HOROVOD_AUTOTUNE": "1",
                "HOROVOD_AUTOTUNE_SEARCH": "bayes",
                "HOROVOD_AUTOTUNE_BAYES_ROUNDS": "4"})
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", sys.executable, str(script), str(tmp)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    return proc


def test_two_process_save_model_load_model(world):
    assert world.returncode == 0, world.stdout[-3000:] + world.stderr[-3000:]
    assert "CKPT_OK rank=0" in world.stdout
    assert "CKPT_OK rank=1" in world.stdout


def test_two_process_bayes_autotune_converges_to_one_threshold(world):
    assert world.returncode == 0, world.stdout[-3000:] + world.stderr[-3000:]
    m = re.findall(r"rank(\d) BAYES converged=(\w+) threshold=(\d+) "
                   r"explored=(\[[0-9, ]*\])", world.stdout)
    assert len(m) == 2, world.stdout
    assert all(c == "True" for _, c, _, _ in m), m
    assert len({t for _, _, t, _ in m}) == 1, m
    # Both ranks explored the same candidates, round by round.
    assert len({e for *_, e in m}) == 1, m
    assert len(json.loads(m[0][3])) >= 2, m
