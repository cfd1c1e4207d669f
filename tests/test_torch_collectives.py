"""The port's collectives in a real 2-process gloo world against the JAX
package's eager ops on an emulated 2-rank world, on the same per-rank
numpy data; and the port's fusion planner against the JAX package's
native one.

One world serves every check: a module fixture starts two worker
processes (``torch.distributed`` over gloo, ``hvd.init(device="cpu")``
from the launcher's environment), each runs every op on its rank's data
and saves the results; the tests compare them.  f32 results are exact
against JAX up to the order of a two-term sum (rtol 1e-6); fp16/bf16
compression is held to the wire type's rounding.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OPS = ("AVERAGE", "SUM", "MIN", "MAX", "PRODUCT")

WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import ops
    from horovod_tpu_torch.process_sets import ProcessSet

    out_path = sys.argv[1]
    hvd.init(device="cpu")
    r = hvd.rank()
    assert hvd.size() == 2 and hvd.gloo_enabled()
    x = torch.from_numpy(np.random.RandomState(100 + r).randn(3, 5)
                         .astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(150 + r).randn(7)
                         .astype(np.float32))
    i = torch.from_numpy(np.random.RandomState(200 + r)
                         .randint(-5, 6, (4,)).astype(np.int32))
    res = {}
    x0 = x.clone()
    for op in %(ops)r:
        res[f"allreduce_{op}"] = hvd.allreduce(x, op=getattr(hvd.ReduceOp, op))
    assert torch.equal(x, x0), "allreduce changed its input"
    for op in ("AVERAGE", "SUM"):
        res[f"scaled_{op}"] = hvd.allreduce(
            x, op=getattr(hvd.ReduceOp, op), prescale_factor=0.5,
            postscale_factor=3.0)
        res[f"int_{op}"] = hvd.allreduce(i, op=getattr(hvd.ReduceOp, op))
    g = hvd.grouped_allreduce([x, y], op=hvd.Average)
    res["grouped_0"], res["grouped_1"] = g
    for comp in ("none", "fp16", "bf16"):
        c = getattr(hvd.Compression, comp)
        f = ops._fused_allreduce([x, y, 2 * x], op=hvd.Average,
                                 compression=c, prescale_factor=0.5,
                                 postscale_factor=2.0)
        for j, t in enumerate(f):
            assert t.dtype == torch.float32
            res[f"fused_{comp}_{j}"] = t
    res["bf16_sum"] = hvd.allreduce(x.bfloat16(), op=hvd.Sum).float()
    res["broadcast"] = hvd.broadcast(x, root_rank=1)
    res["broadcast_bool"] = hvd.broadcast(x > 0, root_rank=1)
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.copy_(torch.full((2, 3), float(r)))
        model.bias.copy_(torch.full((2,), 10.0 + r))
    hvd.broadcast_parameters(model, root_rank=1)
    res["bcast_weight"], res["bcast_bias"] = model.weight, model.bias
    state = {"a": x.clone(), "b": [y.clone()]}
    hvd.broadcast_variables(state, root_rank=0)
    res["bcast_state_a"], res["bcast_state_b"] = state["a"], state["b"][0]
    hvd.barrier()
    res["adasum"] = hvd.allreduce(x, op=hvd.Adasum)
    # A subset runs once registered; a rank outside it gets its input.
    try:
        hvd.allreduce(x, process_set=ProcessSet([1]))
        res["raises_unregistered"] = torch.tensor(0)
    except ValueError as e:
        assert "add_process_set" in str(e), e
        res["raises_unregistered"] = torch.tensor(1)
    res["subset"] = hvd.allreduce(x, prescale_factor=2.0,
                                  process_set=hvd.add_process_set([0]))
    np.savez(out_path, **{k: v.detach().numpy() for k, v in res.items()})
    hvd.shutdown()
''' % {"ops": OPS})


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gloo_world(script: str, tmp_path, size: int = 2, timeout=180):
    """Run ``script`` (its argv[1] is an output path) as ``size``
    processes of one gloo world; returns each rank's saved npz."""
    path = tmp_path / "worker.py"
    path.write_text(script)
    port = free_port()
    procs = []
    for r in range(size):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(size),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(size),
                   HVD_TPU_COORDINATOR=f"127.0.0.1:{port}", PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(path), str(tmp_path / f"rank{r}.npz")],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{outs[r]}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(size)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_gloo_world(WORKER, tmp_path_factory.mktemp("gloo"))


@pytest.fixture(scope="module")
def jax2():
    """The JAX package on an emulated 2-rank world (eager ops take and
    return per-rank stacks [2, ...])."""
    import horovod_tpu as hvd
    hvd.shutdown()
    old = os.environ.get("HVD_TPU_EMULATE_RANKS")
    os.environ["HVD_TPU_EMULATE_RANKS"] = "2"
    try:
        hvd.init()
        assert hvd.size() == 2
        yield hvd
    finally:
        hvd.shutdown()
        if old is None:
            os.environ.pop("HVD_TPU_EMULATE_RANKS", None)
        else:
            os.environ["HVD_TPU_EMULATE_RANKS"] = old


def _stack(seed0, fn):
    return np.stack([fn(np.random.RandomState(seed0 + r)) for r in (0, 1)])


def _x():
    return _stack(100, lambda g: g.randn(3, 5).astype(np.float32))


def _y():
    return _stack(150, lambda g: g.randn(7).astype(np.float32))


def _i():
    return _stack(200, lambda g: g.randint(-5, 6, (4,)).astype(np.int32))


def _check(world, key, want, rtol=1e-6, atol=1e-6):
    for r in (0, 1):
        np.testing.assert_allclose(world[r][key], np.asarray(want)[r],
                                   rtol=rtol, atol=atol, err_msg=key)


def test_allreduce_every_op_and_scale_matches_jax(world, jax2):
    import jax.numpy as jnp
    hvd = jax2
    x = jnp.asarray(_x())
    for op in OPS:
        _check(world, f"allreduce_{op}",
               hvd.allreduce(x, op=getattr(hvd.ReduceOp, op)))
    for op in ("AVERAGE", "SUM"):
        rop = getattr(hvd.ReduceOp, op)
        _check(world, f"scaled_{op}",
               hvd.allreduce(x, op=rop, prescale_factor=0.5,
                             postscale_factor=3.0))
        want = hvd.allreduce(jnp.asarray(_i()), op=rop)
        for r in (0, 1):
            assert world[r][f"int_{op}"].dtype == np.int32
            np.testing.assert_array_equal(world[r][f"int_{op}"],
                                          np.asarray(want)[r])
    # Every rank holds the same bits.
    for op in OPS:
        np.testing.assert_array_equal(world[0][f"allreduce_{op}"],
                                      world[1][f"allreduce_{op}"])


def test_grouped_and_fused_with_compression_match_jax(world, jax2):
    """The port packs each bucket into one buffer and compresses it once;
    JAX's grouped op compresses each tensor: a cast is elementwise, so
    both give the same numbers."""
    import jax.numpy as jnp
    hvd = jax2
    x, y = jnp.asarray(_x()), jnp.asarray(_y())
    g = hvd.grouped_allreduce([x, y], op=hvd.Average)
    _check(world, "grouped_0", g[0])
    _check(world, "grouped_1", g[1])
    tol = {"none": 1e-6, "fp16": 2e-3, "bf16": 2e-2}
    for comp in ("none", "fp16", "bf16"):
        want = hvd.grouped_allreduce(
            [x, y, 2 * x], op=hvd.Average, prescale_factor=0.5,
            postscale_factor=2.0,
            compression=getattr(hvd.Compression, comp))
        for j in range(3):
            _check(world, f"fused_{comp}_{j}", want[j], rtol=tol[comp],
                   atol=tol[comp])
    want = hvd.allreduce(x.astype(jnp.bfloat16), op=hvd.Sum)
    _check(world, "bf16_sum", np.asarray(want, np.float32), rtol=1e-2,
           atol=1e-2)


def test_broadcast_and_broadcast_variables(world, jax2):
    import jax.numpy as jnp
    hvd = jax2
    _check(world, "broadcast", hvd.broadcast(jnp.asarray(_x()), root_rank=1))
    x1 = _x()[1]
    for r in (0, 1):
        np.testing.assert_array_equal(world[r]["broadcast_bool"], x1 > 0)
        np.testing.assert_array_equal(world[r]["bcast_weight"],
                                      np.full((2, 3), 1.0, np.float32))
        np.testing.assert_array_equal(world[r]["bcast_bias"],
                                      np.full((2,), 11.0, np.float32))
        np.testing.assert_array_equal(world[r]["bcast_state_a"], _x()[0])
        np.testing.assert_array_equal(world[r]["bcast_state_b"], _y()[0])


def test_unported_ops_raise_naming_the_roadmap(world):
    """Adasum no longer refuses: two ranks combine as the float64 model
    of the pair (acoeff·a + bcoeff·b, JAX's tolerance rtol 1e-4), with
    the same bits on both.  A subset no longer refuses: over (0,), rank 0
    averages its prescaled input alone and rank 1 keeps its input.  A
    subset must be registered first."""
    a, b = _x().astype(np.float64)
    dot = (a * b).sum()
    want = (1 - dot / (2 * (a * a).sum())) * a \
        + (1 - dot / (2 * (b * b).sum())) * b
    np.testing.assert_allclose(world[0]["adasum"], want, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(world[1]["adasum"], world[0]["adasum"])
    for r in (0, 1):
        assert int(world[r]["raises_unregistered"]) == 1
    np.testing.assert_array_equal(world[0]["subset"], 2 * _x()[0])
    np.testing.assert_array_equal(world[1]["subset"], _x()[1])


@pytest.mark.parametrize("seed", range(4))
def test_fusion_planner_matches_the_native_planner(seed):
    from horovod_tpu.csrc import plan_fusion as native
    from horovod_tpu_torch.ops.fusion import plan_fusion
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 40))
    entries = [(f"t{j}", str(rng.choice(["float32", "float16", "bfloat16"])),
                int(rng.choice([4, 64, 1000, 4096, 70000])),
                int(rng.choice([0, 1])), int(rng.choice([0, 0, 1])))
               for j in range(n)]
    for threshold in (0, 4096, 65536, 128 * 1024 * 1024):
        assert plan_fusion(entries, threshold) == native(entries, threshold)


def test_init_needs_a_card_unless_told_and_reads_the_launcher_env(
        monkeypatch):
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import core
    hvd.shutdown()
    with pytest.raises(ValueError, match="init"):
        hvd.rank()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()
    for name in ("HVD_TPU_COORDINATOR", "HOROVOD_GLOO_RENDEZVOUS_ADDR",
                 "HOROVOD_GLOO_RENDEZVOUS_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="HVD_TPU_COORDINATOR"):
        core._store_address()
    monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", "10.0.0.5")
    monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_PORT", "4000")
    assert core._store_address() == "10.0.0.5:4001"   # JAX core.py:103
    monkeypatch.setenv("HVD_TPU_COORDINATOR", "10.0.0.6:5000")
    assert core._store_address() == "10.0.0.6:5000"
    monkeypatch.setenv("HOROVOD_RANK", "3")
    monkeypatch.setenv("HOROVOD_SIZE", "4")
    from horovod_tpu_torch import topology
    topo = topology.detect()
    assert (topo.rank, topo.size, topo.cross_rank, topo.num_slots) == \
        (3, 4, 3, 4)
