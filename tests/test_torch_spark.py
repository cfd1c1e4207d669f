"""The port's Spark layer (``horovod_tpu_torch/spark/``,
``spark_integration.py``) and ``hvd.run`` against the JAX package's.

* The Store's path layout, its byte and object round trips and
  ``shard_row_groups`` equal JAX's on the same files; ``RowGroupStream``
  yields JAX's batches in JAX's order for the same units, seed and epoch.
* ``_estimator_train_loop`` over the same Parquet units, in this process:
  an f32 MLP whose weights are JAX's flax init converted, SGD against
  ``optax.sgd``, sparse categorical cross-entropy, 3 epochs with
  validation; every epoch's ``loss`` and ``val_loss`` equal JAX's within
  rtol 1e-5 / atol 1e-6, and so do the checkpoint's weights.
* One 2-process gloo world: ``fit`` through ``hvd.run`` (both ranks'
  histories equal, early stopping on both together), ``transform`` and a
  ``save`` / ``load`` round trip.
* One elastic world through ``spark.run_elastic`` on a thread task pool:
  a rank crashes once, the driver relaunches it, and the final world
  forms a gloo world whose allreduce every rank reports; the happy path,
  multi-host slots, a rescheduled task's launch counter and the
  discovery windows as in ``tests/test_spark_elastic.py``.
* ``hvd.run`` ships results through the rendezvous KV, as JAX's does.
* ``import horovod_tpu_torch`` works without pyspark, ray, pandas,
  pyarrow, fsspec and cloudpickle; ``spark_integration.run`` raises
  JAX's error without pyspark.
"""

import functools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.spark import estimator as TEst
from horovod_tpu_torch.spark import elastic as TSE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Serialize with the other subprocess-world files (conftest
# pytest_collection_modifyitems).
pytestmark = pytest.mark.xdist_group("heavy_e2e")

OPTIONAL = ("pyspark", "ray", "pandas", "pyarrow", "fsspec", "cloudpickle")


def _write_parquet(path, X, y, group):
    import pyarrow as pa
    import pyarrow.parquet as pq
    pq.write_table(pa.Table.from_pydict({
        "features": [list(map(float, r)) for r in X],
        "y": [int(v) for v in y]}), str(path), row_group_size=group)
    return str(path)


def _units(path):
    import pyarrow.parquet as pq
    return [(path, g) for g in range(pq.ParquetFile(path).num_row_groups)]


def _toy(n, d, classes, seed):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    y = np.argmax(X @ rng.rand(d, classes), axis=1)
    return X, y


# ---------------------------------------------------------------------------
# Store, sharding and the row-group stream
# ---------------------------------------------------------------------------

def test_store_layout_and_round_trips_match_jax(tmp_path):
    from horovod_tpu.spark import (FilesystemStore as JFS, LocalStore as JLS,
                                   Store as JStore)
    from horovod_tpu_torch.spark import FilesystemStore, LocalStore, Store
    root = str(tmp_path / "store")
    port, jax_ = LocalStore(root), JLS(root)
    for name, args in (("get_train_data_path", ()),
                       ("get_train_data_path", (2,)),
                       ("get_val_data_path", ()),
                       ("get_val_data_path", (3,)),
                       ("get_test_data_path", (1,)),
                       ("get_run_path", ("r1",)),
                       ("get_checkpoint_path", ("r1",)),
                       ("get_logs_path", ("r1",))):
        assert getattr(port, name)(*args) == getattr(jax_, name)(*args)
    assert port.saving_runs() and jax_.saving_runs()
    p = port.get_checkpoint_path("r2")
    assert not port.exists(p)
    obj = {"a": np.arange(4), "b": [1.5, "x"]}
    port.write_obj(p, obj)
    assert port.exists(p) and jax_.exists(p)
    assert port.read_bytes(p) == jax_.read_bytes(p)
    back = jax_.read_obj(p)
    assert np.array_equal(back["a"], obj["a"]) and back["b"] == obj["b"]
    jax_.write_bytes(p + ".raw", b"\x00\x01payload")
    assert port.read_bytes(p + ".raw") == b"\x00\x01payload"
    assert isinstance(Store.create(root), FilesystemStore)
    assert isinstance(JStore.create(root), JFS)
    # Parquet listing of a dataset directory.
    d = port.get_train_data_path()
    X, y = _toy(30, 3, 2, 0)
    port.makedirs(d)
    _write_parquet(os.path.join(d, "part-00000.parquet"), X, y, 7)
    assert port.get_parquet_files(d) == jax_.get_parquet_files(d) != []
    assert port.is_parquet_dataset(d)


def test_shard_row_groups_matches_jax(tmp_path):
    from horovod_tpu.spark import shard_row_groups as jax_shard
    from horovod_tpu_torch.spark import LocalStore, shard_row_groups
    X, y = _toy(170, 4, 3, 1)
    files = [_write_parquet(tmp_path / "a.parquet", X[:100], y[:100], 10),
             _write_parquet(tmp_path / "b.parquet", X[100:], y[100:], 10)]
    fs = LocalStore(str(tmp_path)).fs()
    for size in (1, 2, 3, 5):
        shards = [shard_row_groups(files, r, size) for r in range(size)]
        assert shards == [jax_shard(files, r, size) for r in range(size)]
        assert shards == [shard_row_groups(files, r, size, filesystem=fs)
                          for r in range(size)]
        assert sorted(u for s in shards for u in s) == sorted(
            [(files[0], g) for g in range(10)]
            + [(files[1], g) for g in range(7)])


@pytest.mark.parametrize("batch,shuffle", [(16, True), (16, False),
                                           (50, True), (7, True)])
def test_row_group_stream_matches_jax(tmp_path, batch, shuffle):
    from horovod_tpu.spark.estimator import RowGroupStream as JStream
    X, y = _toy(333, 5, 4, 2)
    path = _write_parquet(tmp_path / "s.parquet", X, y, 23)
    units = _units(path)[1:]  # a rank's shard need not start at group 0
    port = TEst.RowGroupStream(units, ["features"], ["y"], seed=3)
    jax_ = JStream(units, ["features"], ["y"], seed=3)
    assert port.num_rows() == jax_.num_rows()
    for epoch in (0, 1, 4):
        got = list(port.iter_batches(batch, epoch=epoch, shuffle=shuffle))
        want = list(jax_.iter_batches(batch, epoch=epoch, shuffle=shuffle))
        assert len(got) == len(want) == port.num_rows() // batch
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
            assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    assert port.peak_rows_resident == jax_.peak_rows_resident
    for (gx, gy), (wx, wy) in zip(port.iter_groups(), jax_.iter_groups()):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    port.close()
    jax_.close()


def test_row_group_stream_tiny_shard_wraps_as_jax(tmp_path):
    from horovod_tpu.spark.estimator import RowGroupStream as JStream
    path = _write_parquet(tmp_path / "t.parquet",
                          np.array([[1.0], [2.0], [3.0]]), [0, 1, 2], 10)
    got = list(TEst.RowGroupStream([(path, 0)], ["features"], ["y"])
               .iter_batches(8, epoch=0))
    want = list(JStream([(path, 0)], ["features"], ["y"])
                .iter_batches(8, epoch=0))
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0][0], want[0][0])
    assert np.array_equal(got[0][1], want[0][1])
    assert got[0][0].shape == (8, 1)


# ---------------------------------------------------------------------------
# Losses and the training loop, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mse", "mean_absolute_error",
                                  "sparse_categorical_crossentropy"])
def test_named_losses_match_jax(name):
    import jax.numpy as jnp
    from horovod_tpu.spark.estimator import _resolve_loss as jax_resolve
    rng = np.random.RandomState(4)
    if name == "sparse_categorical_crossentropy":
        p = rng.randn(2, 3, 11).astype(np.float32)  # [..., V] logits
        y = rng.randint(0, 11, (2, 3))
    else:
        p = rng.randn(6, 4).astype(np.float32)
        y = rng.randn(6, 4).astype(np.float32)
    got = float(TEst._resolve_loss(name)(torch.as_tensor(p),
                                          torch.as_tensor(y)))
    want = float(jax_resolve(name)(jnp.asarray(p), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="unknown loss"):
        TEst._resolve_loss("nope")


def test_estimator_validates_its_arguments():
    from horovod_tpu_torch.models import create_mlp
    from horovod_tpu_torch.spark import HorovodTpuEstimator
    with pytest.raises(ValueError, match="required"):
        HorovodTpuEstimator()
    kw = dict(model=create_mlp((8, 4), in_features=3, device="cpu"),
              optimizer=functools.partial(torch.optim.SGD, lr=0.1),
              feature_cols=["features"], label_cols=["y"])
    with pytest.raises(ValueError, match="unknown loss"):
        HorovodTpuEstimator(loss="nope", **kw)
    with pytest.raises(ValueError, match="worker_platform"):
        HorovodTpuEstimator(loss="mse", worker_platform="tpu", **kw)
    HorovodTpuEstimator(loss="mse", worker_platform="cuda", **kw)


def test_estimator_train_loop_matches_jax(tmp_path, hvd8):
    """Both packages' ``_estimator_train_loop`` over the same Parquet
    units: JAX's in the emulated world of 8 ranks that conftest sets, the
    port's in a gloo world of one.  JAX's Min / Average / Sum allreduces
    of the loop's scalars leave them as at a world of one (checked
    first), so the histories must agree."""
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.models import create_mlp as jax_mlp
    from horovod_tpu.spark import LocalStore as JLS
    from horovod_tpu.spark.estimator import (
        RowGroupStream as JStream, _estimator_train_loop as jax_loop)
    from horovod_tpu_torch.models import create_mlp
    from horovod_tpu_torch.models.convert import mlp_params_from_jax
    from horovod_tpu_torch.spark import LocalStore

    assert float(hvd8.allreduce(jnp.asarray(9.0), op=hvd8.Min)) == 9.0
    assert float(hvd8.allreduce(jnp.asarray(2.5), op=hvd8.Average)) == 2.5
    s = hvd8.allreduce(jnp.asarray([3.0, 2.0]), op=hvd8.Sum)
    assert float(s[0]) / float(s[1]) == 1.5

    d, C, seed = 16, 4, 5
    X, y = _toy(200, d, C, 0)
    train = _write_parquet(tmp_path / "train.parquet", X[:160], y[:160], 20)
    val = _write_parquet(tmp_path / "val.parquet", X[160:], y[160:], 15)
    base = dict(loss="sparse_categorical_crossentropy",
                feature_cols=["features"], label_cols=["y"], batch_size=16,
                epochs=3, shuffle=True, verbose=0, seed=seed, callbacks=[],
                run_id="parity", val_path=val)

    jcfg = dict(base, model=jax_mlp((32, C)), optimizer=optax.sgd(0.1),
                store=JLS(str(tmp_path / "jax_store")))
    stream = JStream(_units(train), ["features"], ["y"], seed=seed)
    want = jax_loop(jcfg, stream,
                    JStream(_units(val), ["features"], ["y"]),
                    stream.num_rows())

    variables = jax_mlp((32, C)).init(jax.random.PRNGKey(seed),
                                      jnp.asarray(X[:1]))
    model = create_mlp((32, C), in_features=d, device="cpu", seed=None)
    model.load_state_dict(mlp_params_from_jax(variables["params"]))
    tcfg = dict(base, model=model,
                optimizer=functools.partial(torch.optim.SGD, lr=0.1),
                store=LocalStore(str(tmp_path / "port_store")))
    thvd.shutdown()
    thvd.init(device="cpu")
    try:
        stream = TEst.RowGroupStream(_units(train), ["features"], ["y"],
                                     seed=seed)
        got = TEst._estimator_train_loop(
            tcfg, stream,
            TEst.RowGroupStream(_units(val), ["features"], ["y"]),
            stream.num_rows())
    finally:
        thvd.shutdown()
    assert [h["epoch"] for h in got] == [0, 1, 2]
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"epoch", "loss", "val_loss"}
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], rtol=1e-5,
                                   atol=1e-6)
    assert got[-1]["loss"] < got[0]["loss"]
    # Rank 0's checkpoint: the same weights as JAX's.
    ck = tcfg["store"].read_obj(tcfg["store"].get_checkpoint_path("parity"))
    jck = jcfg["store"].read_obj(jcfg["store"].get_checkpoint_path("parity"))
    assert ck["history"] == got and jck["history"] == want
    ref = mlp_params_from_jax(jck["params"]["params"])
    assert set(ck["params"]) == set(ref)
    for k, v in ck["params"].items():
        assert v.device.type == "cpu"
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("device", ["cpu", None])
def test_transform_partition_matches_jax_apply(device):
    """The mapInPandas UDF body predicts each frame from the pickled
    payload alone, on the device the payload names; its outputs are
    JAX's ``model.apply`` on the same weights.  A payload that names no
    device predicts on the executor's card, and raises on an executor
    without one."""
    import jax
    import jax.numpy as jnp
    import pandas as pd
    from horovod_tpu.models import create_mlp as jax_mlp
    from horovod_tpu_torch.models import create_mlp
    from horovod_tpu_torch.models.convert import mlp_params_from_jax
    from horovod_tpu_torch.spark import TpuTransformer

    X0 = np.random.RandomState(0).rand(4, 5).astype(np.float32)
    variables = jax_mlp((6, 3)).init(jax.random.PRNGKey(0),
                                     jnp.asarray(X0[:1]))
    model = create_mlp((6, 3), in_features=5, device="cpu", seed=7)
    model.load_state_dict(mlp_params_from_jax(variables["params"]))
    tf = TpuTransformer(model=model, feature_cols=["features"],
                        label_cols=["y"], device=device)
    frames = [pd.DataFrame({"features": list(X0[:2]), "y": [0, 1]}),
              pd.DataFrame({"features": list(X0[2:]), "y": [2, 0]}),
              pd.DataFrame({"features": [], "y": []})]
    payload = tf._udf_payload()
    if device is None and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            list(TEst._transform_partition(payload, iter(frames)))
        return
    out = list(TEst._transform_partition(payload, iter(frames)))
    assert len(out) == 3 and len(out[2]) == 0
    assert list(out[0].columns) == ["features", "y", "y__output"]
    want = np.asarray(jax_mlp((6, 3)).apply(variables, jnp.asarray(X0)))
    got = np.concatenate([np.stack(list(f["y__output"])) for f in out[:2]])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    pred = tf.predict(X0)
    assert pred.device.type == (device or "cuda")
    np.testing.assert_allclose(pred.cpu().numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_worker_and_transformer_without_a_card_raise():
    """``worker_platform=None`` is the rank's card: a worker without one
    raises, as does a transformer asked to predict on the card."""
    from horovod_tpu_torch.models import create_mlp
    from horovod_tpu_torch.spark import TpuTransformer
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEst._estimator_train_fn({"platform": None})
    assert not thvd.is_initialized()
    model = create_mlp((3,), in_features=2, device="cpu")
    tf = TpuTransformer(model, ["x"], ["y"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.predict(np.zeros((1, 2), np.float32))


# ---------------------------------------------------------------------------
# Process world 1: fit through hvd.run over 2 gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.integration
def test_fit_two_ranks_transform_save_load(tmp_path, monkeypatch):
    """``fit`` over a 2-process gloo world (``hvd.run``), with an
    early-stopping callback whose ``min_delta`` no epoch can meet: both
    ranks stop after epoch 2 with the same history; ``transform`` adds
    ``y__output``; ``save`` / ``load`` predicts the same."""
    import pandas as pd
    from horovod_tpu_torch import runner
    from horovod_tpu_torch.callbacks import EarlyStoppingCallback
    from horovod_tpu_torch.models import create_mlp
    from horovod_tpu_torch.spark import (HorovodTpuEstimator, LocalStore,
                                         TpuTransformer)

    # The launcher writes the store's port into the environment; a value
    # recorded by setenv makes monkeypatch remove it afterwards.
    monkeypatch.setenv("HVD_TPU_COORD_PORT", "")
    monkeypatch.delenv("HVD_TPU_COORD_PORT")
    # One intra-op thread a worker: the suite's other files share the host.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    results = []
    real_run = runner.run

    def spy(*args, **kwargs):
        results.extend(real_run(*args, **kwargs))
        return results

    monkeypatch.setattr(runner, "run", spy)
    X, y = _toy(256, 16, 4, 0)
    df = pd.DataFrame({"features": [list(map(float, r)) for r in X],
                       "y": [int(v) for v in y]})
    store = LocalStore(str(tmp_path / "store"))
    est = HorovodTpuEstimator(
        model=create_mlp((32, 4), in_features=16, device="cpu", seed=1),
        optimizer=functools.partial(torch.optim.Adam, lr=1e-2),
        loss="sparse_categorical_crossentropy",
        feature_cols=["features"], label_cols=["y"], batch_size=16,
        epochs=8, validation=0.2, store=store, num_proc=2, verbose=0,
        callbacks=[EarlyStoppingCallback(monitor="loss", patience=2,
                                         min_delta=1e9)],
        worker_platform="cpu")
    model = est.fit(df)
    assert len(results) == 2 and results[0] == results[1] == est.history
    assert [h["epoch"] for h in est.history] == [0, 1, 2]
    assert all("val_loss" in h and np.isfinite(h["val_loss"])
               for h in est.history)
    assert est.history[-1]["loss"] < est.history[0]["loss"]
    assert model.history == est.history and model.run_id

    assert model.device == "cpu"  # the workers' platform
    out = model.transform(df.head(32))
    pred = np.stack(out["y__output"].to_numpy())
    assert pred.shape == (32, 4) and np.isfinite(pred).all()
    path = str(tmp_path / "model.pkl")
    model.save(path)
    loaded = TpuTransformer.load(path, device="cpu")
    assert loaded.history == est.history
    out2 = loaded.transform(df.head(8))
    assert np.array_equal(np.stack(out2["y__output"].to_numpy()), pred[:8])


# ---------------------------------------------------------------------------
# Process world 2: run_elastic over a thread task pool
# ---------------------------------------------------------------------------

def _thread_pool_factory(hostnames=None, loop=TSE.task_pool_loop):
    """A task pool of threads on fake hostnames (default: one host)."""

    def factory(num_tasks, addr, port):
        threads = []
        for i in range(num_tasks):
            host = (hostnames or ["node0"] * num_tasks)[i]
            t = threading.Thread(target=loop, args=(addr, port, i),
                                 kwargs={"hostname": host}, daemon=True,
                                 name=f"se-task-{i}")
            t.start()
            threads.append(t)

        def join(timeout=30.0):
            for t in threads:
                t.join(timeout)

        return join

    return factory


def _make_report_rank():
    """A closure, shipped by value (this module is not importable in the
    worker)."""

    def fn():
        import os as _os
        return (int(_os.environ["HOROVOD_RANK"]),
                int(_os.environ["HOROVOD_SIZE"]))

    return fn


def _make_crash_once_then_allreduce(path, repo):
    """Rank 0's first incarnation dies abruptly; the final world forms a
    gloo world and reports its allreduce."""

    def fn():
        import os as _os
        import sys as _sys
        if _os.environ["HOROVOD_RANK"] == "0" and not _os.path.exists(path):
            open(path, "w").write("crashed")
            _os._exit(3)
        _sys.path.insert(0, repo)
        import torch as _torch
        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")
        s = hvd.allreduce(_torch.tensor([hvd.rank() + 1.0]), op=hvd.Sum)
        out = (hvd.rank(), hvd.size(),
               int(_os.environ["HVD_TPU_WORLD_VERSION"]), float(s[0]))
        hvd.shutdown()
        return out

    return fn


@pytest.mark.integration
@pytest.mark.parametrize("hosts", [None, ["nodeA", "nodeB"]],
                         ids=["one_host", "two_hosts"])
def test_run_elastic_assigns_slots_as_jax(hosts):
    from horovod_tpu.spark.elastic import (run_elastic as jax_run_elastic,
                                           task_pool_loop as jax_loop)
    kw = dict(num_proc=2, min_num_proc=2, start_timeout=120,
              elastic_timeout=120)
    got = TSE.run_elastic(_make_report_rank(),
                          _task_pool_factory=_thread_pool_factory(hosts),
                          **kw)
    want = jax_run_elastic(_make_report_rank(),
                           _task_pool_factory=_thread_pool_factory(
                               hosts, jax_loop), **kw)
    assert got == want == [(0, 2), (1, 2)]


@pytest.mark.integration
def test_run_elastic_task_failure_then_rejoin(tmp_path, monkeypatch):
    """A crashed incarnation (``os._exit`` inside the function) makes the
    driver reset and relaunch on the surviving task pool; the final
    world is complete, past a reset, and its gloo allreduce sums both
    ranks (spark/runner.py:312 with the elastic retry contract)."""
    # One intra-op thread a worker: the suite's other files share the host.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    marker = str(tmp_path / "crashed_once")
    results = TSE.run_elastic(
        _make_crash_once_then_allreduce(marker, REPO), num_proc=2,
        min_num_proc=2, start_timeout=120, elastic_timeout=120,
        reset_limit=3, _task_pool_factory=_thread_pool_factory())
    assert os.path.exists(marker), "first incarnation never ran"
    assert [r[:2] for r in results] == [(0, 2), (1, 2)]
    versions = {r[2] for r in results}
    assert len(versions) == 1 and max(versions) >= 1, versions
    assert [r[3] for r in results] == [3.0, 3.0]


@pytest.mark.integration
def test_rescheduled_incarnation_resumes_at_driver_counter(tmp_path):
    """A rescheduled task incarnation restarts ``task_pool_loop`` at seq
    0 while the driver's launch counter is ahead and the consumed
    launches' cmd records are gone: the loop reconciles forward through
    ``next/{task}`` and serves the next launch."""
    import cloudpickle
    from horovod_tpu_torch.runner.http_server import (KVStoreClient,
                                                      RendezvousServer)
    server = RendezvousServer()
    port = server.start()
    client = KVStoreClient("127.0.0.1", port)
    out = str(tmp_path / "ran")
    th = None
    try:
        def fn():
            open(out, "w").write("ok")
            return 0

        client.put(TSE._SCOPE_FN, "blob", cloudpickle.dumps((fn, (), {})))
        client.put(TSE._SCOPE_LAUNCH, "next/0", b"3")
        th = threading.Thread(target=TSE.task_pool_loop,
                              args=("127.0.0.1", port, 0), daemon=True,
                              name="se-task-reinc")
        th.start()
        time.sleep(1.5)
        env = {"HOROVOD_GLOO_RENDEZVOUS_ADDR": "127.0.0.1",
               "HOROVOD_GLOO_RENDEZVOUS_PORT": str(port),
               "HVD_TPU_WORLD_VERSION": "1", "HOROVOD_RANK": "0"}
        client.put(TSE._SCOPE_LAUNCH, "cmd/0/3",
                   json.dumps({"env": env}).encode())
        client.put(TSE._SCOPE_LAUNCH, "next/0", b"4")
        deadline = time.time() + 60
        done = None
        while time.time() < deadline and done is None:
            done = client.get(TSE._SCOPE_DONE, "done/0/3")
            time.sleep(0.25)
        assert done is not None, \
            "rescheduled incarnation never served the seq-3 launch"
        assert json.loads(done)["code"] == 0
        assert os.path.exists(out)
    finally:
        client.put(TSE._SCOPE_CTL, "shutdown", b"1")
        if th is not None:
            th.join(timeout=10)
            assert not th.is_alive()
        server.stop()


@pytest.mark.parametrize("reshape", [False, True])
def test_settle_after_a_published_result_races_a_reshape(reshape):
    """A worker thread whose incarnation adopted world 1 and published
    that world's result settles through the driver's lock: its record is
    retired.  When world 2 adopts the record between the publication and
    the thread's exit, the slot is not settled: the thread serves world 2
    with a fresh launch, and the record the driver kept is not retired."""
    from horovod_tpu_torch.elastic.discovery import HostDiscovery
    from horovod_tpu_torch.elastic.driver import ElasticDriver, Worker
    from horovod_tpu_torch.runner.hosts import SlotInfo

    class OneHost(HostDiscovery):
        def find_available_hosts_and_slots(self):
            return {"node0": 1}

    def slot():
        return SlotInfo("node0", 0, 0, 0, 1, 1, 1)

    driver = ElasticDriver(None, OneHost(), 1)
    w = Worker("node0", 0)
    driver._workers[("node0", 0)] = w
    driver._assignments = [slot()]
    driver._world_version = 1  # world 1 kept the record of a world-0 launch

    class KV:
        def get(self, scope, key):
            assert scope == TSE._SCOPE_RESULTS
            if key != "1/0":
                return None
            if reshape:
                with driver._lock:  # world 2 forms and keeps the record
                    driver._world_version = 2
            return b"published"

    settled, new_slot, cur = TSE._settle(driver, KV(), slot(), 0,
                                         w.terminate_event)
    if reshape:
        assert (settled, cur, new_slot) == (False, 2, slot())
        assert not w.retired
    else:
        assert (settled, new_slot, cur) == (True, None, 1)
        assert w.retired


def test_discovery_windows_heartbeats_as_jax():
    from horovod_tpu.spark.elastic import SparkTaskPoolDiscovery as JDisc
    now = time.time()
    recs = {
        "task/0": json.dumps({"host": "a", "ts": now}).encode(),
        "task/1": json.dumps({"host": "a", "ts": now}).encode(),
        "task/2": json.dumps({"host": "b", "ts": now}).encode(),
        "task/3": json.dumps({"host": "b", "ts": now - 999}).encode(),
        "task/4": json.dumps({"host": "c", "ts": now - 5}).encode(),
        "unrelated": b"x",
    }
    for window in (10.0, 1.0):
        port = TSE.SparkTaskPoolDiscovery(lambda: recs, window)
        jax_ = JDisc(lambda: recs, window)
        assert port.alive_tasks() == jax_.alive_tasks()
        assert port.find_available_hosts_and_slots() == \
            jax_.find_available_hosts_and_slots()
        for host, lr in (("a", 0), ("a", 1), ("b", 0), ("b", 1), ("c", 0)):
            assert port.task_for_slot(host, lr) == \
                jax_.task_for_slot(host, lr)
    assert TSE.SparkTaskPoolDiscovery(lambda: recs) \
        .find_available_hosts_and_slots() == {"a": 2, "b": 1, "c": 1}


# ---------------------------------------------------------------------------
# hvd.run, spark.run and the optional packages
# ---------------------------------------------------------------------------

@pytest.mark.integration
def test_run_gathers_results_through_the_kv(monkeypatch):
    """``hvd.run``: per-rank results travel back through the rendezvous
    KV's ``runresults`` scope, ordered by rank (runner/__init__.py:95)."""
    from horovod_tpu_torch import runner
    assert thvd.run is runner.run
    # The launcher writes the store's port into the environment; a value
    # recorded by setenv makes monkeypatch remove it afterwards.
    monkeypatch.setenv("HVD_TPU_COORD_PORT", "")
    monkeypatch.delenv("HVD_TPU_COORD_PORT")
    seen = {}
    real = runner._run_static

    def spy(args, on_rendezvous=None):
        def cap(rdv):
            seen["server"] = rdv
            if on_rendezvous is not None:
                on_rendezvous(rdv)
        return real(args, on_rendezvous=cap)

    monkeypatch.setattr(runner, "_run_static", spy)
    out = runner.run(lambda k: int(os.environ["HOROVOD_RANK"]) * k,
                     args=(10,), np=2)
    assert out == [0, 10]
    assert set(seen["server"].scan_scope("runresults")) == {"0", "1"}
    with pytest.raises(RuntimeError, match="failed with exit code"):
        runner.run(lambda: os._exit(4), np=1)


def test_spark_run_without_pyspark_raises_jax_error(monkeypatch):
    from horovod_tpu import spark_integration as jax_si
    from horovod_tpu_torch import spark_integration
    monkeypatch.setitem(sys.modules, "pyspark", None)
    with pytest.raises(ImportError) as got:
        spark_integration.run(lambda: 0)
    with pytest.raises(ImportError) as want:
        jax_si.run(lambda: 0)
    assert str(got.value) == str(want.value).replace(
        "horovod_tpu.", "horovod_tpu_torch.")
    assert "requires 'pyspark'" in str(got.value)


def test_spark_run_env_injection_mocked(monkeypatch):
    """``spark_integration.run`` with a fake pyspark: barrier tasks get
    the rendezvous env and per-rank results come back ordered, with the
    same variables as JAX's run sets."""
    import types
    from horovod_tpu import spark_integration as jax_si
    from horovod_tpu_torch import spark_integration

    envs = {}

    class Ctx:
        def __init__(self, idx):
            self._idx = idx

        def partitionId(self):
            return self._idx

    class RDD:
        def __init__(self, n):
            self.n = n

        def barrier(self):
            return self

        def mapPartitions(self, fn):
            self._fn = fn
            return self

        def collect(self):
            out, base = [], dict(os.environ)
            for i in range(self.n):
                fake.BarrierTaskContext._current = Ctx(i)
                os.environ.clear()
                os.environ.update(base)
                out.extend(self._fn(iter([i])))
                envs.setdefault(self.tag, {})[i] = {
                    k: v for k, v in os.environ.items()
                    if k.startswith(("HOROVOD_", "HVD_TPU_"))}
            os.environ.clear()
            os.environ.update(base)
            return out

    class SC:
        defaultParallelism = 2
        tag = None

        def parallelize(self, rng, n):
            rdd = RDD(n)
            rdd.tag = SC.tag
            return rdd

    class BTC:
        _current = None

        @classmethod
        def get(cls):
            return cls._current

    fake = types.ModuleType("pyspark")
    fake.SparkContext = types.SimpleNamespace(_active_spark_context=SC())
    fake.BarrierTaskContext = BTC
    monkeypatch.setitem(sys.modules, "pyspark", fake)
    for tag, mod in (("port", spark_integration), ("jax", jax_si)):
        SC.tag = tag
        assert mod.run(lambda t: f"{t}-{os.environ['HOROVOD_RANK']}",
                       args=("r",), num_proc=2) == ["r-0", "r-1"]
    ports = ("HOROVOD_GLOO_RENDEZVOUS_PORT", "HVD_TPU_COORDINATOR")
    for i in range(2):
        got, want = envs["port"][i], envs["jax"][i]
        assert got["HOROVOD_RANK"] == str(i) and got["HOROVOD_SIZE"] == "2"
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k not in ports} == \
            {k: v for k, v in want.items() if k not in ports}
        host, port = got["HVD_TPU_COORDINATOR"].rsplit(":", 1)
        assert int(port) == int(got["HOROVOD_GLOO_RENDEZVOUS_PORT"]) + 1


def test_import_without_the_optional_packages():
    """A fresh interpreter in which pyspark, ray, pandas, pyarrow, fsspec
    and cloudpickle cannot be imported still imports the package and
    every integration module, and builds an estimator."""
    code = (
        "import sys\n"
        f"blocked = {OPTIONAL!r}\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in blocked:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import functools, torch\n"
        "import horovod_tpu_torch as hvd\n"
        "import horovod_tpu_torch.ray, horovod_tpu_torch.ray_elastic\n"
        "import horovod_tpu_torch.runner.nic_probe\n"
        "import horovod_tpu_torch.runner.jsrun_shim\n"
        "from horovod_tpu_torch.models import create_mlp\n"
        "hvd.spark.HorovodTpuEstimator(\n"
        "    model=create_mlp((3,), in_features=2, device='cpu'),\n"
        "    optimizer=functools.partial(torch.optim.SGD, lr=0.1),\n"
        "    loss='mse', feature_cols=['x'], label_cols=['y'])\n"
        "assert callable(hvd.run)\n"
        "try:\n"
        "    hvd.spark.run(lambda: 0)\n"
        "except ImportError as e:\n"
        "    assert 'pyspark' in str(e)\n"
        "else:\n"
        "    raise SystemExit('spark.run ran without pyspark')\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in blocked))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
