"""Spark ML Estimator layer: ``HorovodTpuEstimator.fit(df)`` → trained
``TpuTransformer``.

Port of ``horovod_tpu/spark/estimator.py``, with the names kept.
Reference: horovod/spark/common/estimator.py:25 (HorovodEstimator: fit
materializes the DataFrame to Parquet through a Store, trains inside
horovod.spark.run, returns a Spark ML Transformer holding the model) and
torch/estimator.py (parameter surface).  Plain pyarrow Parquet readers
sharded by row group (``store.shard_row_groups``) stand in for
petastorm; ``RowGroupStream`` is a copy of JAX's.

PyTorch's idiom where JAX's differs:

* ``model`` is an ``nn.Module`` with its weights; it is pickled on the
  CPU, each worker moves it to its device after ``hvd.init()``, and rank
  0's weights reach every rank through ``hvd.broadcast_parameters``
  (JAX re-initialises from ``model.init`` at a seed);
* ``optimizer`` is a factory, ``params -> torch.optim.Optimizer`` (for
  example ``functools.partial(torch.optim.SGD, lr=0.1)``), wrapped in
  ``DistributedOptimizer``: a torch optimizer is bound to its
  parameters, where an optax transformation is not;
* the checkpoint holds the ``state_dict`` on the host, and the
  transformer holds the one module loaded with it;
* ``worker_platform`` is ``"cpu"`` or ``"cuda"``; ``None`` is the rank's
  card by local rank, and a worker without one raises.

The training loop is JAX's: equal step counts by a Min allreduce, the
epoch loss by an Average allreduce, the validation loss as a Sum of
``[loss · rows, rows]``, the fit callbacks through
``callbacks.CallbackList``.

Works with or without pyspark: a pyspark DataFrame is written with
``df.write.parquet`` and trains on Spark barrier tasks
(``spark_integration.run``); a pandas DataFrame (or anything
``pandas.DataFrame(data)`` accepts) is written with pyarrow and trains
through the local launcher (``horovod_tpu_torch.run``).  pandas, pyarrow,
fsspec and cloudpickle are imported where they are used.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Callable, List, Optional, Sequence, Union

from .store import Store, shard_row_groups

WORKER_PLATFORMS = (None, "cpu", "cuda")


def _is_spark_df(df) -> bool:
    mod = type(df).__module__ or ""
    return mod.startswith("pyspark.")


def _mse(p, y):
    import torch
    return torch.mean((p - y) ** 2)


def _mae(p, y):
    import torch
    return torch.mean(torch.abs(p - y))


def _sparse_categorical_crossentropy(p, y):
    """Mean cross-entropy of ``[..., V]`` logits against ``[...]``
    integer labels (optax's ``softmax_cross_entropy_with_integer_labels``
    then ``mean``)."""
    from torch.nn import functional as F
    return F.cross_entropy(p.reshape(-1, p.shape[-1]), y.reshape(-1).long())


def _resolve_loss(loss) -> Callable:
    """Accept a callable(pred, label)->scalar or a named loss
    (keras/estimator.py accepts keras loss names)."""
    if callable(loss):
        return loss
    name = str(loss).lower()
    if name in ("mse", "mean_squared_error"):
        return _mse
    if name in ("mae", "mean_absolute_error"):
        return _mae
    if name in ("sparse_categorical_crossentropy", "softmax_cross_entropy",
                "cross_entropy"):
        return _sparse_categorical_crossentropy
    raise ValueError(f"unknown loss {loss!r}; pass a callable(pred, label)")


def _columns_to_array(table_cols: dict, cols: Sequence[str]):
    """Assemble named columns into one [n, ...] numpy array: scalar columns
    stack to [n, len(cols)]; a single list-valued column keeps its row
    shape [n, k] (the reference's DenseVector feature column analog)."""
    import numpy as np
    arrs = []
    for c in cols:
        v = table_cols[c]
        first = v[0]
        if isinstance(first, (list, tuple, np.ndarray)):
            arrs.append(np.stack([np.asarray(x) for x in v]))
        else:
            arrs.append(np.asarray(v))
    if len(arrs) == 1:
        return arrs[0]
    return np.stack(arrs, axis=-1)


def _to_tensor(a, device):
    """A numpy batch as a tensor on ``device``; float64 becomes float32
    (what ``jnp.asarray`` makes of it in the JAX package)."""
    import numpy as np
    import torch
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


class RowGroupStream:
    """Streams a rank's (file, row_group) units one group at a time —
    the petastorm-reader contract the reference's estimator relies on
    (spark/common/estimator.py:25: bigger-than-memory shards stream from
    Parquet): peak memory is one row group plus a partial batch, never
    the whole shard.  Epoch shuffling is two-level, the standard
    streaming scheme: the row-group ORDER is re-permuted every epoch and
    rows shuffle within each group; successive epochs see different
    batch compositions without ever materializing the shard.

    ``peak_rows_resident`` records the largest row count ever held, so
    tests can assert the bounded-memory contract on shards much larger
    than the budget."""

    # Open-file cache bound: a shard spanning hundreds of Parquet files
    # must not hold one fd per file for the fit's lifetime (the bounded-
    # resource claim covers descriptors too); a few stay open because the
    # per-epoch group shuffle revisits files in mixed order.
    MAX_OPEN_FILES = 4

    def __init__(self, units, feature_cols, label_cols, filesystem=None,
                 seed: int = 0):
        self.units = list(units)
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.filesystem = filesystem
        self.seed = seed
        self._files: dict = {}  # insertion-ordered: LRU eviction
        self.peak_rows_resident = 0

    def _pf(self, f):
        if f in self._files:
            entry = self._files.pop(f)  # re-insert: most-recently-used
            self._files[f] = entry
            return entry[0]
        while len(self._files) >= self.MAX_OPEN_FILES:
            self._close_one(next(iter(self._files)))
        import pyarrow.parquet as pq
        src = self.filesystem.open(f, "rb") \
            if self.filesystem is not None else f
        pf = pq.ParquetFile(src)
        self._files[f] = (pf, src if src is not f else None)
        return pf

    def _close_one(self, f) -> None:
        pf, src = self._files.pop(f)
        for h in (pf, src):
            if h is None:
                continue
            try:
                h.close()
            except Exception:
                pass

    def close(self) -> None:
        """Release every open Parquet handle (idempotent)."""
        for f in list(self._files):
            self._close_one(f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def num_rows(self) -> int:
        """Total rows across the shard, from metadata only (no data read)."""
        return sum(self._pf(f).metadata.row_group(g).num_rows
                   for f, g in self.units)

    def _read_group(self, f, g):
        import numpy as np
        d = self._pf(f).read_row_group(g).to_pydict()
        X = _columns_to_array(d, self.feature_cols)
        Y = _columns_to_array(d, self.label_cols)
        return np.asarray(X), np.asarray(Y)

    def iter_groups(self):
        """(X, Y) per row group — validation evaluates group-wise."""
        for f, g in self.units:
            yield self._read_group(f, g)

    def iter_batches(self, batch: int, epoch: int = 0,
                     shuffle: bool = True):
        """Exactly-``batch``-row arrays (fixed shapes), streamed.
        Yields floor(num_rows / batch) batches, or one wrap-filled batch
        when the shard is smaller than a batch.  The sub-batch tail of
        each group carries into the next group's batches."""
        import numpy as np
        rng = np.random.RandomState(self.seed * 100003 + epoch)
        order = list(self.units)
        if shuffle:
            rng.shuffle(order)
        carryX = carryY = None
        yielded = 0
        for f, g in order:
            X, Y = self._read_group(f, g)
            if shuffle:
                p = rng.permutation(len(X))
                X, Y = X[p], Y[p]
            if carryX is not None and len(carryX):
                X = np.concatenate([carryX, X])
                Y = np.concatenate([carryY, Y])
            self.peak_rows_resident = max(self.peak_rows_resident, len(X))
            i = 0
            while i + batch <= len(X):
                yield X[i:i + batch], Y[i:i + batch]
                yielded += 1
                i += batch
            carryX, carryY = X[i:], Y[i:]
        if yielded == 0 and carryX is not None and len(carryX):
            # Shard smaller than one batch: wrap-fill (fixed shapes).
            reps = -(-batch // len(carryX))
            yield (np.concatenate([carryX] * reps)[:batch],
                   np.concatenate([carryY] * reps)[:batch])


def _estimator_train_fn(cfg: dict) -> List[dict]:
    """Per-rank training body (reference: torch/remote.py:107 RemoteTrainer
    — runs inside every Spark task / launcher worker).  Joins the world on
    ``cfg["platform"]`` (``None``: the rank's card)."""
    import horovod_tpu_torch as hvd

    hvd.init(device=cfg.get("platform"))
    rank, size = hvd.rank(), hvd.size()
    store: Store = cfg["store"]

    import contextlib
    with contextlib.ExitStack() as streams:
        fs = store.fs()
        units = shard_row_groups(store.get_parquet_files(cfg["train_path"]),
                                 rank, size, filesystem=fs)
        stream = streams.enter_context(
            RowGroupStream(units, cfg["feature_cols"], cfg["label_cols"],
                           filesystem=fs, seed=cfg["seed"] + rank))
        total_rows = stream.num_rows()
        if total_rows == 0:
            raise ValueError(
                f"rank {rank} received no parquet row groups; write the "
                f"training data with at least {size} row groups "
                f"(row_group_size small enough) or lower num_proc")
        vstream = None
        if cfg.get("val_path"):
            vunits = shard_row_groups(
                store.get_parquet_files(cfg["val_path"]), rank, size,
                filesystem=fs)
            vstream = streams.enter_context(
                RowGroupStream(vunits, cfg["feature_cols"],
                               cfg["label_cols"], filesystem=fs))
        return _estimator_train_loop(cfg, stream, vstream, total_rows)


def _estimator_train_loop(cfg, stream, vstream, total_rows) -> List[dict]:
    """The epochs of one rank over ``stream`` (and ``vstream``), after
    ``hvd.init()``: trains ``cfg["model"]`` in place on ``hvd.device()``
    and returns the history; rank 0 writes the checkpoint."""
    import torch

    import horovod_tpu_torch as hvd

    rank, device = hvd.rank(), hvd.device()
    store: Store = cfg["store"]
    model, loss_fn = cfg["model"].to(device), _resolve_loss(cfg["loss"])
    batch = cfg["batch_size"]
    # Rank 0's weights reach everyone (BroadcastGlobalVariables idiom).
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(cfg["optimizer"](model.parameters()))

    def scalar(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    # Equal step counts across ranks: every rank must dispatch the same
    # number of gradient allreduces per epoch (the reference equalizes
    # via steps_per_epoch / join; a MIN-allreduce of the local batch
    # count is the static form).
    local_steps = max(total_rows // batch, 1)
    nsteps = int(hvd.allreduce(scalar(float(local_steps)), op=hvd.Min,
                               name="est.steps"))
    from ..callbacks import CallbackList
    cbs = CallbackList(cfg.get("callbacks") or [])
    cbs.on_train_begin()
    history: List[dict] = []
    for epoch in range(cfg["epochs"]):
        cbs.on_epoch_begin(epoch)
        # Streamed batches, two-level shuffle per epoch (RowGroupStream):
        # the shard never materializes.
        batches = stream.iter_batches(batch, epoch=epoch,
                                      shuffle=cfg["shuffle"])
        model.train()
        ep_loss = 0.0
        for _ in range(nsteps):
            xb, yb = next(batches)
            opt.zero_grad()
            loss = loss_fn(model(_to_tensor(xb, device)),
                           _to_tensor(yb, device))
            loss.backward()
            opt.step()
            ep_loss += float(loss.detach())
        entry = {"epoch": epoch, "loss": float(hvd.allreduce(
            scalar(ep_loss / nsteps), op=hvd.Average, name="est.loss"))}
        if cfg.get("val_path"):
            # EVERY rank dispatches this collective even if its shard got
            # no validation row groups; the row-weighted sum handles the
            # raggedness, and over groups equals the full-shard loss for
            # mean-reducing losses.
            vloss_sum, vrows = 0.0, 0.0
            if vstream is not None:
                model.eval()
                with torch.no_grad():
                    for vxb, vyb in vstream.iter_groups():
                        if len(vxb) == 0:
                            continue
                        vloss_sum += float(loss_fn(
                            model(_to_tensor(vxb, device)),
                            _to_tensor(vyb, device))) * len(vxb)
                        vrows += len(vxb)
            agg = hvd.allreduce(scalar([vloss_sum, vrows]), op=hvd.Sum,
                                name="est.val_loss")
            if float(agg[1]) > 0:
                entry["val_loss"] = float(agg[0]) / float(agg[1])
        history.append(entry)
        if cfg["verbose"] and rank == 0:
            print(f"[estimator] epoch {epoch + 1}/{cfg['epochs']}: {entry}")
        # The metrics in ``entry`` are allreduced, so callback decisions
        # (EarlyStoppingCallback) are the same on every rank and every
        # rank leaves the epoch loop together.
        cbs.on_epoch_end(epoch, logs=entry)
        if cbs.stop_training:
            if cfg["verbose"] and rank == 0:
                print(f"[estimator] early stop after epoch {epoch + 1}")
            break
    if rank == 0:
        store.write_obj(store.get_checkpoint_path(cfg["run_id"]), {
            "params": {k: v.detach().to("cpu", copy=True)
                       for k, v in model.state_dict().items()},
            "history": history,
            "feature_cols": cfg["feature_cols"],
            "label_cols": cfg["label_cols"],
        })
    return history


class HorovodTpuEstimator:
    """Estimator with the reference's fit contract
    (spark/common/estimator.py:25; parameter names follow
    keras/estimator.py:98).

    Args:
      model: an ``nn.Module`` holding its initial weights (on the CPU:
        it is pickled to the workers).
      optimizer: a factory ``params -> torch.optim.Optimizer``.
      loss: callable(pred, label) -> scalar, or one of "mse", "mae",
        "sparse_categorical_crossentropy".
      feature_cols / label_cols: DataFrame column names.
      store: a ``Store`` (defaults to a LocalStore in a temp directory).
      validation: fraction in (0, 1) for a random split, or the name of a
        boolean column selecting validation rows (estimator.py semantics).
      num_proc: ranks to train with (Spark tasks or local processes).
      callbacks: fit callbacks (``horovod_tpu_torch.callbacks.Callback``
        objects, cloudpickled to the workers): ``on_epoch_end(epoch,
        logs)`` fires with the rank-averaged metrics entry, and a
        callback setting ``stop_training`` (EarlyStoppingCallback) ends
        the fit on every rank together.
      worker_platform: the workers' device, "cpu" (a gloo world) or
        "cuda"; None is each rank's card by local rank.
    """

    def __init__(self,
                 model=None,
                 optimizer=None,
                 loss=None,
                 feature_cols: Optional[Sequence[str]] = None,
                 label_cols: Optional[Sequence[str]] = None,
                 batch_size: int = 32,
                 epochs: int = 1,
                 validation: Union[None, float, str] = None,
                 store: Optional[Store] = None,
                 num_proc: int = 1,
                 shuffle: bool = True,
                 verbose: int = 1,
                 run_id: Optional[str] = None,
                 random_seed: int = 0,
                 callbacks: Optional[list] = None,
                 worker_platform: Optional[str] = None):
        if model is None or optimizer is None or loss is None:
            raise ValueError("model, optimizer and loss are required")
        if not feature_cols or not label_cols:
            raise ValueError("feature_cols and label_cols are required")
        if worker_platform not in WORKER_PLATFORMS:
            raise ValueError(f"worker_platform must be one of "
                             f"{WORKER_PLATFORMS}, got {worker_platform!r}")
        _resolve_loss(loss)  # validate early
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.batch_size = batch_size
        self.epochs = epochs
        self.validation = validation
        self.store = store
        self.num_proc = num_proc
        self.shuffle = shuffle
        self.verbose = verbose
        self.run_id = run_id
        self.random_seed = random_seed
        self.callbacks = list(callbacks or [])
        self.worker_platform = worker_platform
        self.history: List[dict] = []

    # -- data materialization (spark/common/util.py prepare_data analog) ----

    def _write_parquet(self, df, store: Store):
        """Materialize ``df`` under the store's intermediate paths; returns
        (train_path, val_path or None)."""
        train_path = store.get_train_data_path()
        val_path = store.get_val_data_path()
        if _is_spark_df(df):
            train_df, val_df = self._split_spark(df)
            train_df.write.mode("overwrite").parquet(train_path)
            if val_df is not None:
                val_df.write.mode("overwrite").parquet(val_path)
            return train_path, (val_path if val_df is not None else None)
        return self._write_pandas(df, store, train_path, val_path)

    def _split_spark(self, df):
        if self.validation is None:
            return df, None
        if isinstance(self.validation, str):
            return (df.filter(f"NOT {self.validation}"),
                    df.filter(self.validation))
        frac = float(self.validation)
        train_df, val_df = df.randomSplit([1.0 - frac, frac],
                                          seed=self.random_seed)
        return train_df, val_df

    def _write_pandas(self, df, store: Store, train_path: str,
                      val_path: str):
        import numpy as np
        import pandas as pd
        import pyarrow as pa
        import pyarrow.parquet as pq
        if not isinstance(df, pd.DataFrame):
            df = pd.DataFrame(df)
        if self.validation is None:
            train_df, val_df = df, None
        elif isinstance(self.validation, str):
            mask = df[self.validation].astype(bool)
            train_df = df[~mask].drop(columns=[self.validation])
            val_df = df[mask].drop(columns=[self.validation])
        else:
            rng = np.random.RandomState(self.random_seed)
            mask = rng.rand(len(df)) < float(self.validation)
            train_df, val_df = df[~mask], df[mask]

        def write(frame, path):
            # Enough row groups that every rank gets data
            # (store.shard_row_groups shards by row group).
            rows_per_group = max(1, len(frame) // max(self.num_proc * 4, 1))
            fs = store.fs()
            p = store._strip(path)
            fs.makedirs(p, exist_ok=True)
            pq.write_table(pa.Table.from_pandas(frame.reset_index(drop=True)),
                           f"{p}/part-00000.parquet",
                           row_group_size=rows_per_group,
                           filesystem=fs)

        write(train_df, train_path)
        if val_df is not None and len(val_df):
            write(val_df, val_path)
            return train_path, val_path
        return train_path, None

    # -- fit (estimator.py:25 fit -> Transformer) ---------------------------

    def fit(self, df) -> "TpuTransformer":
        from .store import LocalStore
        store = self.store
        if store is None:
            import tempfile
            store = LocalStore(tempfile.mkdtemp(prefix="hvd_tpu_store_"))
        run_id = self.run_id or \
            f"run_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"
        train_path, val_path = self._write_parquet(df, store)
        cfg = {
            "model": self.model, "optimizer": self.optimizer,
            "loss": self.loss, "feature_cols": self.feature_cols,
            "label_cols": self.label_cols, "batch_size": self.batch_size,
            "epochs": self.epochs, "shuffle": self.shuffle,
            "verbose": self.verbose, "seed": self.random_seed,
            "callbacks": self.callbacks,
            "store": store, "run_id": run_id,
            "train_path": train_path, "val_path": val_path,
            "platform": self.worker_platform,
        }
        try:
            import pyspark
            from pyspark import SparkContext
            has_spark_ctx = SparkContext._active_spark_context is not None
        except ImportError:
            has_spark_ctx = False
        if has_spark_ctx and _is_spark_df(df):
            from .. import spark_integration
            results = spark_integration.run(
                _estimator_train_fn, args=(cfg,), num_proc=self.num_proc)
        else:
            from .. import runner
            results = runner.run(_estimator_train_fn, args=(cfg,),
                                 np=self.num_proc)
        self.history = results[0]
        ckpt = store.read_obj(store.get_checkpoint_path(run_id))
        # The transformer's module holds the checkpoint; the estimator's
        # model stays as given, so the estimator can fit again.
        import copy
        model = copy.deepcopy(self.model)
        model.load_state_dict(ckpt["params"])
        return TpuTransformer(model=model,
                              feature_cols=self.feature_cols,
                              label_cols=self.label_cols,
                              history=ckpt["history"], run_id=run_id,
                              store=store, device=self.worker_platform)


def _append_predictions(transformer, outs, pdf):
    """Predict one pandas frame and append ``<label>__output`` columns —
    the single definition shared by distributed (mapInPandas) and
    in-process transform so the two paths cannot diverge."""
    import numpy as np
    pdf = pdf.copy()
    if len(pdf) == 0:
        # Empty partitions are routine after filters/repartitions; emit
        # the frame with empty output columns, matching schema.
        for c in outs:
            pdf[c] = []
        return pdf
    cols = {c: list(pdf[c]) for c in transformer.feature_cols}
    X = _columns_to_array(cols, transformer.feature_cols)
    pred = transformer.predict(X).float().cpu().numpy()
    if len(outs) == 1:
        pdf[outs[0]] = list(pred) if pred.ndim > 1 else pred
    else:
        for i, c in enumerate(outs):
            pdf[c] = pred[..., i]
    return pdf


def _transform_partition(payload: bytes, frames):
    """Executor-side batch predictor for ``TpuTransformer.transform`` on a
    pyspark DataFrame (the mapInPandas UDF body, factored out so the logic
    is unit-testable without a Spark cluster).  ``payload`` is a
    cloudpickled {model (on the host), feature_cols, label_cols, device};
    yields each incoming pandas frame with ``<label>__output`` columns
    appended.  It predicts on the payload's device: the executor's card
    when it names none (an executor without one raises), the CPU only
    when it names "cpu".
    Reference: HorovodModel.transform's pandas-UDF per-partition
    prediction (spark/torch/estimator.py)."""
    import cloudpickle
    tf = TpuTransformer(**cloudpickle.loads(payload))
    outs = tf.output_cols()
    for pdf in frames:
        yield _append_predictions(tf, outs, pdf)


class TpuTransformer:
    """Trained-model Transformer (spark/common/estimator.py
    HorovodModel.transform analog): adds ``<label>__output`` prediction
    columns.  Accepts a pandas or pyspark DataFrame; pyspark input is
    predicted distributed on the executors via ``mapInPandas`` (the
    reference's pandas-UDF pattern), pandas input on the caller.

    ``model`` is the trained ``nn.Module``: ``predict`` moves it to
    ``device`` (cuda unless named), ``save`` and the UDF payload pickle
    it on the host."""

    def __init__(self, model, feature_cols, label_cols, history=None,
                 run_id=None, store=None, device=None):
        self.model = model
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.history = history or []
        self.run_id = run_id
        self.store = store
        self.device = device

    def output_cols(self) -> List[str]:
        return [f"{c}__output" for c in self.label_cols]

    def predict(self, X):
        """The model's output on ``X`` (a numpy array), a tensor on the
        transformer's device."""
        import torch
        from ..utils.device import resolve_device
        dev = resolve_device(self.device)
        self.model.to(dev).eval()
        with torch.no_grad():
            return self.model(_to_tensor(X, dev))

    def _udf_payload(self) -> bytes:
        import cloudpickle
        return cloudpickle.dumps({
            "model": self.model.to("cpu"),
            "feature_cols": self.feature_cols,
            "label_cols": self.label_cols, "device": self.device})

    def transform(self, df):
        import numpy as np
        if _is_spark_df(df):
            # Distributed inference: each executor partition predicts via
            # _transform_partition (mapInPandas), never funneling rows
            # through the driver.  The output schema extends the input with
            # one column per label; its Spark type is inferred from a
            # one-row driver-side prediction (array column for vector
            # outputs, double for scalars).
            from pyspark.sql.types import (
                ArrayType, DoubleType, StructField, StructType)
            sample = df.limit(1).toPandas()
            if len(sample) == 0:
                # Empty DataFrame: no row to infer the vector-vs-scalar
                # output shape from; default to scalar columns.
                out_type = DoubleType()
            else:
                scols = {c: list(sample[c]) for c in self.feature_cols}
                spred = np.asarray(self.predict(
                    _columns_to_array(scols, self.feature_cols)).cpu())
                out_type = ArrayType(DoubleType()) if spred.ndim > 1 \
                    and len(self.output_cols()) == 1 else DoubleType()
            schema = StructType(list(df.schema.fields) + [
                StructField(c, out_type, True) for c in self.output_cols()])
            payload = self._udf_payload()
            return df.mapInPandas(
                lambda frames: _transform_partition(payload, frames),
                schema=schema)
        import pandas as pd
        pdf = df if isinstance(df, pd.DataFrame) else pd.DataFrame(df)
        return _append_predictions(self, self.output_cols(), pdf)

    # -- persistence (Spark ML write().save analog) -------------------------

    def save(self, path: str) -> None:
        import cloudpickle
        from .store import FilesystemStore
        st = self.store or FilesystemStore(path.rsplit("/", 1)[0] or ".")
        st.write_bytes(path, cloudpickle.dumps({
            "model": self.model.to("cpu"),
            "feature_cols": self.feature_cols,
            "label_cols": self.label_cols, "history": self.history,
        }))

    @staticmethod
    def load(path: str, device=None) -> "TpuTransformer":
        """The transformer ``save`` wrote, predicting on ``device``."""
        import cloudpickle
        from .store import FilesystemStore
        st = FilesystemStore(path.rsplit("/", 1)[0] or ".")
        d = cloudpickle.loads(st.read_bytes(path))
        return TpuTransformer(device=device, **d)
