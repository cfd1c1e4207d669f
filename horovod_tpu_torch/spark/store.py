"""Storage abstraction for the Spark Estimator layer.

Copy of ``horovod_tpu/spark/store.py`` (framework-free).  Reference:
horovod/spark/common/store.py:38-540: ``Store`` manages the
intermediate locations an Estimator run touches (train / validation
Parquet data, checkpoints, logs) behind one path prefix.  One
fsspec-backed implementation covers every scheme fsspec knows
(file://, hdfs://, s3://, gs://...).  Data is plain Parquet written and
read with pyarrow, sharded by row group across ranks.  fsspec and
pyarrow are imported where they are used, so the package imports
without them.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, List, Optional, Tuple


class Store:
    """Abstract run store (spark/common/store.py:38 Store).

    Layout under ``prefix_path``::

        <prefix>/intermediate_train_data/part-*.parquet
        <prefix>/intermediate_val_data/part-*.parquet
        <prefix>/runs/<run_id>/checkpoint.pkl
        <prefix>/runs/<run_id>/logs/
    """

    def __init__(self, prefix_path: str):
        self.prefix_path = prefix_path.rstrip("/")

    # -- construction -------------------------------------------------------

    @staticmethod
    def create(prefix_path: str, **kwargs) -> "Store":
        """Scheme-dispatching factory (store.py Store.create)."""
        return FilesystemStore(prefix_path, **kwargs)

    # -- path layout (get_*_path surface of store.py) -----------------------

    def get_train_data_path(self, idx: Optional[int] = None) -> str:
        sfx = f".{idx}" if idx is not None else ""
        return f"{self.prefix_path}/intermediate_train_data{sfx}"

    def get_val_data_path(self, idx: Optional[int] = None) -> str:
        sfx = f".{idx}" if idx is not None else ""
        return f"{self.prefix_path}/intermediate_val_data{sfx}"

    def get_test_data_path(self, idx: Optional[int] = None) -> str:
        sfx = f".{idx}" if idx is not None else ""
        return f"{self.prefix_path}/intermediate_test_data{sfx}"

    def get_run_path(self, run_id: str) -> str:
        return f"{self.prefix_path}/runs/{run_id}"

    def get_checkpoint_path(self, run_id: str) -> str:
        return f"{self.get_run_path(run_id)}/checkpoint.pkl"

    def get_logs_path(self, run_id: str) -> str:
        return f"{self.get_run_path(run_id)}/logs"

    def saving_runs(self) -> bool:
        """Whether checkpoints/logs persist (store.py saving_runs)."""
        return True

    # -- filesystem ops (subclass responsibility) ---------------------------

    def fs(self):
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    # -- pickled-object helpers (checkpoint.pkl) ---------------------------

    def write_obj(self, path: str, obj: Any) -> None:
        self.write_bytes(path, pickle.dumps(obj))

    def read_obj(self, path: str) -> Any:
        return pickle.loads(self.read_bytes(path))

    # -- parquet dataset helpers -------------------------------------------

    def is_parquet_dataset(self, path: str) -> bool:
        return bool(self.get_parquet_files(path))

    def get_parquet_files(self, path: str) -> List[str]:
        raise NotImplementedError


class FilesystemStore(Store):
    """fsspec-backed store: one class for local/HDFS/S3/GCS paths
    (collapses store.py LocalStore/HDFSStore/S3Store)."""

    def __init__(self, prefix_path: str, **fs_kwargs):
        super().__init__(prefix_path)
        import fsspec
        self._fs, self._root = fsspec.core.url_to_fs(self.prefix_path,
                                                     **fs_kwargs)

    def fs(self):
        return self._fs

    def _strip(self, path: str) -> str:
        # fsspec filesystems address paths without the scheme prefix.
        import fsspec
        return fsspec.core.url_to_fs(path)[1] if "://" in path else path

    def exists(self, path: str) -> bool:
        return self._fs.exists(self._strip(path))

    def makedirs(self, path: str) -> None:
        self._fs.makedirs(self._strip(path), exist_ok=True)

    def read_bytes(self, path: str) -> bytes:
        with self._fs.open(self._strip(path), "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        p = self._strip(path)
        parent = p.rsplit("/", 1)[0] if "/" in p else ""
        if parent:
            self._fs.makedirs(parent, exist_ok=True)
        with self._fs.open(p, "wb") as f:
            f.write(data)

    def get_parquet_files(self, path: str) -> List[str]:
        p = self._strip(path)
        if not self._fs.exists(p):
            return []
        return sorted(f for f in self._fs.ls(p, detail=False)
                      if f.endswith(".parquet"))


class LocalStore(FilesystemStore):
    """Local-filesystem store (store.py LocalStore)."""

    def __init__(self, prefix_path: str):
        super().__init__(os.path.abspath(prefix_path))


def shard_row_groups(files: List[str], rank: int, size: int,
                     filesystem=None) -> List[Tuple[str, int]]:
    """Round-robin (file, row_group) assignment across ranks — the per-rank
    reader sharding petastorm's ``cur_shard``/``shard_count`` provided in
    the reference (torch/remote.py reader construction)."""
    import pyarrow.parquet as pq
    units: List[Tuple[str, int]] = []
    for f in files:
        src = filesystem.open(f, "rb") if filesystem is not None else f
        n = pq.ParquetFile(src).num_row_groups
        units.extend((f, g) for g in range(n))
    return [u for i, u in enumerate(units) if i % size == rank]
