"""Data loaders and the data service (port of ``horovod_tpu/data/``)."""

from .data_loader_base import (  # noqa: F401
    BaseDataLoader, AsyncDataLoaderMixin, AsyncDataLoader,
    ShardedDataLoader)

from .service import (  # noqa: F401
    DataServiceWorker, RemoteDataset, serve_dataset)
