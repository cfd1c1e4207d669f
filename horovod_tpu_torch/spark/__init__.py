"""horovod_tpu_torch.spark: the Spark cluster integration.

Port of ``horovod_tpu/spark/__init__.py``.  Reference surface
(horovod/spark/__init__.py): ``run`` / ``run_elastic`` (function
launchers over Spark tasks) and the Estimator layer
(spark/common/estimator.py, torch/estimator.py) with its Store
abstraction (spark/common/store.py).  pyspark, pandas, pyarrow, fsspec
and cloudpickle are imported where they are used.
"""

from ..spark_integration import run  # noqa: F401
from .elastic import run_elastic  # noqa: F401
from .store import (  # noqa: F401
    Store, FilesystemStore, LocalStore, shard_row_groups,
)
from .estimator import (  # noqa: F401
    HorovodTpuEstimator, TpuTransformer,
)

# Reference alias (spark/torch/estimator.py TorchEstimator &co. collapse
# to the one estimator).
HorovodEstimator = HorovodTpuEstimator
