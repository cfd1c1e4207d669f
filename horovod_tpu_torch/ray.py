"""horovod_tpu_torch.ray: the Ray integration namespace.

Copy of ``horovod_tpu/ray.py``.  Reference surface
(horovod/ray/__init__.py): RayExecutor (static worlds, ray/runner.py:45)
and the elastic executor and its discovery (ray/elastic_v2.py).  Both
import ray at call time: the port does not depend on it.
"""

from .ray_integration import RayExecutor  # noqa: F401
from .ray_elastic import (  # noqa: F401
    ElasticRayExecutor, RayHostDiscovery,
)
