"""Inference serving of the port: continuous batching of GPT-2 (paged or
slot KV; greedy, seeded sampling, n > 1 forks, speculative decoding) on
a CUDA card (``python -m horovod_tpu_torch.serve``)."""

from .batcher import (DeadlineExceededError, DynamicBatcher,  # noqa: F401
                      QueueFullError, Request)
from .blocks import BlockManager, NoFreeBlocksError  # noqa: F401
from .engine import (InferenceEngine, MLPAdapter,  # noqa: F401
                     TransformerAdapter)
from .metrics import ServeMetrics  # noqa: F401
from .replica import (NoHealthyReplicaError, Replica,  # noqa: F401
                      ReplicaScheduler, build_replicas)
from .server import ServeServer  # noqa: F401
