"""Inference serving of the port: continuous batching of GPT-2 (paged or
slot KV; greedy, seeded sampling, n > 1 forks, speculative decoding)
with its request surface (per-token logprobs and ``/score``, SSE
streaming, grammar-constrained decoding, resident model variants and
their live roll, warmup) on a CUDA card
(``python -m horovod_tpu_torch.serve``)."""

from .batcher import (DeadlineExceededError, DynamicBatcher,  # noqa: F401
                      QueueFullError, Request)
from .blocks import BlockManager, NoFreeBlocksError  # noqa: F401
from .engine import (InferenceEngine, MLPAdapter,  # noqa: F401
                     TransformerAdapter)
from .metrics import ServeMetrics  # noqa: F401
from .registry import (ModelRegistry, ModelVariant,  # noqa: F401
                       apply_delta, model_salt)
from .replica import (NoHealthyReplicaError, Replica,  # noqa: F401
                      ReplicaScheduler, build_replicas)
from .server import ServeServer  # noqa: F401
