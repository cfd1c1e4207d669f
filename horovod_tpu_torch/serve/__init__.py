"""Inference serving of the port: continuous batching of GPT-2 (paged or
slot KV; greedy, seeded sampling, n > 1 forks, speculative decoding)
with its request surface (per-token logprobs and ``/score``, SSE
streaming, grammar-constrained decoding, resident model variants and
their live roll, warmup) on a CUDA card
(``python -m horovod_tpu_torch.serve``), and the fleet's front door and
control plane: the prefix-affinity router and its server
(``python -m horovod_tpu_torch.serve.router``), the SLO-aware fleet
controller with its brownout ladder, and request tracing (``obs/``);
the tiered KV hierarchy (host and fleet tiers, block migration, swap;
``--tier-kv``) and sequence-parallel prefill (``HVD_SERVE_SP``)."""

# Lock-witness sanitizer (HVD_SANITIZE=1, analysis/witness.py): installed
# BEFORE the submodule imports below, so every serve-plane lock — the
# batcher's condition, the engine's slot table, metrics, the scheduler,
# the block pool, the router, the tier worker, the controller — is built
# through the instrumented factory.  One env read when off.
from ..analysis import witness as _witness  # noqa: E402

_witness.maybe_install_from_env()

from .batcher import (DeadlineExceededError, DynamicBatcher,  # noqa: F401
                      QueueFullError, Request)
from .blocks import (BlockManager, NoFreeBlocksError,  # noqa: F401
                     chain_hashes)
from .controller import (ControllerConfig, ControllerState,  # noqa: F401
                         FleetController, FleetSnapshot)
from .engine import (InferenceEngine, MLPAdapter,  # noqa: F401
                     TransformerAdapter)
from .metrics import Histogram, ServeMetrics  # noqa: F401
from .registry import (ModelRegistry, ModelVariant,  # noqa: F401
                       apply_delta, model_salt)
from .replica import (NoHealthyReplicaError, Replica,  # noqa: F401
                      ReplicaScheduler, build_replicas)
from .router import Router, RouterConfig, RouterMetrics  # noqa: F401
from .router_server import RouterServer  # noqa: F401
from .seqpar import SPConfig, SPWorld  # noqa: F401
from .server import ServeServer  # noqa: F401
from .tiering import (HostTier, TierClient, TierConfig,  # noqa: F401
                      TieredBlockManager, TierWorker)
