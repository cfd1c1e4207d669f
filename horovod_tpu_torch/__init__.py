"""horovod_tpu_torch — the PyTorch/CUDA port of ``horovod_tpu``.

The JAX package (``horovod_tpu/``) is the reference; this package holds
its PyTorch counterparts, module for module, with the TPU's Pallas
kernels rewritten by hand for NVIDIA Hopper (``csrc/``).  It imports
torch, numpy and the standard library only — never jax, flax or
anything of ``horovod_tpu``.

Ported so far:

* the data-parallel training path, with the Horovod API exported here as
  the JAX package exports it (``hvd.init``, rank / size, ``allreduce``,
  ``broadcast_parameters``, ``DistributedOptimizer`` ...), over
  ``torch.distributed`` (NCCL on a card, gloo on the CPU), and GPT-2 /
  BERT with FlashAttention-2 in CUDA kernels
  (``csrc/flash_attention.cu``); the trainer is
  ``python -m horovod_tpu_torch.examples.bert_pretraining``;
* the paged-KV, continuous-batching serving path (``serve/``,
  ``python -m horovod_tpu_torch.serve``), with paged attention in two
  CUDA kernels (``csrc/paged_attention_decode_sm90.cu`` for decode steps,
  ``csrc/paged_attention_prefill_sm90.cu`` for prefill chunks);
* synchronized batch norm (``SyncBatchNorm``, ``sync_batch_stats``) and
  the ResNet family (``models/resnet.py``), trained by
  ``python -m horovod_tpu_torch.examples.synthetic_benchmark``; the
  flagship model's entry points are in ``entry.py``.

Entry points run on ``cuda`` unless the caller asks for
``device="cpu"``.
"""

from .core import (  # noqa: F401
    init, shutdown, is_initialized,
    rank, size, local_rank, local_size, cross_rank, cross_size,
    num_slots, device,
    mpi_threads_supported, mpi_enabled, mpi_built,
    gloo_enabled, gloo_built, nccl_built, ddl_built, ccl_built,
    cuda_built, rocm_built, xla_built, xla_enabled,
)

from .ops import (  # noqa: F401
    ReduceOp, Average, Sum, Adasum, Min, Max, Product,
    allreduce, grouped_allreduce, broadcast, barrier,
)

from .compression import Compression  # noqa: F401

from .optimizer import DistributedOptimizer  # noqa: F401

from .functions import (  # noqa: F401
    broadcast_variables, broadcast_parameters, broadcast_optimizer_state,
)

from .process_sets import ProcessSet, global_process_set  # noqa: F401

from .sync_batch_norm import sync_batch_stats, SyncBatchNorm  # noqa: F401
