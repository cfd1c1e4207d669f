"""horovod_tpu_torch — the PyTorch/CUDA port of ``horovod_tpu``.

The JAX package (``horovod_tpu/``) is the reference; this package holds
its PyTorch counterparts, module for module, with the TPU's Pallas
kernels rewritten by hand for NVIDIA Hopper (``csrc/``).  It imports
torch, numpy and the standard library only — never jax, flax or
anything of ``horovod_tpu``.

Ported so far:

* the Horovod API as the JAX package exports it (``hvd.init``, rank /
  size, ``allreduce``, ``allgather``, ``broadcast``, ``alltoall``,
  ``reducescatter`` with their grouped, in-place and async forms,
  ``poll`` / ``synchronize``, the object and sparse helpers, process
  sets, ``DistributedOptimizer`` ...) over ``torch.distributed`` (NCCL
  on a card, gloo on the CPU), every collective over the world or a
  registered process set;
* the data-parallel training path and GPT-2 / BERT with
  FlashAttention-2 in CUDA kernels (``csrc/flash_attention.cu``); the
  trainer is ``python -m horovod_tpu_torch.examples.bert_pretraining``;
* the paged-KV, continuous-batching serving path (``serve/``,
  ``python -m horovod_tpu_torch.serve``), with paged attention in two
  CUDA kernels (``csrc/paged_attention_decode_sm90.cu`` for decode steps,
  ``csrc/paged_attention_prefill_sm90.cu`` for prefill chunks);
* synchronized batch norm (``SyncBatchNorm``, ``sync_batch_stats``) and
  the ResNet family (``models/resnet.py``), trained by
  ``python -m horovod_tpu_torch.examples.synthetic_benchmark``; the
  flagship model's entry points are in ``entry.py``;
* Adasum (``ops/adasum.py``, ``op=hvd.Adasum`` through ``allreduce`` and
  the optimizer) and the rest of the gradient layer
  (``PartialDistributedOptimizer``, ``adasum_delta_step``,
  ``local_value_and_grad``, ``value_and_grad``, ``grad``) with the
  training callbacks (``hvd.callbacks``), trained on GPT-2-medium by
  ``python -m horovod_tpu_torch.examples.gpt2_adasum``;
* the negotiated eager engine (``ops/eager.py``, ``ops/negotiation.py``,
  the native core ``csrc/hvd_core.cc``): every collective is negotiated
  by the coordinator over the world's store before NCCL sees it, with a
  response cache and a stall inspector; ``join`` for uneven data; the
  Horovod timeline (``start_timeline`` / ``stop_timeline``,
  ``HOROVOD_TIMELINE``); and the two-level ``hierarchical_allreduce``.

* sequence parallelism (``parallel/``): meshes of named axes
  (``make_mesh``, ``hvd.mesh()``), ring attention over P2P rotations with
  the flash kernels on every hop (``parallel/ring.py``), Ulysses
  attention over the differentiable ``alltoall`` (``parallel/ulysses.py``),
  the transformer's ``seq_parallel`` and
  ``DistributedOptimizer(reduce_axes=...)``; the multi-card drive is
  ``python -m horovod_tpu_torch.examples.seqpar_bench``;
* model parallelism (``parallel/``): expert-parallel mixtures of
  experts over two alltoalls (``parallel/moe.py``, the transformer's
  ``moe_experts`` / ``expert_axis``), Megatron's column / row MLP
  (``parallel/tensor.py``), the GPipe schedule over P2P hops
  (``parallel/pipeline.py``), per-parameter ``reduce_axes`` and
  ``hvd.shard_step``; the multi-card drive is
  ``python -m horovod_tpu_torch.examples.model_parallel_bench``.

* elastic training and checkpoints: ``hvd.elastic.run`` with
  ``TorchState`` (commit, restore, sync, a disk spill that outlives the
  process), ``ElasticSampler``, the launcher and its elastic driver
  (``python -m horovod_tpu_torch.runner.launch``), ``hvd.checkpoint``
  (rank 0 writes with ``torch.save``, the others get a broadcast), the
  data loaders and data service (``hvd.data``) and the autotuner of the
  fusion threshold (``HOROVOD_AUTOTUNE``); BASELINE's elastic ResNet-50
  is ``python -m horovod_tpu_torch.examples.elastic_resnet``.

* hvdlint's host-side analyzers (``analysis/``): the AST linter, the
  lock-order graph (``--race``), the dead-mesh-axis pass (``--comm``)
  and the ``HVD_SANITIZE=1`` lock witness, run as
  ``python -m horovod_tpu_torch.analysis``; the serve engine's plan
  verdict (``plan_go`` on healthz) and ``hvd.analysis_reports()``.

* the trace-time analyzers (``analysis/graph_check.py``, the walks of
  ``analysis/memplan.py`` and ``analysis/shardplan.py``,
  ``analysis/hook.py``): under ``HVD_ANALYZE=1`` the first call of a
  ``shard_step``, of a ``DistributedOptimizer``'s reduction and of each
  serve program is traced by ``make_fx`` on fake tensors (no launch, no
  peer contacted) and checked — the collective census, HVD100-HVD102,
  peak live bytes, wire bytes — with the reports in
  ``hvd.analysis_reports()``.

* the cluster integrations: ``hvd.run(fn, np=...)`` (``runner/``), the
  launcher's LSF / jsrun spawn and NIC probe, the Spark estimator
  (``spark/``: ``HorovodTpuEstimator`` over a Parquet ``Store``,
  ``TpuTransformer``), ``spark.run`` and ``spark.run_elastic``, and the
  Ray executors (``ray.py``: ``RayExecutor``, ``ElasticRayExecutor``);
  pyspark, ray, pandas, pyarrow, fsspec and cloudpickle are imported
  only where they are used.

``distributed_gradient_transformation`` is optax's form of the
optimizer and has no torch counterpart.

Entry points run on ``cuda`` unless the caller asks for
``device="cpu"``.
"""

from .version import __version__  # noqa: F401

from .core import (  # noqa: F401
    init, shutdown, is_initialized, analysis_reports,
    rank, size, local_rank, local_size, cross_rank, cross_size,
    num_slots, local_slots, is_homogeneous, device,
    mpi_threads_supported, mpi_enabled, mpi_built,
    gloo_enabled, gloo_built, nccl_built, ddl_built, ccl_built,
    cuda_built, rocm_built, xla_built, xla_enabled,
    start_timeline, stop_timeline, mesh, mesh_axis,
)

from .ops import (  # noqa: F401
    ReduceOp, Average, Sum, Adasum, Min, Max, Product,
    allreduce, allreduce_, allreduce_async, allreduce_async_,
    grouped_allreduce, grouped_allreduce_, grouped_allreduce_async,
    grouped_allreduce_async_,
    allgather, allgather_async, grouped_allgather, grouped_allgather_async,
    broadcast, broadcast_, broadcast_async, broadcast_async_,
    alltoall, alltoall_async,
    reducescatter, reducescatter_async,
    grouped_reducescatter, grouped_reducescatter_async,
    poll, synchronize, barrier, join, hierarchical_allreduce,
)

from .compression import Compression  # noqa: F401

from .optimizer import (  # noqa: F401
    DistributedOptimizer, PartialDistributedOptimizer, adasum_delta_step,
    value_and_grad, grad, local_value_and_grad,
)

from .functions import (  # noqa: F401
    broadcast_variables, broadcast_parameters, broadcast_optimizer_state,
    broadcast_object, broadcast_object_fn, allgather_object,
)

from .sync_batch_norm import sync_batch_stats, SyncBatchNorm  # noqa: F401

from .sparse import sparse_allreduce, densify_if_sparse  # noqa: F401

from .process_sets import (  # noqa: F401
    ProcessSet, global_process_set, add_process_set, remove_process_set,
    get_process_set_ids, partition_process_sets,
)

from .exceptions import (  # noqa: F401
    HorovodInternalError, HostsUpdatedInterrupt, CollectiveRejectedError,
    RendezvousUnreachableError,
)

from . import callbacks  # noqa: F401
from . import parallel  # noqa: F401
from . import checkpoint  # noqa: F401
from . import elastic  # noqa: F401
from . import data  # noqa: F401
from .parallel import shard_step  # noqa: F401  (the hvd.shard_step idiom)
from . import runner  # noqa: F401
from . import spark  # noqa: F401
run = runner.run  # launcher API (reference: horovod.run, runner/__init__.py:95)
