"""horovod_tpu_torch — the PyTorch/CUDA port of ``horovod_tpu``.

The JAX package (``horovod_tpu/``) is the reference; this package holds
its PyTorch counterparts, module for module, with the TPU's Pallas
kernels rewritten by hand for NVIDIA Hopper (``csrc/``).  It imports
torch, numpy and the standard library only — never jax, flax or
anything of ``horovod_tpu``.

Ported so far: the paged-KV, continuous-batching serving path
(``serve/``, ``python -m horovod_tpu_torch.serve``) over the GPT-2
transformer (``models/``), with paged attention in a CUDA kernel
(``csrc/paged_attention.cu``).  Entry points run on ``cuda`` unless the
caller asks for ``device="cpu"``.
"""
