"""Paged attention for the serving engine: the CUDA kernel's wrapper, its
plain PyTorch version, and quantized KV block storage.

Port of ``horovod_tpu/serve/paged_attention.py``.  The Pallas TPU kernel
``_paged_kernel`` there becomes the hand-written CUDA kernel
``csrc/paged_attention.cu``; ``paged_decode_attention`` and
``paged_prefill_attention`` keep their signatures and layouts:

* ``q`` [B, H, Dh] (decode) or [B, C, H, Dh] (prefill chunk), f32/bf16;
* ``k_pool``/``v_pool`` [NB, BT, H, Dh] — one layer's block pool,
  f32/bf16, or int8/fp8 with f16 scale rows ``k_scale``/``v_scale``
  [NB, BT, H];
* ``tables`` [B, MB] int32 block tables, entry ``NB`` = hole;
* ``positions`` [B] int32 — the absolute position of each row's first
  query (decode: the token's own position);
* the result is f32 in q's shape.

A wrapper given CUDA tensors launches the kernel or raises; given CPU
tensors it computes the plain version, ``paged_attention_reference``
(the JAX package's gather reference: clamped take over the tables,
positional and hole masks, dense softmax).  The engine's
``attn_impl="gather"`` calls the plain version directly on any device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel.flash import MASK_CAUSAL, MASK_NONE, MASK_STRICT, NEG_INF

__all__ = [
    "MASK_NONE", "MASK_CAUSAL", "MASK_STRICT",
    "KV_DTYPES", "SCALE_DTYPE", "kv_bytes_per_token", "quantize_kv",
    "dequantize_kv", "paged_decode_attention", "paged_prefill_attention",
    "paged_attention_reference", "LAUNCHES",
]


# ---------------------------------------------------------------------------
# Quantized block storage
# ---------------------------------------------------------------------------

#: Scale rows are stored per (block slot, position, head) in this dtype.
SCALE_DTYPE = torch.float16

# name -> (storage dtype or None for "store at compute dtype",
#          max representable magnitude for the quantizer)
_KV_STORAGE = {
    "native": (None, None),
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}

#: Supported ``HVD_SERVE_KV_DTYPE`` storage names.
KV_DTYPES = tuple(_KV_STORAGE)


def kv_bytes_per_token(kv_dtype: str, head_dim: int,
                       native_dtype: torch.dtype) -> int:
    """Device bytes one token position of one head's K *or* V costs under
    ``kv_dtype`` storage (payload + its share of the scale row)."""
    storage, _ = _KV_STORAGE[kv_dtype]
    if storage is None:
        return head_dim * native_dtype.itemsize
    return head_dim * storage.itemsize + SCALE_DTYPE.itemsize


def quantize_kv(x: torch.Tensor, kv_dtype: str):
    """Quantize K/V ``[..., H, Dh]`` to ``(values, scales)`` with one
    symmetric-absmax scale per ``[..., H]`` row.  Bit for bit the JAX
    quantizer: divide by the f32 scale, round half to even and clip to
    ±127 for int8, clip to ±448 before the cast for fp8, store the scale
    as f16."""
    storage, qmax = _KV_STORAGE[kv_dtype]
    if storage is None:
        raise ValueError(f"kv_dtype {kv_dtype!r} is not quantized")
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / qmax, 1e-8)
    q = x32 / scale[..., None]
    if storage == torch.int8:
        q = torch.clamp(torch.round(q), -127.0, 127.0)
    else:  # fp8: clamp before the cast (e4m3fn has no infinity)
        q = torch.clamp(q, -qmax, qmax)
    return q.to(storage), scale.to(SCALE_DTYPE)


def dequantize_kv(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (f32 out)."""
    return values.float() * scales.float()[..., None]


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

#: Kernel launches since the last reset, by kernel name.  Bumped once per
#: wrapper call that launches the kernel (and, for a split table, its
#: merge pass), never by the plain version.
LAUNCHES = {"paged_attention": 0}

_Q_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_KV_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}
HEAD_DIMS = (16, 32, 64, 128)
MAX_BLOCK_TOKENS = 64
#: Logical blocks per split of a table row: a row of MB blocks runs as
#: ceil(MB / SPLIT_BLOCKS) thread blocks whose partial softmax states a
#: second pass merges.  Fixed, so a row's arithmetic never depends on
#: the batch it rides in.
SPLIT_BLOCKS = 8


def num_splits(mb: int) -> int:
    """Splits of a table row of ``mb`` blocks (the kernel's own rule)."""
    return -(-mb // SPLIT_BLOCKS) if mb > SPLIT_BLOCKS else 1


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged attention kernel: {msg}")


def _paged_cuda(q, k_pool, v_pool, tables, positions, k_scale, v_scale,
                scale: float, mask_mode: int) -> torch.Tensor:
    """Validate, allocate the output and launch ``hvd_paged_attention`` on
    the current stream.  ``q`` is [B, C, H, Dh]."""
    from ..csrc import build as _build
    B, C, H, Dh = q.shape
    NB, BT = k_pool.shape[0], k_pool.shape[1]
    _check(q.dtype in _Q_KINDS, f"q dtype {q.dtype} (f32|bf16)")
    _check(k_pool.dtype in _KV_KINDS and v_pool.dtype == k_pool.dtype,
           f"pool dtypes {k_pool.dtype}/{v_pool.dtype}")
    _check(Dh in HEAD_DIMS, f"head_dim {Dh} not in {HEAD_DIMS}")
    _check(1 <= BT <= MAX_BLOCK_TOKENS,
           f"block_tokens {BT} outside [1, {MAX_BLOCK_TOKENS}]")
    _check(tuple(k_pool.shape) == (NB, BT, H, Dh)
           and tuple(v_pool.shape) == (NB, BT, H, Dh),
           f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} vs "
           f"q {tuple(q.shape)}")
    _check(tables.dim() == 2 and tables.shape[0] == B
           and tables.dtype == torch.int32, "tables must be int32 [B, MB]")
    _check(tuple(positions.shape) == (B,)
           and positions.dtype == torch.int32,
           "positions must be int32 [B]")
    quantized = k_pool.dtype in (torch.int8, torch.float8_e4m3fn)
    _check(quantized == (k_scale is not None) == (v_scale is not None),
           "scales go with int8/fp8 pools and only with them")
    tensors = [q, k_pool, v_pool, tables, positions]
    if quantized:
        _check(tuple(k_scale.shape) == (NB, BT, H)
               and tuple(v_scale.shape) == (NB, BT, H)
               and k_scale.dtype == v_scale.dtype == SCALE_DTYPE,
               "scales must be f16 [NB, BT, H]")
        tensors += [k_scale, v_scale]
    for t in tensors:
        _check(t.device == q.device, f"tensor on {t.device}, q on {q.device}")
        _check(t.is_contiguous(), "every operand must be contiguous")
    _check(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
           "pools must be 16-byte aligned (the kernel loads 16 bytes at "
           "a time)")
    MB = tables.shape[1]
    S = num_splits(MB)
    out = torch.empty((B, C, H, Dh), dtype=torch.float32, device=q.device)
    scratch = (torch.empty((B * C * H * S * (Dh + 2),), dtype=torch.float32,
                           device=q.device) if S > 1 else None)
    lib = _build.load()
    err = lib.hvd_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        B, C, H, Dh, NB, BT, MB, SPLIT_BLOCKS, float(scale), int(mask_mode),
        _Q_KINDS[q.dtype], _KV_KINDS[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged attention kernel launch failed: CUDA error {err} "
            f"({lib.hvd_cuda_error_string(err).decode()})")
    LAUNCHES["paged_attention"] += 1
    return out


def _paged_call(q, k_pool, v_pool, tables, positions, k_scale, v_scale,
                scale, mask_mode):
    if q.is_cuda:
        return _paged_cuda(q, k_pool, v_pool, tables, positions, k_scale,
                           v_scale, scale, mask_mode)
    if q.device.type != "cpu":
        raise ValueError(f"paged attention runs on cuda or cpu, not "
                         f"{q.device}")
    return paged_attention_reference(
        q, k_pool, v_pool, tables, positions, mask_mode=mask_mode,
        k_scale=k_scale, v_scale=v_scale, scale=scale)


def paged_decode_attention(q, k_pool, v_pool, tables, positions, *,
                           k_scale=None, v_scale=None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One decode step of paged attention, straight off the block pool:
    ``q`` [B, H, Dh], keys at positions <= ``positions[b]`` attend.
    Returns [B, H, Dh] f32."""
    B, H, Dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    out = _paged_call(q[:, None], k_pool, v_pool, tables, positions,
                      k_scale, v_scale, scale, MASK_CAUSAL)
    return out[:, 0]


def paged_prefill_attention(q, k_pool, v_pool, tables, starts, *,
                            mask_mode: int = MASK_CAUSAL,
                            k_scale=None, v_scale=None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill paged attention: ``q`` [B, C, H, Dh] is one prompt
    chunk per sequence whose row 0 sits at absolute position
    ``starts[b]`` (the engine scatters the chunk's K/V into the pool
    first, so intra-chunk causality falls out of the positional mask).
    Returns [B, C, H, Dh] f32."""
    Dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    return _paged_call(q, k_pool, v_pool, tables, starts, k_scale, v_scale,
                       scale, mask_mode)


# ---------------------------------------------------------------------------
# The plain version (the JAX package's gather reference)
# ---------------------------------------------------------------------------

def paged_attention_reference(q, k_pool, v_pool, tables, positions, *,
                              mask_mode: int = MASK_CAUSAL,
                              k_scale=None, v_scale=None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Gather over the block tables + positional and hole masks + dense
    softmax, for decode ([B, H, Dh]) and prefill ([B, C, H, Dh]) queries.
    Table entries are clamped into [0, NB) before the gather, as
    ``jnp.take(mode="clip")`` does; a clamped hole is then masked, so its
    contents never reach the output."""
    decode = q.dim() == 3
    if decode:
        q = q[:, None]
    B, C, H, Dh = q.shape
    NB, BT = k_pool.shape[0], k_pool.shape[1]
    MB = tables.shape[1]
    S = MB * BT
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    idx = tables.long().clamp(0, NB - 1)
    kk = k_pool[idx].reshape(B, S, H, Dh)
    vv = v_pool[idx].reshape(B, S, H, Dh)
    if k_scale is not None:
        kk = dequantize_kv(kk, k_scale[idx].reshape(B, S, H))
        vv = dequantize_kv(vv, v_scale[idx].reshape(B, S, H))
    s = torch.einsum("bqhe,bkhe->bhqk", q.float(), kk.float()) * scale
    q_pos = positions.long()[:, None, None, None] \
        + torch.arange(C, device=dev)[None, None, :, None]
    k_pos = torch.arange(S, device=dev)[None, None, None, :]
    if mask_mode == MASK_CAUSAL:
        keep = k_pos <= q_pos
    elif mask_mode == MASK_STRICT:
        keep = k_pos < q_pos
    else:
        keep = torch.ones_like(k_pos <= q_pos)
    # Hole sentinels are never real keys, whatever the mask mode.
    hole = (tables >= NB).repeat_interleave(BT, dim=1)      # [B, S]
    keep = keep & ~hole[:, None, None, :]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # A row with EVERY key masked contributes nothing (the kernel's floored
    # online softmax gives it exactly 0).
    p = torch.where(keep.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhe->bqhe", p, vv.float())
    return out[:, 0] if decode else out
