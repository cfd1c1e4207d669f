"""Flash attention for training, in torch: the three FlashAttention-2
kernels' wrappers, their plain versions, and the mask vocabulary.

Port of ``horovod_tpu/parallel/flash.py``.  The three Pallas TPU kernels
there become hand-written CUDA kernels for Hopper:

* ``_fwd_kernel`` (``:125``) → ``hvd_flash_fwd``: out and the per-row
  logsumexp, online softmax over key tiles;
* ``_bwd_dq_kernel`` (``:158``) → ``hvd_flash_bwd_dq``;
* ``_bwd_dkv_kernel`` (``:195``) → ``hvd_flash_bwd_dkv``.

Each has two routes, both on the tensor cores, chosen by the operands'
dtype alone (:func:`fwd_route`, :func:`bwd_route`): bf16 operands run
the ``wgmma`` kernels fed by TMA of ``csrc/flash_attention_fwd_sm90.cu``
(P enters P·V as bf16) and ``csrc/flash_attention_bwd_sm90.cu`` (P and
dS enter the second products as bf16).  Anything else runs in f32, on
``mma.sync`` in split-precision TF32 (``"tf32x3"``): the forward in
``csrc/flash_attention_fwd_tf32_sm90.cu``, the backward pair in
``csrc/flash_attention_bwd_tf32_sm90.cu``.  Each f32 operand splits
into a TF32 hi and lo part and each product sums lo·hi + hi·lo + hi·hi
in f32, about 3·2⁻²² of Σ|a||b| from the f32 product, where one TF32
pass (2⁻¹¹) would break the JAX f32 tolerances.

The public functions keep the JAX signatures and the [B, S, H, D]
layout: :func:`flash_attention` and :func:`flash_attention_lse` (which
also returns lse [B, H, S] and is differentiable in both outputs).  One
``torch.autograd.Function`` per public variant stands in for the two
``custom_vjp``s.  ``delta = rowsum(dO * O)`` (minus the lse cotangent in
the lse variant) stays plain torch between the forward and the backward
kernels, as it is plain XLA in JAX.

A CUDA tensor goes to the kernels, which launch or raise; a CPU tensor
goes to the plain versions (:func:`attention_fwd_reference`,
:func:`attention_bwd_dq_reference`, :func:`attention_bwd_dkv_reference`),
dense formulas of the same functions.
``block_q``/``block_k`` keep their public meaning (the sequence must
divide by them) but the kernels tile by their own sizes; results agree
with the JAX kernels within tolerance, not bit for bit.

The same module states the mask vocabulary and the online-softmax
contract that serving's paged attention shares (``causal_mask``,
``block_contributes``, ``online_softmax_block``/``_flush``), including
the two floors: the running max at ``NEG_INF / 2`` and the sum at
``1e-30``, so a row that sees no key gives out 0, a finite lse and zero
gradients.  The kernels floor the max at its initial value, so such a
row's lse is ``NEG_INF / 2 + log(1e-30)`` at any tile size.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

NEG_INF = -1e30

# Static mask modes: NONE = full attend; CAUSAL = q >= k on global
# positions; STRICT = q > k (the striped ring's off-diagonal rule).
MASK_NONE, MASK_CAUSAL, MASK_STRICT = 0, 1, 2

MODE_NAMES = ("none", "causal", "strict")

#: Kernel launches since the last reset, by kernel name.  Bumped once per
#: wrapper call that launches its kernel, never by the plain versions.
#: ``flash_fwd`` / ``flash_bwd_dq`` / ``flash_bwd_dkv`` count every launch
#: of their kernel; the ``_wgmma`` names count those that took the bf16
#: route as well, the ``_tf32x3`` names those of the f32 route.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_fwd_wgmma": 0, "flash_bwd_dq_wgmma": 0,
            "flash_bwd_dkv_wgmma": 0, "flash_fwd_tf32x3": 0,
            "flash_bwd_dq_tf32x3": 0, "flash_bwd_dkv_tf32x3": 0}

#: The same launches by route and mask mode, ``<kernel>_<route>_<mode>``
#: (``MODE_NAMES``), bumped beside ``LAUNCHES``; reset on its own.
LAUNCHES_BY_MODE = {f"flash_{k}_{r}_{m}": 0
                    for k in ("fwd", "bwd_dq", "bwd_dkv")
                    for r in ("wgmma", "tf32x3") for m in MODE_NAMES}

HEAD_DIMS = (16, 32, 64, 128)
_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def causal_mask(s: torch.Tensor, q_offset: int, k_offset: int,
                mode: int) -> torch.Tensor:
    """Apply a mask mode to one ``[Bq, Bk]`` score tile whose queries sit
    at global positions ``q_offset + row`` and keys at
    ``k_offset + col``."""
    if mode == MASK_NONE:
        return s
    bq, bk = s.shape
    qg = q_offset + torch.arange(bq, device=s.device)[:, None]
    kg = k_offset + torch.arange(bk, device=s.device)[None, :]
    keep = qg >= kg if mode == MASK_CAUSAL else qg > kg
    return torch.where(keep, s, torch.full_like(s, NEG_INF))


def block_contributes(mode: int, q_lo: int, q_hi: int, k_lo: int) -> bool:
    """Whether a key block starting at global position ``k_lo`` can
    contribute to queries spanning ``[q_lo, q_hi]`` under ``mode`` — the
    skip predicate for blocks wholly outside the mask."""
    if mode == MASK_NONE:
        return True
    if mode == MASK_CAUSAL:
        return k_lo <= q_hi
    return k_lo < q_hi  # STRICT


def online_softmax_init(rows: int, dim: int, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The state before the first block: max ``NEG_INF``, sum 0,
    accumulator 0 (f32)."""
    return (torch.full((rows,), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((rows,), dtype=torch.float32, device=device),
            torch.zeros((rows, dim), dtype=torch.float32, device=device))


def online_softmax_block(s: torch.Tensor, v: torch.Tensor, m: torch.Tensor,
                         l: torch.Tensor, acc: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold score tile ``s [Bq, Bk]`` and value block ``v [Bk, D]`` into
    the running ``(max [Bq], sum [Bq], acc [Bq, D])``; returns the new
    state.

    The running max is floored at ``NEG_INF / 2``, so a row with every
    key masked contributes ``p = exp(NEG_INF - NEG_INF/2) = 0`` rather
    than weight-1 garbage; rows that see a real key are unchanged by the
    floor (the first real key's correction underflows to exactly 0)."""
    m_new = torch.clamp_min(torch.maximum(m, s.max(dim=1).values),
                            NEG_INF / 2)
    p = torch.exp(s - m_new[:, None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=1)
    acc_new = acc * corr[:, None] + p @ v.float()
    return m_new, l_new, acc_new


def online_softmax_flush(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finalize: ``(out [Bq, D], lse [Bq])``.  ``l`` is floored at 1e-30,
    so a row no block contributed to comes out exactly 0."""
    l_final = torch.clamp_min(l, 1e-30)
    return acc / l_final[:, None], m + torch.log(l_final)


# ---------------------------------------------------------------------------
# The plain versions (dense, f32)
# ---------------------------------------------------------------------------

def _keep(S: int, mode: int, device) -> Optional[torch.Tensor]:
    if mode == MASK_NONE:
        return None
    i = torch.arange(S, device=device)
    return i[:, None] >= i[None, :] if mode == MASK_CAUSAL \
        else i[:, None] > i[None, :]


def _scores(q, k, scale, mode):
    """Masked f32 scores [B, H, Sq, Sk] of q·scale against k, and the
    boolean keep mask (None for MASK_NONE)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    keep = _keep(q.shape[1], mode, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s, keep


def _softmax_parts(q, k, scale, mode):
    """``(m, p, l)``: the row max [B, H, Sq] floored at ``NEG_INF / 2``,
    ``p = exp(s - m)`` [B, H, Sq, Sk] and its row sum floored at 1e-30,
    all f32, as in the forward kernel."""
    s, _ = _scores(q, k, scale, mode)
    m = torch.clamp_min(s.amax(dim=-1), NEG_INF / 2)
    p = torch.exp(s - m[..., None])
    return m, p, torch.clamp_min(p.sum(dim=-1), 1e-30)


def attention_fwd_reference(q, k, v, *, mask_mode: int = MASK_NONE,
                            scale: Optional[float] = None, out_dtype=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function, dense: ``(out [B, S, H, D] in
    ``out_dtype`` (default q's dtype), lse [B, H, S] f32)``.  The max is
    floored at ``NEG_INF / 2`` and the sum at 1e-30, as in the kernel."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    m, p, l = _softmax_parts(q, k, scale, mask_mode)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) \
        / l.transpose(1, 2)[..., None]
    return out.to(out_dtype or q.dtype), m + torch.log(l)


def _softmax_grads(q, k, v, do, lse, delta, scale, mode):
    """``p`` and ``ds = p * (dO·vᵀ - delta)`` [B, H, Sq, Sk] in f32."""
    s, keep = _scores(q, k, scale, mode)
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def attention_bwd_dq_reference(q, k, v, do, lse, delta, *,
                               mask_mode: int = MASK_NONE,
                               scale: Optional[float] = None):
    """The dQ kernel's function, dense: dq in q's dtype from the saved
    ``lse`` and ``delta = rowsum(dO * O)`` (both [B, H, S] f32)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _, ds = _softmax_grads(q, k, v, do, lse, delta, scale, mask_mode)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
            ).to(q.dtype)


def attention_bwd_dkv_reference(q, k, v, do, lse, delta, *,
                                mask_mode: int = MASK_NONE,
                                scale: Optional[float] = None):
    """The dK/dV kernel's function, dense: ``(dk, dv)`` in k's and v's
    dtypes."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p, ds = _softmax_grads(q, k, v, do, lse, delta, scale, mask_mode)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float() * scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


#: Unit roundoff of bf16 (8 significant bits): the largest relative error
#: of rounding one f32 value to bf16.
BF16_ROUNDOFF = 2.0 ** -8


def attention_fwd_rounding_bound(q, k, v, *, mask_mode: int = MASK_NONE,
                                 scale: Optional[float] = None):
    """How far the bf16 (wgmma) route of the forward may move each output
    element from the plain version, beyond the output's own rounding: it
    rounds P = exp(s - m) to bf16 before ``P·V`` and divides by the sum
    ``l`` of the unrounded P, so each term of ``out = Σ_k P_k·v_k / l``
    may move by ``BF16_ROUNDOFF`` of its magnitude.  Returns
    ``BF16_ROUNDOFF · Σ_k P_k·|v_k| / l`` in f32 [B, S, H, D]: at most
    ``BF16_ROUNDOFF · max|v|``, and 0 on a row that sees no key."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _, p, l = _softmax_parts(q, k, scale, mask_mode)
    return BF16_ROUNDOFF * torch.einsum("bhqk,bkhd->bqhd", p,
                                        v.float().abs()) \
        / l.transpose(1, 2)[..., None]


def attention_bwd_rounding_bound(q, k, v, do, lse, delta, *,
                                 mask_mode: int = MASK_NONE,
                                 scale: Optional[float] = None):
    """How far the bf16 (wgmma) route of the backward pair may move each
    gradient element from the plain version, beyond the outputs' own
    rounding: it rounds P and dS to bf16 before the second products, so
    each term of ``dV = Σ_q P·dO``, ``dK = scale·Σ_q dS·q`` and
    ``dQ = scale·Σ_k dS·k`` may move by ``BF16_ROUNDOFF`` of its
    magnitude.  Returns ``(dq, dk, dv)`` bounds in f32 [B, S, H, D]:
    ``BF16_ROUNDOFF`` times the same sums over magnitudes."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p, ds = _softmax_grads(q, k, v, do, lse, delta, scale, mask_mode)
    u, ds = BF16_ROUNDOFF, ds.abs()
    return (u * scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float().abs()),
            u * scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float().abs()),
            u * torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs()))


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers
# ---------------------------------------------------------------------------

def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def kernel_dtype(*ts) -> torch.dtype:
    """The one element type the kernels take for all their [B, S, H, D]
    inputs: bf16 when every input is bf16, else f32 (bf16 → f32 is
    exact)."""
    for t in ts:
        _check(t.dtype in _KINDS, f"dtype {t.dtype} (f32|bf16)")
    return torch.bfloat16 if all(t.dtype == torch.bfloat16 for t in ts) \
        else torch.float32


def fwd_route(q, k, v) -> str:
    """The forward's route for these operands: ``"wgmma"`` (the bf16
    kernel) when q, k and v are all bf16, else ``"tf32x3"`` (the f32
    kernel, split-precision TF32 on the tensor cores).  The C entry point
    picks the same kernel from the element type the wrapper passes it."""
    return "wgmma" if kernel_dtype(q, k, v) == torch.bfloat16 else "tf32x3"


def bwd_route(q, k, v, do) -> str:
    """The backward pair's route for these operands: ``"wgmma"`` (the
    bf16 tensor-core kernels) when every operand is bf16, else
    ``"tf32x3"`` (the f32 kernels, split-precision TF32 on the tensor
    cores).  The C entry points pick the same kernels from the element
    type the wrapper passes them."""
    return "wgmma" if kernel_dtype(q, k, v, do) == torch.bfloat16 \
        else "tf32x3"


def _kernel_operands(*ts):
    """The operands in :func:`kernel_dtype`.  Each keeps its strides
    when its head dim is unit stride and it is 16-byte aligned (q, k, v
    sliced out of a fused qkv projection pass as views); otherwise it is
    made contiguous."""
    dtype = kernel_dtype(*ts)
    out = []
    for t in ts:
        t = t.to(dtype)
        es = t.element_size()
        if t.stride(-1) != 1 or t.data_ptr() % 16 or \
                any(st * es % 16 for st in t.stride()[:3]):
            t = t.contiguous()
        out.append(t)
    return dtype, out


def _strides(*ts):
    flat = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch(lib, fn_name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{fn_name} launch failed: CUDA error {err} "
            f"({lib.hvd_cuda_error_string(err).decode()})")


def _validate(q, k, v):
    _check(q.dim() == 4 and q.shape == k.shape == v.shape,
           f"q/k/v must share one [B, S, H, D] shape, got "
           f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    _check(q.device == k.device == v.device, "q/k/v on different devices")
    _check(q.shape[-1] in HEAD_DIMS,
           f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")


def _count(name, route, mask_mode):
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}_{route}"] += 1
    LAUNCHES_BY_MODE[f"{name}_{route}_{MODE_NAMES[mask_mode]}"] += 1


def _fwd_cuda(q, k, v, mask_mode, scale, out_dtype):
    from ..csrc import build as _build
    _validate(q, k, v)
    B, S, H, D = q.shape
    route = fwd_route(q, k, v)
    dtype, (q, k, v) = _kernel_operands(q, k, v)
    out = torch.empty((B, S, H, D), dtype=dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.load()
    err = lib.hvd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _strides(q, k, v, out), B, S, H, D, float(scale),
        int(mask_mode), _KINDS[dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _launch(lib, "hvd_flash_fwd", err)
    _count("flash_fwd", route, int(mask_mode))
    return out.to(out_dtype), lse


def _bwd_operands(q, k, v, do, lse, delta):
    _validate(q, k, v)
    B, S, H, D = q.shape
    _check(tuple(do.shape) == (B, S, H, D), "dO must have q's shape")
    _check(tuple(lse.shape) == tuple(delta.shape) == (B, H, S)
           and lse.dtype == delta.dtype == torch.float32,
           "lse and delta must be f32 [B, H, S]")
    dtype, ops = _kernel_operands(q, k, v, do)
    return dtype, ops + [lse.contiguous(), delta.contiguous()]


def _bwd_dq_cuda(q, k, v, do, lse, delta, mask_mode, scale):
    from ..csrc import build as _build
    B, S, H, D = q.shape
    q_dtype, route = q.dtype, bwd_route(q, k, v, do)
    dtype, (q, k, v, do, lse, delta) = _bwd_operands(q, k, v, do, lse, delta)
    dq = torch.empty((B, S, H, D), dtype=dtype, device=q.device)
    lib = _build.load()
    err = lib.hvd_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq), B, S, H, D, float(scale),
        int(mask_mode), _KINDS[dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _launch(lib, "hvd_flash_bwd_dq", err)
    _count("flash_bwd_dq", route, int(mask_mode))
    return dq.to(q_dtype)


def _bwd_dkv_cuda(q, k, v, do, lse, delta, mask_mode, scale):
    from ..csrc import build as _build
    B, S, H, D = q.shape
    k_dtype, v_dtype, route = k.dtype, v.dtype, bwd_route(q, k, v, do)
    dtype, (q, k, v, do, lse, delta) = _bwd_operands(q, k, v, do, lse, delta)
    dk, dv = (torch.empty((B, S, H, D), dtype=dtype, device=q.device)
              for _ in range(2))
    lib = _build.load()
    err = lib.hvd_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do, dk, dv), B, S, H, D, float(scale),
        int(mask_mode), _KINDS[dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _launch(lib, "hvd_flash_bwd_dkv", err)
    _count("flash_bwd_dkv", route, int(mask_mode))
    return dk.to(k_dtype), dv.to(v_dtype)


def _on(q) -> str:
    if q.is_cuda:
        return "cuda"
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return "cpu"


def flash_fwd(q, k, v, mask_mode: int, scale: float, out_dtype=None):
    """Forward: ``(out [B, S, H, D], lse [B, H, S] f32)``; the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    out_dtype = out_dtype or q.dtype
    if _on(q) == "cuda":
        return _fwd_cuda(q, k, v, mask_mode, scale, out_dtype)
    return attention_fwd_reference(q, k, v, mask_mode=mask_mode,
                                   scale=scale, out_dtype=out_dtype)


def flash_bwd_dq(q, k, v, do, lse, delta, mask_mode: int, scale: float):
    """dQ from the saved lse and delta: the dQ kernel for CUDA tensors,
    its plain version for CPU tensors."""
    if _on(q) == "cuda":
        return _bwd_dq_cuda(q, k, v, do, lse, delta, mask_mode, scale)
    return attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                      mask_mode=mask_mode, scale=scale)


def flash_bwd_dkv(q, k, v, do, lse, delta, mask_mode: int, scale: float):
    """``(dk, dv)`` from the saved lse and delta: the dK/dV kernel for
    CUDA tensors, its plain version for CPU tensors."""
    if _on(q) == "cuda":
        return _bwd_dkv_cuda(q, k, v, do, lse, delta, mask_mode, scale)
    return attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                       mask_mode=mask_mode, scale=scale)


def flash_bwd(q, k, v, do, lse, delta, mask_mode: int, scale: float):
    """``(dq, dk, dv)``: both backward kernels (or plain versions)."""
    dq = flash_bwd_dq(q, k, v, do, lse, delta, mask_mode, scale)
    return (dq,) + flash_bwd_dkv(q, k, v, do, lse, delta, mask_mode, scale)


def _delta(g_out, out):
    """rowsum(dO * O) in f32, [B, S, H, D] → [B, H, S]."""
    return (g_out.float() * out.float()).sum(dim=-1).transpose(1, 2)


class _Flash(torch.autograd.Function):
    """``_flash``'s custom_vjp (``parallel/flash.py:261`` in JAX)."""

    @staticmethod
    def forward(ctx, q, k, v, mask_mode, scale):
        out, lse = flash_fwd(q, k, v, mask_mode, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask_mode, ctx.scale = mask_mode, scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, g, lse, _delta(g, out),
                               ctx.mask_mode, ctx.scale)
        return dq, dk, dv, None, None


class _FlashLse(torch.autograd.Function):
    """``_flash_lse``'s custom_vjp (``parallel/flash.py:369`` in JAX):
    differentiable in out and lse; the lse cotangent folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, mask_mode, scale, out_dtype):
        qd = q if out_dtype is None else q.to(out_dtype)
        out, lse = flash_fwd(qd, k, v, mask_mode, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask_mode, ctx.scale = mask_mode, scale
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        delta = _delta(g_out, out) - g_lse.float()
        dq, dk, dv = flash_bwd(q, k, v, g_out, lse, delta, ctx.mask_mode,
                               ctx.scale)
        return dq, dk, dv, None, None, None


def _blocks(name, S, block_q, block_k):
    block_q, block_k = min(block_q, S), min(block_k, S)
    if S % block_q or S % block_k:
        raise ValueError(
            f"{name} requires seq len {S} divisible by block sizes "
            f"({block_q}, {block_k})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Differentiable flash attention over [B, S, H, D] (full local
    sequence); the output has q's dtype."""
    S, D = q.shape[1], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    _blocks("flash_attention", S, block_q, block_k)
    return _Flash.apply(q, k, v, MASK_CAUSAL if causal else MASK_NONE,
                        float(scale))


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, mask_mode: int = MASK_NONE,
                        scale: Optional[float] = None, block_q: int = 128,
                        block_k: int = 128, out_dtype=None):
    """Flash attention returning ``(out [B, S, H, D], lse [B, H, S])``,
    both differentiable: ring attention's per-hop building block, whose
    merge weights depend on lse, so its cotangent is not zero (it folds
    into delta).  ``mask_mode`` (MASK_NONE / MASK_CAUSAL / MASK_STRICT)
    applies on the LOCAL block indices of q and k; the ring picks the
    mode per hop from the block's owner (``ring._hop_plan``).
    ``out_dtype`` casts q before the forward, as JAX does, so an f32
    partial can come out of bf16 inputs; with f32 K/V (the ring's) the
    forward and the backward then take the f32 (3xTF32) route, and dq
    comes back in q's own dtype."""
    S, D = q.shape[1], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    _blocks("flash_attention_lse", S, block_q, block_k)
    return _FlashLse.apply(q, k, v, int(mask_mode), float(scale), out_dtype)
