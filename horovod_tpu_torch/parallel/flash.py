"""The attention mask vocabulary and online-softmax contract, in torch.

Port of the shared part of ``horovod_tpu/parallel/flash.py`` that paged
attention imports (``serve/paged_attention.py:75`` there): the
``NEG_INF`` fill, the static mask modes, ``causal_mask``,
``block_contributes`` and the FlashAttention-2 online-softmax step with
its two floors.  The CUDA paged-attention kernel
(``csrc/paged_attention.cu``) implements exactly this contract on the
card; these plain functions state it once in Python, where the CPU
tests can hold it against the dense softmax.

The three FlashAttention-2 Pallas kernels of the JAX module (forward,
backward dQ, backward dK/dV) are training kernels and are not ported
yet (ROADMAP Queue B, B1-B3).
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30

# Static mask modes: NONE = full attend; CAUSAL = q >= k on global
# positions; STRICT = q > k (the striped ring's off-diagonal rule).
MASK_NONE, MASK_CAUSAL, MASK_STRICT = 0, 1, 2


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
