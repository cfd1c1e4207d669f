"""Operations and bytes that the step's work needs, from the cell's
shapes.

Flash kernels (``csrc/flash_attention_fwd_sm90.cu``,
``csrc/flash_attention_bwd_sm90.cu``), per launch at [B, S, H, D]:
every [B, S, H, D] operand read once and every output written once,
the lse and delta rows in f32; ``2 * D`` operations per kept (query,
key) pair and product: two products forward (q·kᵀ, p·v), three for dQ
(q·kᵀ, dO·vᵀ, dS·k), four for dK/dV (q·kᵀ, dO·vᵀ, pᵀ·dO, dSᵀ·q).  A
causal launch keeps ``S (S + 1) / 2`` pairs.

The model's operations per optimizer step (for ``mfu``): 6 operations
per parameter of every matmul per token (forward and backward, the tied
LM head included, at the positions where it runs), plus the attention
products, ``12 * L * S * d`` per token, half of it under a causal mask.
Nothing is recomputed.
"""

from __future__ import annotations

from typing import Dict, Tuple

#: Substrings of the flash kernels' demangled names in a trace.
FLASH_KERNELS = {"::flash_fwd_kernel<": "flash_fwd",
                 "::dq_kernel<": "flash_bwd_dq",
                 "::dkv_kernel<": "flash_bwd_dkv"}


def kept_pairs(S: int, causal: bool) -> int:
    return S * (S + 1) // 2 if causal else S * S


def flash_work(B: int, S: int, H: int, D: int, causal: bool,
               dtype_bytes: int = 2) -> Dict[str, Tuple[int, int]]:
    """{kernel: (bytes, operations)} of one launch."""
    t = B * S * H * D * dtype_bytes
    row = B * H * S * 4
    pair = 2 * D * kept_pairs(S, causal) * B * H
    return {"flash_fwd": (4 * t + row, 2 * pair),
            "flash_bwd_dq": (5 * t + 2 * row, 3 * pair),
            "flash_bwd_dkv": (6 * t + 2 * row, 4 * pair)}


def flash_bounds_s(model: dict, traffic: dict, flops_peak: float,
                   bytes_peak: float) -> Dict[str, float]:
    """{kernel: least seconds a launch can take} at the cell's shapes."""
    d, H = model["d_model"], model["num_heads"]
    work = flash_work(int(traffic["micro_batch"]), int(traffic["seq_len"]),
                      H, d // H, bool(model["causal"]))
    return {k: max(nb / bytes_peak, ops / flops_peak)
            for k, (nb, ops) in work.items()}


def flash_kernel_of(name: str):
    for tag, kernel in FLASH_KERNELS.items():
        if tag in name:
            return kernel
    return None


def matmul_params(model: dict) -> Tuple[int, int]:
    """(parameters of the blocks' matmuls, of the LM head)."""
    d, f, L = model["d_model"], model["d_ff"], model["num_layers"]
    block = d * 3 * d + d * d + d * f + f * d
    return L * block, model["vocab_size"] * d


def step_flops(model: dict, traffic: dict) -> float:
    """Operations of one rank's optimizer step."""
    S = int(traffic["seq_len"])
    rows = int(traffic["micro_batch"]) * \
        int(traffic["backward_passes_per_step"])
    blocks, head = matmul_params(model)
    L, d = model["num_layers"], model["d_model"]
    attn = 12 * L * S * d * (0.5 if model["causal"] else 1.0)
    per_token = 6 * blocks + attn
    if traffic["task"] == "masked_lm":
        head_tokens = int(traffic["predictions_per_seq"])
    else:
        head_tokens = S
    return rows * (S * per_token + head_tokens * 6 * head)
