"""Published peaks, dense rates without sparsity, by the name
``torch.cuda.get_device_name`` gives.  NVIDIA H100 SXM data sheet, at
the full 700 W power limit."""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "fp16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes": 3.35e12,
    },
}


def peak(device_kind: str, key: str) -> Optional[float]:
    """The peak ``key`` of ``device_kind``, None for a device the table
    does not hold (a CPU run reads no share of a peak)."""
    return PEAKS.get(device_kind, {}).get(key)
