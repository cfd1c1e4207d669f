"""MNIST-scale models: ``MLP``, ``MnistCNN`` and ``create_mlp``.

Port of ``horovod_tpu/models/mlp.py``.  As there, the modules are named
``Dense_i`` / ``Conv_i`` (so ``models/convert.py`` maps a flax tree onto
them), parameters are f32 and computed in ``dtype``, and ``MnistCNN``
takes NHWC images and flattens in NHWC order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..utils.device import resolve_device
from .resnet import Conv, Dense, init_kernels_


class MLP(nn.Module):
    """A multi-layer perceptron over flattened features: ReLU between
    the Dense layers."""

    def __init__(self, in_features: int, features: Sequence[int] = (128, 10),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype, self.names = dtype, []
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", Dense(in_features, f, dtype,
                                                device))
            self.names.append(f"Dense_{i}")
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i, name in enumerate(self.names):
            x = getattr(self, name)(x)
            if i < len(self.names) - 1:
                x = F.relu(x)
        return x


class MnistCNN(nn.Module):
    """Two 3x3 SAME convs (with bias), each followed by ReLU and a 2x2
    max pool, then two Dense layers; 28x28x1 NHWC images in."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(1, 32, 3, use_bias=True, dtype=dtype,
                           device=device)
        self.Conv_1 = Conv(32, 64, 3, use_bias=True, dtype=dtype,
                           device=device)
        self.Dense_0 = Dense(7 * 7 * 64, 128, dtype, device)
        self.Dense_1 = Dense(128, num_classes, dtype, device)

    @staticmethod
    def _pool(x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = self._pool(F.relu(self.Conv_0(x)))
        x = self._pool(F.relu(self.Conv_1(x)))
        x = F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(x)


def create_mlp(features: Sequence[int] = (128, 10), in_features: int = 784,
               device=None, seed: Optional[int] = 0, **kwargs) -> MLP:
    """An ``MLP`` on ``device`` (cuda unless named), its kernels drawn
    from ``torch.Generator(device).manual_seed(seed)`` (``None``: left
    uninitialised for a load)."""
    dev = resolve_device(device)
    model = MLP(in_features, tuple(features), device=dev, **kwargs)
    if seed is not None:
        init_kernels_(model, torch.Generator(device=dev).manual_seed(seed))
    return model
