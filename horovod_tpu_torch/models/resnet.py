"""ResNet family (v1.5): the port's flagship training model.

Port of ``horovod_tpu/models/resnet.py``: ``SpaceToDepthStem``
(``:37``), ``max_pool_eq_grad`` (``:78-146``), ``BottleneckBlock``
(``:152``), ``ResNet`` (``:178``), ``ResNet50/101/152`` (``:232-234``),
``migrate_pre_r3_checkpoint`` (``:237``) and ``create_resnet50``
(``:252``).

The input is NHWC, as in JAX, and so is every activation: a convolution
permutes its NHWC input to NCHW, which for a contiguous NHWC tensor is a
channels-last view at no copy, and permutes the channels-last result
back.  Convolutions pad as XLA's SAME does, ``lo = total // 2`` of
``total = max((ceil(n / s) - 1) * s + k - n, 0)``: asymmetric at every
stride-2 layer of an even extent, which ``padding=`` cannot say, so those
pad with ``F.pad`` first.

Parameters are f32 and cast to the compute ``dtype`` where they are used
(flax's ``param_dtype=float32`` / ``dtype``).  They keep flax's names
(``conv_init``, ``bn_init``, ``BottleneckBlock_i.{Conv_k, BatchNorm_k,
conv_proj, norm_proj}``, ``Dense_0``); convolution kernels are OIHW, the
stem's stays (7, 7, C, F) in both stem modes (so the two modes share a
state dict, as in JAX), and the Dense kernel stays (in, out).
``models/convert.py`` maps a flax tree onto these names.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..sync_batch_norm import FusedBatchNorm
from ..utils.device import resolve_device

# lecun_normal: a normal truncated at two standard deviations, rescaled to
# variance 1 / fan_in (flax's default kernel initializer).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def same_pads(n: int, k: int, s: int):
    """XLA's SAME padding (lo, hi) of an extent ``n``, window ``k``,
    stride ``s``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int,
              bias: Optional[torch.Tensor] = None, pads=None) -> torch.Tensor:
    """NHWC ``x`` with an OIHW kernel, SAME padding unless ``pads`` gives
    ((top, bottom), (left, right)); NHWC out."""
    if pads is None:
        pads = (same_pads(x.shape[1], w.shape[2], stride),
                same_pads(x.shape[2], w.shape[3], stride))
    (t, b), (l, r) = pads
    xc = x.permute(0, 3, 1, 2)
    if t == b and l == r:
        padding = (t, l)
    else:
        xc, padding = F.pad(xc, (l, r, t, b)), 0
    w = w.contiguous(memory_format=torch.channels_last)
    return F.conv2d(xc, w, bias, stride=stride,
                    padding=padding).permute(0, 2, 3, 1)


class Conv(nn.Module):
    """flax ``nn.Conv`` with SAME padding: an f32 OIHW ``kernel`` (and
    ``bias`` when asked), applied in ``dtype``."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, use_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.kernel = nn.Parameter(torch.empty(
            (features, in_features, kernel_size, kernel_size),
            device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        o, i, kh, kw = self.kernel.shape
        lecun_normal_(self.kernel.data, i * kh * kw, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return conv_nhwc(x.to(dt), self.kernel.to(dt), self.stride, bias)


class Dense(nn.Module):
    """flax ``nn.Dense``: an f32 (in, out) ``kernel`` and ``bias``,
    applied in ``dtype``."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty((in_features, features),
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel.data, self.kernel.shape[0], generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C); depth flattened as (di, dj, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


class NaiveStem(nn.Module):
    """The 7x7/stride-2 SAME stem conv; its kernel is kept (7, 7, C, F),
    the layout ``SpaceToDepthStem`` keeps, and permuted per call."""

    def __init__(self, in_features: int, features: int = 64,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            (7, 7, in_features, features), device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel.data, 49 * self.kernel.shape[2], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)
        return conv_nhwc(x.to(self.dtype), w, 2)


class SpaceToDepthStem(NaiveStem):
    """The stem's 7x7/stride-2 conv re-indexed as a 4x4/stride-1 conv on
    2x2 space-to-depth input (``horovod_tpu/models/resnet.py:37``): the
    (7, 7, C, F) kernel is zero-padded to 8x8 and regrouped per call, and
    the conv pads ((1, 2), (1, 2))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 2 or x.shape[2] % 2:
            raise ValueError(
                f"SpaceToDepthStem requires even H and W, got "
                f"{tuple(x.shape)}; use the naive stem (fast_stem=False) "
                f"for odd extents")
        c, f = self.kernel.shape[2], self.kernel.shape[3]
        k = F.pad(self.kernel, (0, 0, 0, 0, 0, 1, 0, 1))      # (8, 8, C, F)
        k = k.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
        k = k.reshape(4, 4, 4 * c, f).permute(3, 2, 0, 1)     # OIHW
        return conv_nhwc(_space_to_depth(x).to(self.dtype),
                         k.to(self.dtype), 1, pads=((1, 2), (1, 2)))


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2 SAME max pool of NHWC ``x`` (padding -inf); its
    autograd backward sends a window's gradient to one maximum, as XLA's
    ``select_and_scatter`` does."""
    (t, b), (l, r) = same_pads(x.shape[1], 3, 2), same_pads(x.shape[2], 3, 2)
    xc = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(xc, 3, 2).permute(0, 2, 3, 1)


class _MaxPoolEqGrad(torch.autograd.Function):
    """``max_pool_3x3s2`` whose backward routes 1/n of a window's
    gradient to each of its n tied maxima, by equality gathers
    (``horovod_tpu/models/resnet.py:99-146``)."""

    @staticmethod
    def forward(ctx, x):
        if x.shape[1] % 2 or x.shape[2] % 2:
            # The parity gathers assume SAME padding (0, 1) per spatial
            # dim, which holds only for even extents.
            raise ValueError(
                f"max_pool_eq_grad requires even H and W, got "
                f"{tuple(x.shape)}; use max_pool_3x3s2 for odd extents")
        y = max_pool_3x3s2(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        h, w = x.shape[1], x.shape[2]
        oh, ow = y.shape[1], y.shape[2]
        xp = F.pad(x, (0, 0, 0, 1, 0, 1), value=float("-inf"))
        # Tie counts per window at output resolution (the padded -inf
        # never equals y: every window holds a real element).
        cnt = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
        for u in range(3):
            for v in range(3):
                win = xp[:, u:u + 2 * oh - 1:2, v:v + 2 * ow - 1:2]
                cnt = cnt + (win == y).float()
        gn = g.float() / cnt

        def row_gathers(a):
            """a at output rows -> (A, B) at input rows: A[i] = a[i//2]
            (window i//2 covers row i), B[i] = a[i//2 - 1] (covers row i
            only for even i >= 2)."""
            rep = a.repeat_interleave(2, dim=1)[:, :h]
            return rep, F.pad(rep, (0, 0, 0, 0, 2, 0))[:, :h]

        def col_gathers(a):
            rep = a.repeat_interleave(2, dim=2)[:, :, :w]
            return rep, F.pad(rep, (0, 0, 2, 0))[:, :, :w]

        ar_h = torch.arange(h, device=x.device)
        ar_w = torch.arange(w, device=x.device)
        row_masks = (torch.ones(h, dtype=torch.bool, device=x.device),
                     (ar_h % 2 == 0) & (ar_h >= 2))
        col_masks = (torch.ones(w, dtype=torch.bool, device=x.device),
                     (ar_w % 2 == 0) & (ar_w >= 2))
        grad = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        ga_rows, gy_rows = row_gathers(gn), row_gathers(y)
        for ri in range(2):
            g_rc, y_rc = col_gathers(ga_rows[ri]), col_gathers(gy_rows[ri])
            for ci in range(2):
                mask = (row_masks[ri][None, :, None, None]
                        & col_masks[ci][None, None, :, None])
                eq = (x == y_rc[ci]) & mask
                grad = grad + torch.where(eq, g_rc[ci], 0.0)
        return grad.to(x.dtype)


def max_pool_eq_grad(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2 SAME max pool of NHWC ``x`` (even H and W) whose
    backward gives each of a window's n tied maxima 1/n of its gradient,
    so the gradient's sum is kept."""
    return _MaxPoolEqGrad.apply(x)


class BottleneckBlock(nn.Module):
    """v1.5: the stride on the 3x3; ``conv_proj`` / ``norm_proj`` when the
    shape changes."""

    def __init__(self, in_features: int, filters: int, strides: int,
                 norm, dtype: torch.dtype, device=None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, device=device)
        self.Conv_0 = conv(in_features, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, filters * 4, 1)
        self.BatchNorm_2 = norm(filters * 4, scale_init=nn.init.zeros_)
        self.conv_proj = self.norm_proj = None
        if in_features != filters * 4 or strides != 1:
            self.conv_proj = conv(in_features, filters * 4, 1, strides)
            self.norm_proj = norm(filters * 4)

    def forward(self, x: torch.Tensor,
                use_running_average: bool) -> torch.Tensor:
        ura = use_running_average
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), ura))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), ura))
        y = self.BatchNorm_2(self.Conv_2(y), ura)
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x), ura)
        return F.relu(x + y)


class ResNet(nn.Module):
    """``forward(x, train=True)``: NHWC RGB images to f32 logits.
    ``sync_bn`` synchronizes every batch norm's statistics over the world
    in training (the JAX ``axis_name="hvd"``); ``s2d_stem`` and
    ``eq_pool_grad`` are the two stem variants; ``fused_bn=False`` applies
    the batch norms in f32 (flax ``nn.BatchNorm(dtype=float32)``'s
    math)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 sync_bn: bool = False, s2d_stem: bool = False,
                 eq_pool_grad: bool = False, fused_bn: bool = True,
                 device=None):
        super().__init__()
        self.dtype, self.eq_pool_grad = dtype, eq_pool_grad
        norm = partial(FusedBatchNorm, momentum=0.9, epsilon=1e-5,
                       dtype=dtype if fused_bn else torch.float32,
                       axis_name="hvd" if sync_bn else None, device=device)
        stem = SpaceToDepthStem if s2d_stem else NaiveStem
        self.conv_init = stem(3, num_filters, dtype=dtype, device=device)
        self.bn_init = norm(num_filters)
        self.block_names = []
        c = num_filters
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                strides = 2 if i > 0 and j == 0 else 1
                name = f"BottleneckBlock_{len(self.block_names)}"
                filters = num_filters * 2 ** i
                self.add_module(name, BottleneckBlock(
                    c, filters, strides, norm, dtype, device))
                self.block_names.append(name)
                c = filters * 4
        self.Dense_0 = Dense(c, num_classes, torch.float32, device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        ura = not train
        x = self.conv_init(x.to(self.dtype))
        x = F.relu(self.bn_init(x, ura))
        x = max_pool_eq_grad(x) if self.eq_pool_grad else max_pool_3x3s2(x)
        for name in self.block_names:
            x = getattr(self, name)(x, ura)
        # jnp.mean of a bf16 array: f32 sums, one rounding to bf16.
        x = x.mean(dim=(1, 2), dtype=torch.float32).to(x.dtype)
        return self.Dense_0(x)


@torch.no_grad()
def init_kernels_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every conv and Dense kernel from ``generator`` (lecun_normal,
    flax's default) and zero their biases; batch norms keep their
    construction values (scale one, or zero for a block's last; bias,
    running mean zero; running variance one)."""
    for m in model.modules():
        if isinstance(m, (Conv, Dense, NaiveStem)):
            m.reset_parameters(generator)
    return model


ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3])


def migrate_pre_r3_checkpoint(state: Dict[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """A converted state dict saved while the stem conv still had a bias
    (which batch norm subtracted right back out): drops ``conv_init``'s
    ``bias``, a no-op when it is absent."""
    return {k: v for k, v in state.items()
            if not (k.endswith("bias") and "conv_init" in k)}


def create_resnet50(num_classes: int = 1000,
                    dtype: torch.dtype = torch.bfloat16,
                    sync_bn: bool = False, fast_stem: bool = False,
                    fused_bn: bool = True, device=None,
                    seed: Optional[int] = 0) -> ResNet:
    """ResNet-50 on ``device`` (cuda unless named).  ``fast_stem`` turns
    on both stem variants (``SpaceToDepthStem`` and ``max_pool_eq_grad``)
    at one state dict.  Kernels are drawn from
    ``torch.Generator(device).manual_seed(seed)``; ``seed=None`` leaves
    them uninitialised for a load."""
    dev = resolve_device(device)
    model = ResNet50(num_classes=num_classes, dtype=dtype, sync_bn=sync_bn,
                     s2d_stem=fast_stem, eq_pool_grad=fast_stem,
                     fused_bn=fused_bn, device=dev)
    if seed is not None:
        init_kernels_(model, torch.Generator(device=dev).manual_seed(seed))
    return model
