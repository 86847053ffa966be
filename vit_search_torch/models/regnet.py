"""RegNetY teacher network for knowledge distillation.

Port of vit_search_tpu/models/regnet.py: RegNetY-16GF (stage widths
224/448/1232/3024, depths 2/4/11/1, group width 112, squeeze-excite on the
block's input width x 0.25) and ``RegNetYUpsample``, which resizes inputs of
another size to ``target_size`` before the forward (reference
nets/regnet_upsample.py:10-39).

Parameters are named after timm's ``regnety_160`` state dict (the DeiT
teacher's checkpoint): ``stem.conv``/``stem.bn``, ``s<i>.b<j>.conv1``
(1x1), ``conv2`` (3x3 grouped), ``se.fc1``/``se.fc2`` (1x1 convs with bias),
``conv3`` (1x1, no activation), ``downsample`` (the projection shortcut),
``head.fc``; stages and blocks count from 1. Images enter NHWC and the
convolutions run channels-last (cuDNN). Batch norm follows flax: its output
is float32 whatever the compute ``dtype`` (each convolution casts its input
to ``dtype``), eps 1e-5. The teacher runs in eval mode under
``torch.no_grad()`` (``train.make_teacher``).

The resize is ``jax.image.resize(..., "bicubic")``: Keys' cubic with a =
-0.5, antialiased when shrinking, from the float32 weight matrices of
``models.surgery.resize_weights``, applied along H and then W in float64 so
no TF32 setting moves it; ``F.interpolate`` is another function.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import lecun_normal_
from .patch_embed import BatchNorm
from .surgery import resize_weights

WIDTHS_16GF = (224, 448, 1232, 3024)
DEPTHS_16GF = (2, 4, 11, 1)


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int, groups: int, bias: bool,
          generator: torch.Generator) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2,
                     groups=groups, bias=bias)
    with torch.no_grad():
        lecun_normal_(conv.weight, generator)
        if bias:
            conv.bias.zero_()
    return conv


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride, conv.padding,
                    groups=conv.groups)


class ConvBN(nn.Module):
    """Conv (no bias) -> batch norm in float32 -> ReLU (unless ``act`` is off)."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int, groups: int,
                 act: bool, dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.act, self.dtype = act, dtype
        self.conv = _conv(in_ch, features, kernel, stride, groups, False, generator)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(conv2d(x, self.conv, self.dtype).float())
        return F.relu(x) if self.act else x


class SqueezeExcite(nn.Module):
    def __init__(self, features: int, reduced: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.fc1 = _conv(features, reduced, 1, 1, 1, True, generator)
        self.fc2 = _conv(reduced, features, 1, 1, 1, True, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(conv2d(F.relu(conv2d(s, self.fc1, self.dtype)), self.fc2, self.dtype))
        return x * s


class YBlock(nn.Module):
    """RegNetY bottleneck block (bottleneck ratio 1) with squeeze-excite."""

    def __init__(self, in_ch: int, features: int, stride: int, group_width: int,
                 dtype: torch.dtype, generator: torch.Generator, se_ratio: float = 0.25):
        super().__init__()
        groups = features // group_width
        self.conv1 = ConvBN(in_ch, features, 1, 1, 1, True, dtype, generator)
        self.conv2 = ConvBN(features, features, 3, stride, groups, True, dtype, generator)
        self.se = SqueezeExcite(features, max(1, int(in_ch * se_ratio)), dtype, generator)
        self.conv3 = ConvBN(features, features, 1, 1, 1, False, dtype, generator)
        self.downsample = (ConvBN(in_ch, features, 1, stride, 1, False, dtype, generator)
                           if stride != 1 or in_ch != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3(self.se(self.conv2(self.conv1(x))))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(out + shortcut)


class RegNetY(nn.Module):
    """RegNetY over NHWC images; returns ``(B, num_classes)`` logits in the
    compute ``dtype``. Built from ``seed`` on the CPU (flax's default
    initialisers: LeCun-normal kernels, zero biases) and moved to ``device``
    (the CUDA device unless ``"cpu"`` is asked for)."""

    def __init__(self, widths: Sequence[int] = WIDTHS_16GF,
                 depths: Sequence[int] = DEPTHS_16GF, group_width: int = 112,
                 stem_width: int = 32, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if len(widths) != len(depths):
            raise ValueError("widths and depths differ in length")
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        self.stem = ConvBN(3, stem_width, 3, 2, 1, True, dtype, gen)
        in_ch = stem_width
        self.num_stages = len(widths)
        for si, (w, d) in enumerate(zip(widths, depths), start=1):
            stage = nn.Sequential()
            for bi in range(1, d + 1):
                stage.add_module(f"b{bi}", YBlock(in_ch, w, 2 if bi == 1 else 1,
                                                  group_width, dtype, gen))
                in_ch = w
            self.add_module(f"s{si}", stage)
        self.head = nn.Module()
        self.head.fc = nn.Linear(in_ch, num_classes)
        with torch.no_grad():
            lecun_normal_(self.head.fc.weight, gen)
            self.head.fc.bias.zero_()
        self.to(device=device, memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.permute(0, 3, 1, 2))
        for si in range(1, self.num_stages + 1):
            x = getattr(self, f"s{si}")(x)
        x = x.mean(dim=(2, 3))
        fc = self.head.fc
        return F.linear(x.to(self.dtype), fc.weight.to(self.dtype), fc.bias.to(self.dtype))


def resize_images(x: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, size, size, C), "bicubic")`` of NHWC images,
    in ``x``'s dtype: the separable weight matrices applied along H, then W,
    in float64."""
    b, h, w, c = x.shape
    wh = torch.as_tensor(resize_weights(h, size), device=x.device, dtype=torch.float64)
    ww = torch.as_tensor(resize_weights(w, size), device=x.device, dtype=torch.float64)
    rows = torch.einsum("hH,bhwc->bHwc", wh, x.double())
    return torch.einsum("wW,bHwc->bHWc", ww, rows).to(x.dtype)


class RegNetYUpsample(RegNetY):
    """Resize non-``target_size`` NHWC inputs to ``target_size`` (bicubic,
    :func:`resize_images`), then run RegNetY; the keyword arguments are
    :class:`RegNetY`'s (RegNetY-16GF by default)."""

    def __init__(self, target_size: int = 224, **kwargs):
        super().__init__(**kwargs)
        self.target_size = target_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1:3] != (self.target_size, self.target_size):
            x = resize_images(x, self.target_size)
        return super().forward(x)
