"""Patch embedding stems (images enter NHWC, as in the JAX package).

- :class:`PatchEmbed` — linear patchify (network_def type 0), a conv with
  kernel == stride == patch, weight ``(O, 3, p, p)``.
- :class:`PatchConvEmbed` — convolutional stem (types 4/5): stride-2
  Conv-BN-ReLU, a two-conv residual body, then a (patch/2)-strided projection.

Port of vit_search_tpu/models/patch_embed.py. Batch norm follows flax:
momentum 0.9 on the running statistics, a biased batch variance
``E[x^2] - E[x]^2`` computed in float32, eps 1e-5. In a process group the
train-mode statistics are the global batch's, as flax's under a
mesh-sharded jit: the per-channel sums are all-reduced, and the running
statistics agree on every process. The norm, and in ``ConvBnAct`` the ReLU
after it, is ``ops.batch_norm`` (hand-written kernels on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batch_norm import batch_norm
from .layers import lecun_normal_, trunc_normal_


def make_conv(in_ch: int, out_ch: int, kernel: int, stride: int, padding: int, bias: bool,
              generator: torch.Generator, init: str) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=bias)
    with torch.no_grad():
        if init == "trunc_normal":
            trunc_normal_(conv.weight, generator)
        else:
            lecun_normal_(conv.weight, generator)
        if bias:
            conv.bias.zero_()
    return conv


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride, conv.padding)


class BatchNorm(nn.Module):
    """Batch norm over NCHW with flax's statistics and running-average rule."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalize(x, relu=False)

    def normalize(self, x: torch.Tensor, relu: bool) -> torch.Tensor:
        """The norm of ``x``, then the ReLU where ``relu``."""
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                          self.training, self.momentum, self.eps, relu)


class ConvBnAct(nn.Module):
    def __init__(self, in_ch: int, features: int, strides: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.conv = make_conv(in_ch, features, 3, strides, 1, False, generator, "lecun_normal")
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn.normalize(conv2d(x, self.conv, self.dtype), relu=True)


class PatchEmbed(nn.Module):
    """Linear patch embedding of an ``(B, H, W, 3)`` image -> ``(B, N, E)``."""

    def __init__(self, img_size: int, patch_size: int, embed_dim: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.img_size, self.dtype = img_size, dtype
        self.proj = make_conv(3, embed_dim, patch_size, patch_size, 0, True, generator,
                              "trunc_normal")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.img_size or x.shape[2] != self.img_size:
            raise ValueError(f"image {tuple(x.shape[1:3])} != {self.img_size}px")
        x = conv2d(x.permute(0, 3, 1, 2), self.proj, self.dtype)
        return x.flatten(2).transpose(1, 2)


class PatchConvEmbed(nn.Module):
    """Convolutional patch stem (network_def types 4/5)."""

    def __init__(self, img_size: int, patch_size: int, embed_dim: int, mid_chans: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        if patch_size % 2 or (img_size // 2) % (patch_size // 2):
            raise ValueError(f"conv stem needs an even patch dividing the image: "
                             f"{img_size}px, patch {patch_size}")
        half = patch_size // 2
        self.dtype = dtype
        self.conv1 = ConvBnAct(3, mid_chans, 2, dtype, generator)
        self.conv2 = ConvBnAct(mid_chans, mid_chans, 1, dtype, generator)
        self.conv3 = ConvBnAct(mid_chans, mid_chans, 1, dtype, generator)
        self.conv_proj = make_conv(mid_chans, embed_dim, half, half, 0, True, generator,
                                   "trunc_normal")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.permute(0, 3, 1, 2))
        x = self.conv3(self.conv2(x)) + x
        x = conv2d(x, self.conv_proj, self.dtype)
        return x.flatten(2).transpose(1, 2)
