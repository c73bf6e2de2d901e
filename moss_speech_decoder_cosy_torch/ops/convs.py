"""Convolutions on feature-last tensors, (B, T, C) and ``Conv2d``'s
(B, H, W, C), after the JAX package's ``ops/convs.py``.

Parameters are in torch layout: ``Conv1d`` weight (O, I/groups, K),
``ConvTranspose1d`` weight (I, O, K), ``Conv2d`` weight (O, I, KH, KW).
With ``weight_norm=True`` the direction ``v`` and gain ``g`` stay two
parameters and the kernel is ``g * v / max(||v||, 1e-12)`` (torch
``weight_norm(dim=0)``): the norm runs over all but the first axis, (I, K)
per output channel for ``Conv1d``, (O, K) per input channel for
``ConvTranspose1d``, (I, KH, KW) per output channel for ``Conv2d``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


def _weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """kernel = g * v / max(||v||, 1e-12), norm over all but axis 0."""
    rest = tuple(range(1, v.dim()))
    norm = torch.sqrt(torch.sum(v * v, dim=rest, keepdim=True))
    return v * (g.view((-1,) + (1,) * len(rest))
                / torch.clamp(norm, min=1e-12))


class _WeightedConv(nn.Module):
    """Holds ``weight`` or (``v``, ``g``) of a given shape, plus ``bias``."""

    def __init__(self, shape: Tuple[int, ...], bias_features: int,
                 use_bias: bool, weight_norm: bool):
        super().__init__()
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(torch.empty(shape))
            self.g = nn.Parameter(torch.empty(shape[0]))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = (nn.Parameter(torch.zeros(bias_features))
                     if use_bias else None)

    def kernel(self) -> torch.Tensor:
        if self.weight_norm:
            return _weight_norm(self.v, self.g)
        return self.weight


class Conv1d(_WeightedConv):
    """torch-style Conv1d on (B, T, C_in) -> (B, T', C_out)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, use_bias: bool = True,
                 weight_norm: bool = False):
        super().__init__((features, in_channels // groups, kernel_size),
                         features, use_bias, weight_norm)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.transpose(1, 2), self.kernel(), self.bias,
                     stride=self.stride, padding=self.padding,
                     dilation=self.dilation, groups=self.groups)
        return y.transpose(1, 2)


class CausalConv1d(nn.Module):
    """Left-padded conv (stride 1).  ``forward(x)`` pads (k-1)*d zeros on
    the left; ``forward(x, cache)`` consumes an explicit (B, (k-1)*d, C)
    cache and returns ``(y, new_cache)``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 dilation: int = 1, groups: int = 1, use_bias: bool = True,
                 weight_norm: bool = False):
        super().__init__()
        self.cache_len = (kernel_size - 1) * dilation
        self.conv = Conv1d(in_channels, features, kernel_size,
                           dilation=dilation, groups=groups,
                           use_bias=use_bias, weight_norm=weight_norm)

    def forward(self, x: torch.Tensor,
                cache: Optional[torch.Tensor] = None
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        pad = self.cache_len
        if cache is None:
            return self.conv(F.pad(x, (0, 0, pad, 0)))
        assert cache.shape[1] == pad, (cache.shape, pad)
        xp = torch.cat([cache, x], dim=1)
        return self.conv(xp), xp[:, xp.shape[1] - pad:, :]


class ConvTranspose1d(_WeightedConv):
    """torch nn.ConvTranspose1d: out_len = (T-1)*stride - 2*padding + k."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int, padding: int = 0, use_bias: bool = True,
                 weight_norm: bool = False):
        super().__init__((in_channels, features, kernel_size), features,
                         use_bias, weight_norm)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x.transpose(1, 2), self.kernel(), self.bias,
                               stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


class Conv2d(_WeightedConv):
    """torch-style Conv2d on (B, H, W, C_in) -> (B, H', W', C_out), symmetric
    integer padding per axis."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int], stride=(1, 1), padding=(0, 0),
                 use_bias: bool = True, weight_norm: bool = False):
        super().__init__((features, in_channels) + tuple(kernel_size),
                         features, use_bias, weight_norm)
        self.stride, self.padding = tuple(stride), tuple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel(), self.bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)
