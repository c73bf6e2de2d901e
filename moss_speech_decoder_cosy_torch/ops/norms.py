"""LayerNorm / GroupNorm with flax's statistics.

flax ``nn.LayerNorm`` / ``nn.GroupNorm`` (``use_fast_variance``,
``force_float32_reductions``): statistics in f32, variance
``E[x^2] - E[x]^2`` clipped at 0, ``y = (x - mean) * (rsqrt(var + eps) *
scale) + bias`` in f32, cast back to the input dtype.  The JAX package's
``ops/pallas_block.py::_ln`` documents the same formula.
"""

from __future__ import annotations

import torch
from torch import nn


def _normalize(xf: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               eps: float, scale: torch.Tensor, bias: torch.Tensor
               ) -> torch.Tensor:
    mul = torch.rsqrt(var + eps) * scale.float()
    return (xf - mean) * mul + bias.float()


class LayerNorm(nn.Module):
    """Normalizes the last axis; params ``weight`` (flax ``scale``), ``bias``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return _normalize(xf, mean, var, self.eps, self.weight,
                          self.bias).to(x.dtype)


class GroupNorm(nn.Module):
    """torch ``nn.GroupNorm`` grouping on a (B, T, C) tensor: statistics
    over time and the channels of each group."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        g = self.num_groups
        xf = x.float().reshape(b, t, g, c // g)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(1, 3), keepdim=True)
                          - mean * mean, min=0.0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(b, t, c)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)
