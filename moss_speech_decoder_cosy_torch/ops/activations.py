"""Activation functions (feature-last layout), after the JAX package's
``ops/activations.py``.

Snake is the reference's linear-scale variant
(cosyvoice/transformer/activation.py:34-79): ``x + sin^2(a x) / (a + 1e-9)``
with a per-channel trainable ``alpha`` (init 1) on the last axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation, alpha shaped (C,) broadcasting over (..., C)."""
    s = torch.sin(alpha * x)
    return x + s * s / (alpha + 1e-9)


class Snake(nn.Module):
    """Per-channel snake with trainable alpha (linear scale, init 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha)


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def get_activation(name: str):
    """Registry mirroring cosyvoice/utils/class_utils.py's activation map;
    GELU is the exact (erf) form."""
    return {
        "relu": F.relu,
        "gelu": _gelu_exact,
        "swish": F.silu,
        "silu": F.silu,
        "mish": mish,
        "tanh": torch.tanh,
        "elu": F.elu,
    }[name]
