"""Dropout for the training forwards, with its masks drawn from an explicit
``torch.Generator`` (the JAX package draws them from a ``dropout`` key).

A module takes a ``drop`` callable, ``None`` in every inference path (so
inference stays bit-identical); the loss paths pass a ``Dropout``.  A test
can pass any callable ``x -> x'`` in its place, masks of its own included.
"""

from __future__ import annotations

import torch


class Dropout:
    """flax ``nn.Dropout(rate)`` with ``deterministic=False``: each element
    kept with probability 1 - rate and scaled by 1 / (1 - rate), zeroed
    otherwise; rate 0 is the identity and draws nothing.  The masks are
    drawn on the generator's device, so a host generator gives the card
    and the CPU the same masks.  ``rows=(lo, hi, total)``: the masks of a
    data-parallel rank, drawn for the global batch of ``total`` rows and
    cut to the rank's rows ``lo:hi``, so the ranks together draw the
    single-process step's masks."""

    def __init__(self, rate: float, generator: torch.Generator, rows=None):
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} not in [0, 1)")
        self.rate = rate
        self.generator = generator
        self.rows = rows

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        shape = x.shape
        if self.rows is not None:
            shape = (self.rows[2],) + tuple(shape[1:])
        keep = torch.rand(shape, generator=self.generator,
                          device=self.generator.device) < keep_prob
        if self.rows is not None:
            keep = keep[self.rows[0]:self.rows[1]]
        keep = keep.to(x.device)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))
