"""Checkpoint averaging (the reference's bin/average_model.py), after the
JAX package's ``utils/export.py``.  That module's other tools compile and
serialize XLA programs, which have no counterpart here."""

from __future__ import annotations

from typing import Mapping, Sequence


def average_checkpoints(trees: Sequence[Mapping]) -> dict:
    """The uniform mean of nested mappings of tensors of one structure:
    summed in order, then divided by their count, as the JAX package
    does."""
    if not trees:
        raise ValueError("no checkpoints to average")

    def add(a, b):
        if isinstance(a, Mapping):
            return {k: add(a[k], b[k]) for k in a}
        return a + b

    def div(a, n):
        if isinstance(a, Mapping):
            return {k: div(v, n) for k, v in a.items()}
        return a / n

    out = trees[0]
    for tree in trees[1:]:
        out = add(out, tree)
    return div(out, len(trees))
