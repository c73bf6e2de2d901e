"""The autograd guard of the CUDA kernel entries (``flash_attention``,
``fused_block``, ``fused_conformer``): the kernels have no backward, so an
entry that autograd would record raises instead of returning a result
whose gradient is missing."""

from __future__ import annotations

import torch


def forbid_autograd(entry: str, switch: str, *inputs) -> None:
    """The kernels have no backward (neither have the JAX package's Pallas
    calls): an entry whose result autograd would record raises, before it
    dispatches on the device, naming the switch that takes the plain path.
    ``inputs``: tensors, or dicts of them."""
    if not torch.is_grad_enabled():
        return
    for x in inputs:
        for t in (x.values() if isinstance(x, dict) else (x,)):
            if torch.is_tensor(t) and t.requires_grad:
                raise RuntimeError(
                    f"{entry} has no backward kernel and an input requires "
                    f"grad: train with {switch}=False (the plain path), or "
                    f"call it under torch.no_grad()")
