"""Mask algebra for chunked / streaming attention (bool, True == attend).

Mirrors the JAX package's ``ops/masks.py``: ``subsequent_chunk_mask``
(reference mask.py:127-158), ``chunk_attention_mask`` (static chunk,
full left context composed with the key padding mask) and ``mask_to_bias``
(reference common.py:160-168, the -1e10 constant).
"""

from __future__ import annotations

import torch


def subsequent_chunk_mask(size: int, chunk_size: int,
                          num_left_chunks: int = -1,
                          device=None) -> torch.Tensor:
    """Chunk-causal bool mask (size, size): row i attends columns
    [start, (i//chunk + 1) * chunk), start 0 for full left context."""
    idx = torch.arange(size, device=device)
    chunk_idx = idx // chunk_size
    ending = (chunk_idx + 1) * chunk_size
    allow = idx[None, :] < ending[:, None]
    if num_left_chunks >= 0:
        start = torch.clamp((chunk_idx - num_left_chunks) * chunk_size, min=0)
        allow = allow & (idx[None, :] >= start[:, None])
    return allow


def chunk_attention_mask(valid: torch.Tensor, static_chunk_size: int,
                         num_left_chunks: int = -1) -> torch.Tensor:
    """valid bool (B, T) -> bool (B, T, T) attend mask; chunk 0 = full."""
    b, t = valid.shape
    key_ok = valid[:, None, :]
    if static_chunk_size > 0:
        chunk = subsequent_chunk_mask(t, static_chunk_size, num_left_chunks,
                                      device=valid.device)
        return key_ok & chunk[None, :, :]
    return key_ok.expand(b, t, t)


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """bool attend-mask -> additive bias (0 where attend, -1e10 else)."""
    return (1.0 - mask.to(dtype)) * torch.full((), -1.0e10, dtype=dtype,
                                               device=mask.device)
