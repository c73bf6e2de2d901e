"""Positional / timestep embeddings, after the JAX package's
``ops/embeddings.py``.

- ``wenet_rel_pos``: the ``rel_pos`` table of the CosyVoice2/MOSS encoders
  (length T, no rel-shift; reference class_utils.py:64).
- ``espnet_rel_pos``: the ``rel_pos_espnet`` table (2T-1, rel-shift;
  reference embedding.py:201-292).
- ``SinusoidalPosEmb`` + ``TimestepEmbedding``: the Matcha/diffusers time
  embedding of the flow estimator (reference flow/decoder.py:318-324).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@functools.lru_cache(maxsize=None)
def _rel_pe_table(d_model: int, max_len: int) -> np.ndarray:
    """(2*max_len-1, d_model): positive positions flipped, then negative
    ones, as EspnetRelPositionalEncoding.extend_pe."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(math.log(10000.0) / d_model))
    pe_pos = np.zeros((max_len, d_model))
    pe_neg = np.zeros((max_len, d_model))
    pe_pos[:, 0::2] = np.sin(position * div)
    pe_pos[:, 1::2] = np.cos(position * div)
    pe_neg[:, 0::2] = np.sin(-position * div)
    pe_neg[:, 1::2] = np.cos(-position * div)
    pe = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)
    return pe.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _abs_pe_table(d_model: int, max_len: int) -> np.ndarray:
    """Sinusoid table pe[pos] (wenet PositionalEncoding)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe.astype(np.float32)


# (kind, d_model, device) -> (length, the table on the device)
_ON_DEVICE: Dict[Tuple[str, int, str], Tuple[int, torch.Tensor]] = {}
# tables that a longer one replaced: a CUDA graph captured on one still
# reads it
_REPLACED: List[torch.Tensor] = []


def _table(kind: str, d_model: int, length: int, device) -> torch.Tensor:
    """The ``kind`` table ("rel" or "abs") of at least ``length`` positions
    on ``device``, uploaded once and regrown by doubling, so a step captured
    in a CUDA graph slices it with no upload.  A position's entry does not
    depend on the table's length.  The table is a normal tensor even when
    inference mode builds it, so a training forward may use it too."""
    key = (kind, d_model, str(torch.device(device or "cpu")))
    got = _ON_DEVICE.get(key)
    if got is None or got[0] < length:
        if got is not None:
            _REPLACED.append(got[1])
        n = max(length, 16, 2 * got[0] if got else 0)
        make = _rel_pe_table if kind == "rel" else _abs_pe_table
        with torch.inference_mode(False):
            got = _ON_DEVICE[key] = (n, torch.from_numpy(
                make(d_model, n)).to(device or "cpu"))
    return got[1]


def espnet_rel_pos(size: int, d_model: int, device=None) -> torch.Tensor:
    """(1, 2*size-1, d_model) for relative offsets size-1 .. -(size-1)."""
    table = _table("rel", d_model, size, device)
    center = table.shape[0] // 2
    return table[center - size + 1: center + size][None]


def wenet_rel_pos(size: int, d_model: int, offset: int = 0,
                  device=None) -> torch.Tensor:
    """(1, size, d_model) = pe[offset : offset + size]."""
    table = _table("abs", d_model, size + offset, device)
    return table[offset: offset + size][None]


class SinusoidalPosEmb(nn.Module):
    """Matcha SinusoidalPosEmb: t (B,) -> (B, dim) in t's dtype, with scale
    1000.

    As in the JAX package, ``scale * t`` and its product with the frequency
    table (made in f32) are rounded in t's dtype, and sin / cos run on the
    rounded argument: in bf16 the reference's time embedding is a bf16 one.
    Computing it in f32 from bf16 t drove the port's bf16 mel 1.6x further
    from its f32 mel than the reference's."""

    def __init__(self, dim: int, scale: float = 1000.0):
        super().__init__()
        self.dim = dim
        self.scale = scale

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, device=t.device,
                                       dtype=torch.float32)
                          * -(math.log(10000.0) / (half - 1)))
        emb = (self.scale * t)[:, None] * freqs.to(t.dtype)[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    """diffusers TimestepEmbedding: Linear -> silu -> Linear."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))
