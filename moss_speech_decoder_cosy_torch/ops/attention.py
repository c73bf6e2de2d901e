"""Attention modules, after the JAX package's ``ops/attention.py``.

- ``RelPositionMultiHeadedAttention``: Transformer-XL relative-position
  attention of the flow encoder (reference transformer/attention.py:
  300-470).  With the wenet ``rel_pos`` table (length T) there is no
  rel-shift; with the espnet table (2T-1) the ESPnet rel-shift applies.
- ``UNetAttention``: diffusers self-attention of the estimator's
  BasicTransformerBlock (bias-free q/k/v, additive bias mask).  With
  ``flash_chunk >= 0`` it calls the flash chunk-attention kernel on its
  feature-last projections, with no transposes.

Masked logits get a large negative value and fully masked rows give zeros.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .flash_attention import flash_chunk_attention_fl

_NEG = -1.0e10


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """softmax over the last axis with a bool attend-mask; masked -> 0."""
    if mask is None:
        return torch.softmax(scores, dim=-1)
    scores = torch.where(mask, scores, torch.full((), _NEG,
                                                  dtype=scores.dtype,
                                                  device=scores.device))
    attn = torch.softmax(scores, dim=-1)
    return torch.where(mask, attn, torch.zeros((), dtype=attn.dtype,
                                               device=attn.device))


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T), ESPnet rel-shift."""
    b, h, t, p = x.shape
    xp = torch.cat([x.new_zeros((b, h, t, 1)), x], dim=-1)
    xp = xp.reshape(b, h, p + 1, t)[:, :, 1:, :].reshape(b, h, t, p)
    return xp[..., : p // 2 + 1]


class RelPositionMultiHeadedAttention(nn.Module):
    def __init__(self, heads: int, dim: int, key_bias: bool = True):
        super().__init__()
        self.heads = heads
        self.dim = dim
        dk = dim // heads
        self.linear_q = nn.Linear(dim, dim)
        self.linear_k = nn.Linear(dim, dim, bias=key_bias)
        self.linear_v = nn.Linear(dim, dim)
        self.linear_pos = nn.Linear(dim, dim, bias=False)
        self.linear_out = nn.Linear(dim, dim)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, dk))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, dk))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        h, dk = self.heads, self.dim // self.heads
        q = self.linear_q(x).reshape(b, t, h, dk)
        k = self.linear_k(x).reshape(b, t, h, dk)
        v = self.linear_v(x).reshape(b, t, h, dk)
        p = self.linear_pos(pos_emb).reshape(1, -1, h, dk).transpose(1, 2)

        q_u = (q + self.pos_bias_u).transpose(1, 2)
        q_v = (q + self.pos_bias_v).transpose(1, 2)
        matrix_ac = q_u @ k.permute(0, 2, 3, 1)             # (B,H,T,T)
        matrix_bd = q_v @ p.transpose(-1, -2)               # (B,H,T,P)
        if matrix_bd.shape[-1] != matrix_ac.shape[-1]:
            matrix_bd = _rel_shift(matrix_bd)
        scores = (matrix_ac + matrix_bd) / torch.full(
            (), dk, dtype=x.dtype, device=x.device).sqrt()
        if mask is not None and mask.dim() == 3:
            mask = mask[:, None]
        attn = masked_softmax(scores, mask)
        out = (attn @ v.transpose(1, 2)).transpose(1, 2).reshape(
            b, t, self.dim)
        return self.linear_out(out)


class UNetAttention(nn.Module):
    """diffusers self-attention: bias-free q/k/v, additive float bias.

    ``flash_chunk >= 0`` computes attention with the analytic chunk-causal
    mask of the flash kernel instead of a bias (all positions valid)."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.heads = heads
        self.head_dim = head_dim
        inner = heads * head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None,
                flash_chunk: int = -1) -> torch.Tensor:
        b, t, _ = x.shape
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        if flash_chunk >= 0:
            out = flash_chunk_attention_fl(q, k, v, self.heads,
                                           chunk_size=flash_chunk)
            return self.to_out(out)

        def split(y):
            return y.reshape(b, t, self.heads, self.head_dim).transpose(1, 2)

        scores = (split(q) @ split(k).transpose(-1, -2)) * (
            self.head_dim ** -0.5)
        if attn_bias is not None:
            if attn_bias.dim() == 3:
                attn_bias = attn_bias[:, None]
            scores = scores + attn_bias
        attn = torch.softmax(scores, dim=-1)
        out = (attn @ split(v)).transpose(1, 2).reshape(b, t, -1)
        return self.to_out(out)
