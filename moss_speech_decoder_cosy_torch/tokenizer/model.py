"""WhisperVQ speech tokenizer: 16 kHz log-mel -> tokens at 12.5 Hz, after
the JAX package's ``tokenizer/model.py`` (reference speech_tokenizer/
modeling_whisper.py):

- ``forward(mel, valid)``: causal convs (k3 s1, k3 s2), learned positions,
  N pre-LN causal attention layers with exact GELU; average pooling by 4,
  then the nearest codebook entry by L2 after layer ``quantize_position``;
- ``step(mel_chunk, state)``: the streaming twin with explicit conv caches
  and static KV caches of ``max_source_positions`` slots; the position is a
  device scalar, so a step reads nothing back to the host.

- ``encode_train(mel, valid, codebook)``: the training forward through
  the VQ against a codebook passed in, with the straight-through
  estimator.

Attention is a plain product and softmax, as the JAX package computes it
(no Pallas kernel), so PyTorch ops serve.  The post-VQ layers and the ASR
decoder are ``tokenizer/asr_decoder.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import WhisperVQConfig
from ..ops.convs import Conv1d
from ..ops.masks import mask_to_bias
from ..ops.norms import LayerNorm

_NEG = -1.0e10


@dataclasses.dataclass
class TokenizerStreamState:
    """Streaming caches, updated in place by ``WhisperVQEncoder.step``."""
    conv1_cache: torch.Tensor     # (B, 2, n_mels)
    conv2_cache: torch.Tensor     # (B, 2, d_model)
    k_cache: torch.Tensor         # (L, B, H, max_pos, dk)
    v_cache: torch.Tensor         # (L, B, H, max_pos, dk)
    pos: torch.Tensor             # () int64 on the device: positions cached


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class WhisperAttention(nn.Module):
    """Whisper self-attention: q, v and out with a bias, k without; q
    pre-scaled by dk^-0.5."""

    def __init__(self, heads: int, dim: int):
        super().__init__()
        self.heads, self.dim = heads, dim
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def _heads(self, y: torch.Tensor) -> torch.Tensor:
        b, t, _ = y.shape
        return y.reshape(b, t, self.heads, -1).transpose(1, 2)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return self._heads(self.q_proj(x) * (self.dim // self.heads) ** -0.5)

    def kv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._heads(self.k_proj(x)), self._heads(self.v_proj(x))

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """bias additive (B|1, 1, Tq, Tk) or None; ``kv`` the keys and values
        in head layout (the streaming caches), else the chunk's own."""
        b, t, _ = x.shape
        k, v = self.kv(x) if kv is None else kv
        scores = self.q(x) @ k.transpose(-1, -2)
        if bias is not None:
            scores = scores + bias
        out = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, t, self.dim))


class WhisperVQEncoderLayer(nn.Module):
    """Pre-LN attention and FFN (modeling_whisper.py:733-793)."""

    def __init__(self, cfg: WhisperVQConfig):
        super().__init__()
        self.self_attn_layer_norm = LayerNorm(cfg.d_model)
        self.self_attn = WhisperAttention(cfg.attention_heads, cfg.d_model)
        self.final_layer_norm = LayerNorm(cfg.d_model)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model)

    def forward(self, x, bias, kv=None):
        x = x + self.self_attn(self.self_attn_layer_norm(x), bias, kv)
        return x + self.fc2(_gelu(self.fc1(self.final_layer_norm(x))))

    def streaming_kv(self, x):
        """The chunk's k and v (head layout), for the caches."""
        return self.self_attn.kv(self.self_attn_layer_norm(x))


class WhisperVQEncoder(nn.Module):
    """The pre-VQ WhisperVQ encoder (parameter names as the JAX package's:
    ``conv1``, ``conv2``, ``embed_positions``, ``layers_i``,
    ``codebook``)."""

    def __init__(self, cfg: WhisperVQConfig):
        super().__init__()
        c = self.cfg = cfg
        self.conv1 = Conv1d(c.num_mel_bins, c.d_model, 3)
        self.conv2 = Conv1d(c.d_model, c.d_model, 3, stride=2)
        self.embed_positions = nn.Parameter(
            torch.empty(c.max_source_positions, c.d_model))
        self.layers: List[WhisperVQEncoderLayer] = []
        for i in range(c.quantize_position):
            layer = WhisperVQEncoderLayer(c)
            self.add_module(f"layers_{i}", layer)
            self.layers.append(layer)
        self.codebook = nn.Parameter(
            torch.empty(c.quantize_vocab_size, c.d_model))

    def seed_init(self, name, shape, g):
        """``weights.seeded_state``'s draw: the position table and the
        codebook normal(0.02)."""
        if name in ("embed_positions", "codebook"):
            return torch.randn(shape, generator=g) * 0.02
        return None

    # ------------------------------------------------------------- shared
    def _convs(self, mel: torch.Tensor,
               conv1_cache: Optional[torch.Tensor] = None,
               conv2_cache: Optional[torch.Tensor] = None):
        """mel (B, T, n_mels) -> (B, T // 2, d) and the new caches: the last
        2 input frames of each conv (modeling_whisper.py:131-156)."""
        x = (F.pad(mel, (0, 0, 2, 0)) if conv1_cache is None
             else torch.cat([conv1_cache.to(mel.dtype), mel], dim=1))
        new_c1 = x[:, -2:]
        x = _gelu(self.conv1(x))
        x2 = (F.pad(x, (0, 0, 2, 0)) if conv2_cache is None
              else torch.cat([conv2_cache.to(x.dtype), x], dim=1))
        new_c2 = x2[:, -2:]
        return _gelu(self.conv2(x2)), new_c1, new_c2

    def _pool_and_quantize(self, x: torch.Tensor, valid: torch.Tensor,
                           codebook: Optional[torch.Tensor] = None):
        """Average pooling by ``pooling_kernel_size``, then the nearest
        entry of ``codebook`` (the module's own by default) by L2: (ids,
        token_valid, pooled)."""
        k = self.cfg.pooling_kernel_size
        b, t, d = x.shape
        pad = (-t) % k
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            valid = F.pad(valid, (0, pad))
        x = x.reshape(b, -1, k, d).mean(dim=2)
        cb = self.codebook if codebook is None else codebook
        dist = ((x * x).sum(-1, keepdim=True) + (cb * cb).sum(-1)[None, None]
                - 2.0 * torch.einsum("btd,vd->btv", x, cb))
        return torch.argmin(dist, dim=-1), valid[:, ::k], x

    # -------------------------------------------------------------- batch
    def _trunk(self, mel: torch.Tensor, valid: torch.Tensor):
        """The layers before the VQ: (states (B, T // 2, d), valid2)."""
        c = self.cfg
        x, _, _ = self._convs(mel)
        t2 = x.shape[1]
        x = x + self.embed_positions[None, :t2]
        valid2 = valid[:, ::2]
        pos = torch.arange(t2, device=x.device)
        if c.causal_attention:
            allow = pos[None, :] <= pos[:, None]
        else:
            blk = c.quantize_causal_block_size
            allow = (pos[None, :] // blk) <= (pos[:, None] // blk)
        bias = mask_to_bias(allow[None] & valid2[:, None, :], x.dtype)[:, None]
        for layer in self.layers:
            x = layer(x, bias)
        return x, valid2

    def encode(self, mel: torch.Tensor, valid: torch.Tensor):
        """mel (B, T, n_mels), valid (B, T) -> (ids (B, ceil(T / 8)),
        token_valid, pooled pre-VQ features (B, ceil(T / 8), d))."""
        return self._pool_and_quantize(*self._trunk(mel, valid))

    def encode_train(self, mel: torch.Tensor, valid: torch.Tensor,
                     codebook: torch.Tensor):
        """The training forward through the VQ (modeling_whisper.py:
        1391-1464) against ``codebook``, the training codebook (its EMA
        updates take effect at once; the module's own is for inference):
        (hidden pre-VQ (B, Tt, d), quantized_st (B, Tt, d), ids,
        token_valid).  The straight-through estimator passes the gradient
        of ``quantized_st`` to ``hidden`` and none to ``codebook``."""
        ids, token_valid, hidden = self._pool_and_quantize(
            *self._trunk(mel, valid), codebook=codebook)
        quantized = codebook[ids]
        return (hidden, hidden + (quantized - hidden).detach(), ids,
                token_valid)

    def forward(self, mel: torch.Tensor, valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """mel (B, T, n_mels), valid (B, T) -> (token ids (B, ceil(T / 8)),
        token_valid)."""
        ids, token_valid, _ = self.encode(mel, valid)
        return ids, token_valid

    # ---------------------------------------------------------- streaming
    def init_state(self, batch_size: int = 1) -> TokenizerStreamState:
        c = self.cfg
        dev, dt = self.codebook.device, self.codebook.dtype

        def z(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)
        kv = (c.quantize_position, batch_size, c.attention_heads,
              c.max_source_positions, c.head_dim)
        return TokenizerStreamState(
            z(batch_size, 2, c.num_mel_bins), z(batch_size, 2, c.d_model),
            z(*kv), z(*kv), torch.zeros((), dtype=torch.long, device=dev))

    def step_features(self, mel_chunk: torch.Tensor,
                      state: TokenizerStreamState):
        """``step`` returning (ids, pooled pre-VQ features)."""
        c = self.cfg
        x, c1, c2 = self._convs(mel_chunk, state.conv1_cache,
                                state.conv2_cache)
        s2 = x.shape[1]
        if s2 % c.pooling_kernel_size:
            raise ValueError("a chunk is a multiple of 2 * "
                             "pooling_kernel_size mel frames")
        slots = state.pos + torch.arange(s2, device=x.device)
        x = x + self.embed_positions.index_select(0, slots)[None]
        # query i sees the cache slots up to its own position
        key_pos = torch.arange(c.max_source_positions, device=x.device)
        bias = torch.where(key_pos[None, :] <= slots[:, None],
                           torch.zeros((), dtype=x.dtype, device=x.device),
                           torch.full((), _NEG, dtype=x.dtype,
                                      device=x.device))[None, None]
        for i, layer in enumerate(self.layers):
            k_new, v_new = layer.streaming_kv(x)
            state.k_cache[i].index_copy_(2, slots, k_new.to(
                state.k_cache.dtype))
            state.v_cache[i].index_copy_(2, slots, v_new.to(
                state.v_cache.dtype))
            x = layer(x, bias, kv=(state.k_cache[i], state.v_cache[i]))
        ids, _, pooled = self._pool_and_quantize(
            x, torch.ones(x.shape[:2], dtype=torch.bool, device=x.device))
        state.conv1_cache.copy_(c1)
        state.conv2_cache.copy_(c2)
        state.pos.add_(s2)
        return ids, pooled

    def step(self, mel_chunk: torch.Tensor, state: TokenizerStreamState
             ) -> Tuple[torch.Tensor, TokenizerStreamState]:
        """mel_chunk (B, S, n_mels), S a multiple of 2 * pooling_kernel_size
        (8 frames = 80 ms) -> (token ids (B, S // 8), the state, updated in
        place).  forward_causal (modeling_whisper.py:1488-1610) over static
        KV caches."""
        ids, _ = self.step_features(mel_chunk, state)
        return ids, state
