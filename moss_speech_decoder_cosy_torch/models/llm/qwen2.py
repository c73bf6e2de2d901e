"""Qwen2 decoder-only transformer, the CosyVoice2 LM backbone, after the JAX
package's ``models/llm/qwen2.py`` (reference cosyvoice/llm/llm.py:231-260,
HF Qwen2ForCausalLM): RMSNorm, rotary embeddings, grouped-query attention
over a static KV cache, SwiGLU MLP.

The caches are tensors allocated once; every write lands in place at a
device position (``index_copy_`` / ``scatter_``), so a decode step reads no
host value and can be replayed as a CUDA graph.  The JAX package writes
with a one-hot read-modify-write (a TPU idiom); the port keeps its
semantics, not its mechanism.  Positions past the end of the cache are
clamped to its last slot, as ``dynamic_update_slice`` clamps its start;
callers keep prompt plus output within ``max_seq_len``.

Attention and products are plain PyTorch (the JAX package computes them
outside any Pallas kernel): grouped-query products, the scale and the JAX
package's -1e10 mask added into f32 in one call, an f32 softmax.
``scaled_dot_product_attention`` measured far slower for a decode step on
the H100 (cuDNN's flash kernel runs a 7-row query over 4096 keys on two
heads' worth of blocks).  RMSNorm is one ``F.rms_norm`` (statistics in
f32); the rotary tables and the mask are made once a forward.  A decode
step is several hundred small kernels, so their count sets its time on
the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

_NEG = -1.0e10
Index = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 896
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    ffn_size: int = 4864
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    max_seq_len: int = 4096

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def tiny_qwen2_config() -> Qwen2Config:
    return Qwen2Config(vocab_size=128, hidden_size=32, num_layers=2,
                       num_heads=4, num_kv_heads=2, ffn_size=64,
                       max_seq_len=128)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor           # (L, B, H_kv, max_len, dk)
    v: torch.Tensor
    length: torch.Tensor      # () int64 on the cache's device


@dataclasses.dataclass
class SlotKVCache:
    """Per-slot KV cache for continuous batching: every row is a request at
    its own position (``serving/lm_server.py``).  Two-tier mode
    (``recent_k is not None``): per-token writes land in a small recent ring
    and are flushed into the main cache in bulk (``flush_slots``); attention
    scores [main ++ recent] together.  ``flushed`` is each slot's valid
    length in the main cache."""
    k: torch.Tensor           # (L, B, H_kv, max_len, dk)
    v: torch.Tensor
    lengths: torch.Tensor     # (B,) int64
    recent_k: Optional[torch.Tensor] = None   # (L, B, H_kv, R, dk)
    recent_v: Optional[torch.Tensor] = None
    flushed: Optional[torch.Tensor] = None    # (B,) int64


def rope_angles(positions: torch.Tensor, dk: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) f32 of shape positions.shape + (dk/2,)."""
    inv = 1.0 / (theta ** (torch.arange(0, dk, 2, device=positions.device,
                                        dtype=torch.float32) / dk))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, H, T, dk); cos / sin (both halves, x's dtype) broadcastable to
    it: [x1 cos - x2 sin, x2 cos + x1 sin]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return torch.addcmul(x * cos, rot, sin)


def _tables(positions: torch.Tensor, dk: int, theta: float, dtype):
    cos, sin = rope_angles(positions, dk, theta)
    return (torch.cat([cos, cos], -1).to(dtype),
            torch.cat([sin, sin], -1).to(dtype))


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float
          ) -> torch.Tensor:
    """x (B, H, T, dk); positions (T,) absolute."""
    cos, sin = _tables(positions, x.shape[-1], theta, x.dtype)
    return apply_rope(x, cos[None, None], sin[None, None])


def _rope_b(x: torch.Tensor, positions: torch.Tensor, theta: float
            ) -> torch.Tensor:
    """x (B, H, T, dk); positions (B, T) per-row absolute."""
    cos, sin = _tables(positions, x.shape[-1], theta, x.dtype)
    return apply_rope(x, cos[:, None], sin[:, None])


def _angles(positions: torch.Tensor, cfg: Qwen2Config, dtype):
    """The rotary tables of a forward in its dtype, made once and laid out
    for (B, H, T, dk): from shared positions (T,) or per-row ones (B, T)."""
    cos, sin = _tables(positions, cfg.head_dim, cfg.rope_theta, dtype)
    if positions.dim() == 1:
        return cos[None, None], sin[None, None]
    return cos[:, None], sin[:, None]


def gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B, H, T, dk), k (B, Hkv, S, dk) -> raw scores (B, Hkv, rep, T, S),
    query head h reading key head h // rep (``jnp.repeat`` of the keys)
    without repeating the keys."""
    b, h, t, dk = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, (h // hkv) * t, dk)
    return (qg @ k.transpose(-1, -2)).view(b, hkv, h // hkv, t, k.shape[2])


def gqa_mix(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (B, Hkv, rep, T, S) f32 weights, v (B, Hkv, S, dk) ->
    (B, H, T, dk) in v's dtype."""
    b, hkv, rep, t, s = p.shape
    out = p.to(v.dtype).reshape(b, hkv, rep * t, s) @ v
    return out.view(b, hkv * rep, t, v.shape[-1])


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # statistics in f32 (the JAX package's), one fused call on the card
        return F.rms_norm(x, (x.shape[-1],), self.weight, self.eps)

    def seed_init(self, name, shape, g):
        return torch.ones(shape, device="cpu")


class Qwen2Layer(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        h, hkv, dk, d = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         cfg.hidden_size)
        self.input_layernorm = RMSNorm(d, cfg.norm_eps)
        self.q_proj = nn.Linear(d, h * dk)
        self.k_proj = nn.Linear(d, hkv * dk)
        self.v_proj = nn.Linear(d, hkv * dk)
        self.o_proj = nn.Linear(h * dk, d, bias=False)
        self.post_attention_layernorm = RMSNorm(d, cfg.norm_eps)
        self.gate_proj = nn.Linear(d, cfg.ffn_size, bias=False)
        self.up_proj = nn.Linear(d, cfg.ffn_size, bias=False)
        self.down_proj = nn.Linear(cfg.ffn_size, d, bias=False)

    def _heads(self, x: torch.Tensor, n: int) -> torch.Tensor:
        b, t, _ = x.shape
        return x.view(b, t, n, self.cfg.head_dim).transpose(1, 2)

    def q(self, h, cos, sin) -> torch.Tensor:
        return apply_rope(self._heads(self.q_proj(h), self.cfg.num_heads),
                          cos, sin)

    def kv(self, h, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rotary keys and values (B, Hkv, T, dk) of the normed input."""
        hkv = self.cfg.num_kv_heads
        k = apply_rope(self._heads(self.k_proj(h), hkv), cos, sin)
        return k, self._heads(self.v_proj(h), hkv)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """(B, H, T, dk) -> o_proj of the heads side by side."""
        b, _, t, _ = o.shape
        return self.o_proj(o.transpose(1, 2).reshape(b, t, -1))

    def attend(self, h, cos, sin, k_all, v_all, bias) -> torch.Tensor:
        """h (B, T, D) normed; k_all / v_all (B, Hkv, S, dk) the full key
        set, rotary applied; bias f32 (B|1, 1, T, S)."""
        sc = torch.add(bias[:, :, None], gqa_scores(self.q(h, cos, sin),
                                                    k_all),
                       alpha=1.0 / math.sqrt(self.cfg.head_dim))
        return self.out(gqa_mix(torch.softmax(sc, dim=-1), v_all))

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = self.post_attention_layernorm(x)
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


def _bias(allow: torch.Tensor) -> torch.Tensor:
    return torch.where(allow, 0.0, _NEG)



class Qwen2Model(nn.Module):
    """The backbone on input EMBEDDINGS (the speech LM feeds mixed
    text / speech / special embeddings, llm.py:296-330)."""

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = []
        for i in range(cfg.num_layers):
            layer = Qwen2Layer(cfg)
            # children carry the JAX package's parameter names (weights.py)
            self.add_module(f"layers_{i}", layer)
            self.layers.append(layer)
        self.norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)

    def _like(self):
        w = self.embed_tokens.weight
        return w.dtype, w.device

    def init_cache(self, batch: int = 1, dtype=None) -> KVCache:
        c = self.cfg
        pdt, dev = self._like()
        shape = (c.num_layers, batch, c.num_kv_heads, c.max_seq_len,
                 c.head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype or pdt, device=dev),
                       v=torch.zeros(shape, dtype=dtype or pdt, device=dev),
                       length=torch.zeros((), dtype=torch.long, device=dev))

    # ------------------------------------------------------ slot serving
    def init_slot_cache(self, batch: int, dtype=None,
                        recent: int = 0) -> SlotKVCache:
        """``recent > 0``: the two-tier cache with an R = recent ring (flush
        at least every ``recent - 1`` decode steps)."""
        c = self.cfg
        pdt, dev = self._like()
        dt = dtype or pdt
        shape = (c.num_layers, batch, c.num_kv_heads, c.max_seq_len,
                 c.head_dim)
        extra = {}
        if recent > 0:
            rshape = shape[:3] + (recent, c.head_dim)
            extra = dict(recent_k=torch.zeros(rshape, dtype=dt, device=dev),
                         recent_v=torch.zeros(rshape, dtype=dt, device=dev),
                         flushed=torch.zeros(batch, dtype=torch.long,
                                             device=dev))
        return SlotKVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                           v=torch.zeros(shape, dtype=dt, device=dev),
                           lengths=torch.zeros(batch, dtype=torch.long,
                                               device=dev), **extra)

    def flush_slots(self, cache: SlotKVCache) -> SlotKVCache:
        """Two-tier: copy each slot's recent rows 0..lengths-flushed-1 into
        the main cache at its flushed offset, in place; rows past the fill
        are written back unchanged."""
        r, s = cache.recent_k.shape[-2], cache.k.shape[-2]
        n_layers, b, hkv, _, dk = cache.k.shape
        ar = torch.arange(r, device=cache.k.device)
        ok = ar[None] < (cache.lengths - cache.flushed)[:, None]     # (B, R)
        idx = (cache.flushed[:, None] + ar[None]).clamp(max=s - 1)
        idx = idx.view(1, b, 1, r, 1).expand(n_layers, b, hkv, r, dk)
        ok = ok.view(1, b, 1, r, 1)
        for main, rec in ((cache.k, cache.recent_k),
                          (cache.v, cache.recent_v)):
            main.scatter_(3, idx, torch.where(ok, rec, main.gather(3, idx)))
            rec.zero_()
        cache.flushed.copy_(cache.lengths)
        return cache

    def prefill_slot(self, cache: SlotKVCache, slot: int,
                     embeds: torch.Tensor, n_valid: int
                     ) -> Tuple[torch.Tensor, SlotKVCache]:
        """Prefill ONE slot with a fresh prompt (positions from 0): embeds
        (1, P, D), ``n_valid`` of them real.  Writes the slot's rows 0..P-1
        in place; returns (hidden at the last valid position (1, D),
        cache)."""
        c = self.cfg
        p = embeds.shape[1]
        positions = torch.arange(p, device=embeds.device)
        allow = (positions[None, :] <= positions[:, None]) \
            & (positions[None, :] < n_valid)
        bias = _bias(allow)[None, None]
        cos, sin = _angles(positions, c, embeds.dtype)
        x = embeds
        for i, layer in enumerate(self.layers):
            h = layer.input_layernorm(x)
            k_new, v_new = layer.kv(h, cos, sin)      # (1, Hkv, P, dk)
            cache.k[i, slot, :, :p] = k_new[0]
            cache.v[i, slot, :, :p] = v_new[0]
            x = x + layer.attend(h, cos, sin, k_new, v_new, bias)
            x = x + layer.mlp(x)
        x = self.norm(x)
        cache.lengths[slot] = n_valid
        if cache.flushed is not None:       # two-tier: the prompt is main
            cache.flushed[slot] = n_valid
        return x[:, n_valid - 1], cache

    def decode_step_slots(self, embeds: torch.Tensor, cache: SlotKVCache,
                          advance: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, SlotKVCache]:
        """One decode step for ALL slots: embeds (B, 1, D), each slot at its
        own position.  Each slot's K/V lands at its position in place;
        ``advance`` (B,) bool: slots with False keep their length (a
        finished slot overwrites the same position harmlessly).  Returns
        (hidden (B, D), cache)."""
        c = self.cfg
        s = c.max_seq_len
        b = embeds.shape[0]
        lengths = cache.lengths
        positions = lengths[:, None]                      # (B, 1)
        cos, sin = _angles(positions, c, embeds.dtype)
        key_pos = torch.arange(s, device=embeds.device)
        tiered = cache.recent_k is not None
        hkv, dk = c.num_kv_heads, c.head_dim
        if tiered:
            r = cache.recent_k.shape[-2]
            rpos = lengths - cache.flushed                # (B,) in [0, R)
            at = rpos.clamp(0, r - 1)
            bias_main = _bias(key_pos[None] < cache.flushed[:, None])
            bias_rec = _bias(torch.arange(r, device=embeds.device)[None]
                             <= rpos[:, None])
            bias = torch.cat([bias_main, bias_rec], -1)[:, None, None,
                                                          None, :]
        else:
            at = lengths.clamp(max=s - 1)
            bias = _bias(key_pos[None] <= lengths[:, None])[:, None, None]
        at = at.view(b, 1, 1, 1).expand(b, hkv, 1, dk)
        scale = 1.0 / math.sqrt(dk)

        x = embeds
        for i, layer in enumerate(self.layers):
            h = layer.input_layernorm(x)
            k_new, v_new = layer.kv(h, cos, sin)          # (B, Hkv, 1, dk)
            if tiered:
                cache.recent_k[i].scatter_(2, at, k_new.to(cache.k.dtype))
                cache.recent_v[i].scatter_(2, at, v_new.to(cache.v.dtype))
                q = layer.q(h, cos, sin)
                sc = torch.cat([gqa_scores(q, cache.k[i]),
                                gqa_scores(q, cache.recent_k[i])], -1)
                p = torch.softmax(torch.add(bias, sc, alpha=scale), dim=-1)
                o = gqa_mix(p[..., :s], cache.v[i]) + gqa_mix(
                    p[..., s:], cache.recent_v[i])
                x = x + layer.out(o)
            else:
                cache.k[i].scatter_(2, at, k_new.to(cache.k.dtype))
                cache.v[i].scatter_(2, at, v_new.to(cache.v.dtype))
                x = x + layer.attend(h, cos, sin, cache.k[i], cache.v[i],
                                     bias)
            x = x + layer.mlp(x)
        x = self.norm(x)[:, 0]
        lengths += 1 if advance is None else advance.long()
        return x, cache

    def forward_causal(self, embeds: torch.Tensor) -> torch.Tensor:
        """The training forward: causal attention over ``embeds`` (B, T, D)
        at positions 0..T-1 with no cache (autograd records no in-place
        write, and no ``max_seq_len``-slot cache is allocated); the hidden
        states (B, T, D), equal to ``forward_embeds`` on a fresh cache."""
        t = embeds.shape[1]
        positions = torch.arange(t, device=embeds.device)
        bias = _bias(positions[None, :] <= positions[:, None])[None, None]
        cos, sin = _angles(positions, self.cfg, embeds.dtype)
        x = embeds
        for layer in self.layers:
            h = layer.input_layernorm(x)
            k, v = layer.kv(h, cos, sin)
            x = x + layer.attend(h, cos, sin, k, v, bias)
            x = x + layer.mlp(x)
        return self.norm(x)

    def forward_embeds(self, embeds: torch.Tensor, cache: KVCache,
                       n_valid: Optional[Index] = None
                       ) -> Tuple[torch.Tensor, KVCache]:
        """Append ``embeds`` (B, T, D) to the cache in place and return the
        hidden states (B, T, D) and the cache; prefill (T = prompt) and
        decode (T = 1).  ``n_valid`` (int or device scalar, default T) of
        the T positions count: the cache's length grows by it."""
        c = self.cfg
        t = embeds.shape[1]
        pos0 = cache.length
        positions = pos0 + torch.arange(t, device=embeds.device)
        if n_valid is None:
            n_valid = t
        key_pos = torch.arange(c.max_seq_len, device=embeds.device)
        allow = (key_pos[None, :] <= positions[:, None]) \
            & (key_pos[None, :] < pos0 + n_valid)
        bias = _bias(allow)[None, None]
        cos, sin = _angles(positions, c, embeds.dtype)
        at = positions.clamp(max=c.max_seq_len - 1)

        x = embeds
        for i, layer in enumerate(self.layers):
            h = layer.input_layernorm(x)
            k_new, v_new = layer.kv(h, cos, sin)
            cache.k[i].index_copy_(2, at, k_new.to(cache.k.dtype))
            cache.v[i].index_copy_(2, at, v_new.to(cache.v.dtype))
            x = x + layer.attend(h, cos, sin, cache.k[i], cache.v[i], bias)
            x = x + layer.mlp(x)
        cache.length += n_valid
        return self.norm(x), cache
