"""DiT flow estimator, the cosyvoice1 DiffusionTransformer family, after the
JAX package's ``models/flow/dit.py`` (reference cosyvoice1/flow/stable/
dit.py:15-307, continuous transformer with a prepended global token;
blocks in stable/transformer.py):

- Fourier timestep features -> 2-layer MLP, plus the speaker x-vector
  through two bias-free linears with SiLU (``to_global_embed``); their sum
  is prepended as one token (dit.py:205-225);
- input [x ++ mu], bias-free residual 1x1 pre / post convs (held as
  Linear weights);
- blocks: scale-only LayerNorm -> fused-qkv self-attention with partial
  NeoX rotary (the first max(dk / 2, 32) channels) and a bias-free output
  -> scale-only LayerNorm -> GLU SwiGLU feed-forward;
- no final norm before the bias-free ``project_out``.

The attention is plain PyTorch (no Pallas kernel computes it in the JAX
package), with the JAX package's additive -1e10 key mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .cfm import CausalConditionalCFM
from ...utils.config import CFMConfig, EstimatorConfig


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    io_channels: int = 80
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    ff_mult: int = 4
    spk_embed_dim: int = 80              # global_cond_dim (x-vector affine)
    timestep_features_dim: int = 256
    rope_base: float = 10000.0


def tiny_dit_config() -> DiTConfig:
    return DiTConfig(io_channels=16, embed_dim=128, depth=2, num_heads=2,
                     ff_mult=2, spk_embed_dim=12, timestep_features_dim=16)


class FourierFeatures(nn.Module):
    """x (B, 1) -> [cos(2 pi f x), sin(2 pi f x)] with learned frequencies
    ``weight`` (out / 2, 1)."""

    def __init__(self, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features // 2, 1))

    def seed_init(self, name: str, shape, g: torch.Generator):
        return torch.randn(shape, generator=g)           # normal(1), as JAX

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = 2.0 * np.pi * x @ self.weight.t()
        return torch.cat([torch.cos(f), torch.sin(f)], dim=-1)


def rope_partial(x: torch.Tensor, base: float) -> torch.Tensor:
    """Partial NeoX rotary over (B, H, T, dk): rot_dim = max(dk // 2, 32)
    channels rotate, half / half (rotate_half, transformer.py:89-171), in
    f32.  Needs dk >= rot_dim."""
    dk = x.shape[-1]
    rot_dim = max(dk // 2, 32)
    if dk < rot_dim:
        raise ValueError(f"head dim {dk} below the rotary's {rot_dim}")
    half = rot_dim // 2
    pos = torch.arange(x.shape[2], dtype=torch.float32, device=x.device)
    inv = torch.from_numpy(1.0 / (base ** (
        np.arange(0, rot_dim, 2, dtype=np.float32) / rot_dim))).to(
        x.device, torch.float32)
    ang = pos[:, None] * inv[None, :]                     # (T, rot_dim / 2)
    cos, sin = torch.cos(ang)[None, None], torch.sin(ang)[None, None]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:rot_dim]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot, xf[..., rot_dim:]], dim=-1).to(x.dtype)


class ScaleOnlyLayerNorm(nn.Module):
    """Bias-less LayerNorm (transformer.py:174-194): learned ``weight``,
    fixed zero beta, eps 1e-5."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))

    def seed_init(self, name: str, shape, g: torch.Generator):
        return torch.ones(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight


class DiTBlock(nn.Module):
    """TransformerBlock (transformer.py:589-705, no adaLN / cross-attention /
    conformer): pre-LN fused-qkv attention + GLU SwiGLU feed-forward."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d, inner = cfg.embed_dim, cfg.embed_dim * cfg.ff_mult
        self.pre_norm = ScaleOnlyLayerNorm(d)
        self.to_qkv = nn.Linear(d, 3 * d, bias=False)
        self.attn_out = nn.Linear(d, d, bias=False)
        self.ff_norm = ScaleOnlyLayerNorm(d)
        self.ff_in = nn.Linear(d, 2 * inner)
        self.ff_out = nn.Linear(inner, d)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, t, _ = x.shape
        nh, dk = c.num_heads, c.embed_dim // c.num_heads
        q, k, v = self.to_qkv(self.pre_norm(x)).chunk(3, dim=-1)
        q, k, v = (y.reshape(b, t, nh, dk).transpose(1, 2) for y in (q, k, v))
        q, k = rope_partial(q, c.rope_base), rope_partial(k, c.rope_base)
        s = (q @ k.transpose(-1, -2)) / float(np.sqrt(dk)) + bias
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(
            b, t, c.embed_dim)
        x = x + self.attn_out(o)
        u, g = self.ff_in(self.ff_norm(x)).chunk(2, dim=-1)
        return x + self.ff_out(u * F.silu(g))


class DiTEstimator(nn.Module):
    """The U-Net's interface (x, valid, mu, t, spks, cond): the velocity
    (B, T, io_channels).  ``cond`` is accepted and unused, as in the
    reference CFM's DiT path (flow_matching_dit.py:57)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        io, d = cfg.io_channels, cfg.embed_dim
        self.preprocess = nn.Linear(2 * io, 2 * io, bias=False)
        self.project_in = nn.Linear(2 * io, d, bias=False)
        self.timestep_features = FourierFeatures(cfg.timestep_features_dim)
        self.ts_embed_1 = nn.Linear(cfg.timestep_features_dim, d)
        self.ts_embed_2 = nn.Linear(d, d)
        self.global_embed_1 = nn.Linear(cfg.spk_embed_dim, d, bias=False)
        self.global_embed_2 = nn.Linear(d, d, bias=False)
        self.blocks = []
        for i in range(cfg.depth):
            blk = DiTBlock(cfg)
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)
        self.project_out = nn.Linear(d, io, bias=False)
        self.postprocess = nn.Linear(io, io, bias=False)

    def forward(self, x: torch.Tensor, valid: torch.Tensor, mu: torch.Tensor,
                t: torch.Tensor, spks: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                streaming: bool = False) -> torch.Tensor:
        b = x.shape[0]
        h = torch.cat([x, mu], dim=-1)                    # input_concat_cond
        h = self.project_in(h + self.preprocess(h))
        ts = self.timestep_features(t[:, None].float()).to(h.dtype)
        g = self.ts_embed_2(F.silu(self.ts_embed_1(ts)))
        ge = self.global_embed_2(F.silu(self.global_embed_1(spks)))
        h = torch.cat([(g + ge)[:, None, :], h], dim=1)   # prepend
        key_ok = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                       device=x.device), valid], dim=1)
        bias = torch.where(key_ok[:, None, None, :],
                           torch.zeros((), dtype=h.dtype, device=h.device),
                           torch.full((), -1e10, dtype=h.dtype,
                                      device=h.device))
        for blk in self.blocks:
            h = blk(h, bias)
        out = self.project_out(h)[:, 1:]
        return (out + self.postprocess(out)) * valid[..., None].to(out.dtype)


class DiTConditionalCFM(CausalConditionalCFM):
    """The CFM Euler solver over the DiT estimator (the cosyvoice1
    flow_matching_dit.ConditionalCFM role): fixed noise, CFG batch of 2,
    f32 carry."""

    def __init__(self, cfg: CFMConfig, dit_cfg: DiTConfig):
        super().__init__(cfg, EstimatorConfig(),
                         estimator=DiTEstimator(dit_cfg))
        self.dit_cfg = dit_cfg
