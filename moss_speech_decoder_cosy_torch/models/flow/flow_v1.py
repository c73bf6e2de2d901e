"""CosyVoice-v1 flow: MaskedDiffWithXvec + InterpolateRegulator, after the
JAX package's ``models/flow/flow_v1.py`` (reference cosyvoice/flow/flow.py:
24-148, length_regulator.py:21-85, flow_matching.py:44-74).

The stock GLM-4-Voice 22.05 kHz decoder and CosyVoice-300M use this stack:
a plain conformer text encoder, linear interpolation from 50 Hz tokens to
the 22050 / 256 Hz mel rate, and a non-causal two-level U-Net CFM whose
noise and mu carry a prompt + 34-frame cache from chunk to chunk.

With ``EstimatorConfig.use_flash_attention`` every U-Net block runs the
flash kernel at its own level's length (the full mel rate, then half of it
after the strided downsample).  The JAX estimator pads T to 512 once and
passes the full-rate length to every level, which masks the wrong keys at
the half-rate level and lets a non-causal block attend the padding; the
port's flash path equals the JAX masked-bias path (flash off).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .cfm import CausalConditionalCFM, t_span_cosine
from .encoder import ConformerEncoderLayer, LinearEmbed
from ...models.hift.generator import linear_interpolate
from ...ops.activations import mish
from ...ops.convs import Conv1d
from ...ops.embeddings import espnet_rel_pos, wenet_rel_pos
from ...ops.masks import chunk_attention_mask
from ...ops.norms import GroupNorm, LayerNorm
from ...utils.config import EncoderConfig, FlowConfig

# frames of z / mu the CFM cache carries past the prompt (flow_matching.py:68)
CACHE_TAIL = 34


class ConformerEncoder(nn.Module):
    """Plain wenet conformer encoder (no lookahead, no upsample), the v1
    flow's text encoder (reference transformer/encoder.py:368+).

    ``static_chunk_size > 0`` makes it the cosyvoice1 BlockConformerEncoder
    (cosyvoice1/transformer/encoder.py:477): its grid mask (causal, or
    within the query's own block) is the chunk mask with full left
    context."""

    def __init__(self, cfg: EncoderConfig, static_chunk_size: int = 0):
        super().__init__()
        self.cfg = cfg
        self.static_chunk_size = static_chunk_size
        self.embed = LinearEmbed(cfg.input_size, cfg.output_size)
        self.encoders = []
        for i in range(cfg.num_blocks):
            layer = ConformerEncoderLayer(cfg)
            self.add_module(f"encoders_{i}", layer)
            self.encoders.append(layer)
        self.after_norm = LayerNorm(cfg.output_size, eps=1e-5)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """x (B, T, input_size), valid bool (B, T) -> (B, T, output_size)."""
        c = self.cfg
        t = x.shape[1]
        x = self.embed(x)
        pos_fn = (espnet_rel_pos if c.pos_enc_layer_type == "rel_pos_espnet"
                  else wenet_rel_pos)
        pos = pos_fn(t, c.output_size, device=x.device).to(x.dtype)
        mask = chunk_attention_mask(valid, self.static_chunk_size)
        for layer in self.encoders:
            x = layer(x, mask, pos, valid)
        return self.after_norm(x)


def BlockConformerEncoder(cfg: EncoderConfig,
                          block_size: int = 25) -> ConformerEncoder:
    """The cosyvoice1 block-causal conformer (grid-masked attention)."""
    return ConformerEncoder(cfg, static_chunk_size=block_size)


class InterpolateRegulator(nn.Module):
    """Linear interpolation to the mel rate, then ``n_layers`` x (conv k3 ->
    GroupNorm(1) -> Mish) and a 1x1 conv (length_regulator.py:21-43)."""

    def __init__(self, channels: int, n_layers: int = 4, groups: int = 1):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", Conv1d(channels, channels, 3,
                                                padding=1))
            self.add_module(f"norm_{i}", GroupNorm(groups, channels,
                                                   eps=1e-5))
        self.out_conv = Conv1d(channels, channels, 1)

    def _stack(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"norm_{i}")(getattr(self, f"conv_{i}")(x))
            x = mish(x)
        return self.out_conv(x)

    def forward(self, x: torch.Tensor, out_len: int) -> torch.Tensor:
        return self._stack(linear_interpolate(x, out_len))

    def inference(self, x1: torch.Tensor, x2: torch.Tensor, mel_len1: int,
                  mel_len2: int, input_frame_rate: float = 50.0,
                  sample_rate: int = 22050, hop: int = 256) -> torch.Tensor:
        """Prompt (x1) and target (x2) interpolated apart; a target over 40
        tokens is split head / mid / tail at 20 tokens from each end, so
        stream chunks splice cleanly (length_regulator.py:52-73)."""
        if x2.shape[1] > 40:
            n_edge = int(20 / input_frame_rate * sample_rate / hop)
            x2 = torch.cat([
                linear_interpolate(x2[:, :20], n_edge),
                linear_interpolate(x2[:, 20:-20], mel_len2 - 2 * n_edge),
                linear_interpolate(x2[:, -20:], n_edge)], dim=1)
        else:
            x2 = linear_interpolate(x2, mel_len2)
        if x1.shape[1] != 0:
            x2 = torch.cat([linear_interpolate(x1, mel_len1), x2], dim=1)
        return self._stack(x2)


class ConditionalCFMWithCache(CausalConditionalCFM):
    """The v1 CFM: the fixed noise z, whose first frames and mu's come from
    the previous chunk's cache (the prompt's frames and the last 34), then
    the Euler solver with the CFG batch of 2 (flow_matching.py:44-74)."""

    def forward(self, mu: torch.Tensor, valid: torch.Tensor,
                spks: torch.Tensor, cond: torch.Tensor, prompt_len: int = 0,
                cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """cache (B, n, n_mel, 2) stacks [z, mu].  Returns (mel (B, T,
        n_mel) f32, new cache (B, prompt_len + 34, n_mel, 2))."""
        c = self.cfg
        b, t, d = mu.shape
        z = self._z(t, d, mu.device).expand(b, t, d).to(mu.dtype)
        if cache is not None and cache.shape[1] > 0:
            n = cache.shape[1]
            if n > t:
                # the reference fails on such a chunk (flow_matching.py:
                # 64-66): every window must cover the prompt + 34 frames
                raise ValueError(
                    f"v1 flow chunk too short: {t} mel frames < {n} cached "
                    f"(prompt + {CACHE_TAIL}); raise the token hop or "
                    f"overlap so that each window covers the cache")
            z = torch.cat([cache[..., 0].to(z.dtype), z[:, n:]], dim=1)
            mu = torch.cat([cache[..., 1].to(mu.dtype), mu[:, n:]], dim=1)
        new_cache = torch.stack([
            torch.cat([z[:, :prompt_len], z[:, -CACHE_TAIL:]], dim=1),
            torch.cat([mu[:, :prompt_len], mu[:, -CACHE_TAIL:]], dim=1)],
            dim=-1)

        sd = torch.float32 if c.solver_dtype == "float32" else mu.dtype
        t_span = (t_span_cosine(c.n_timesteps) if c.t_scheduler == "cosine"
                  else np.linspace(0, 1, c.n_timesteps + 1, dtype=np.float32))
        mu_in = torch.cat([mu, torch.zeros_like(mu)], dim=0)
        spks_in = torch.cat([spks, torch.zeros_like(spks)], dim=0)
        cond_in = torch.cat([cond, torch.zeros_like(cond)], dim=0)
        valid_in = torch.cat([valid, valid], dim=0)
        x = z.to(sd)
        for t_i, dt_i in zip(t_span[:-1], np.diff(t_span)):
            x = self.euler_step(x, float(t_i), float(dt_i), mu_in, valid_in,
                                spks_in, cond_in, streaming=False)
        return x.float(), new_cache


class MaskedDiffWithXvec(nn.Module):
    """The v1 flow (flow.py:24-148): token embedding -> conformer ->
    projection -> length regulation -> CFM with the flow cache."""

    def __init__(self, cfg: FlowConfig):
        super().__init__()
        self.cfg = cfg
        self.input_embedding = nn.Embedding(cfg.vocab_size, cfg.input_size)
        self.spk_embed_affine_layer = nn.Linear(cfg.spk_embed_dim,
                                                cfg.output_size)
        self.encoder = ConformerEncoder(cfg.encoder)
        self.encoder_proj = nn.Linear(cfg.encoder.output_size,
                                      cfg.output_size)
        self.length_regulator = InterpolateRegulator(cfg.output_size)
        self.decoder = ConditionalCFMWithCache(cfg.cfm, cfg.estimator)

    def inference(self, token: torch.Tensor, prompt_token: torch.Tensor,
                  prompt_feat: torch.Tensor, embedding: torch.Tensor,
                  mel_len2: int, flow_cache: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """token (B, T), prompt_token (B, P), prompt_feat (B, mel_len1,
        n_mel), embedding (B, spk_embed_dim) -> (mel (B, mel_len2, n_mel)
        f32 after the prompt, new flow cache).  ``mel_len2 =
        int(T / frame_rate * sample_rate / hop)`` comes from the caller
        (flow.py:128)."""
        c = self.cfg
        dt = self.encoder_proj.weight.dtype
        norm = torch.linalg.vector_norm(embedding, dim=-1, keepdim=True)
        spks = self.spk_embed_affine_layer(
            (embedding / torch.clamp(norm, min=1e-12)).to(dt))
        tokens = torch.cat([prompt_token, token], dim=1).long()
        valid = torch.ones(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
        h = self.encoder(self.input_embedding(torch.clamp(tokens, min=0)),
                         valid)
        h = self.encoder_proj(h)
        p = prompt_token.shape[1]
        mel_len1 = prompt_feat.shape[1]
        h = self.length_regulator.inference(
            h[:, :p], h[:, p:], mel_len1, mel_len2, c.input_frame_rate)
        conds = torch.zeros((h.shape[0], mel_len1 + mel_len2,
                             c.output_size), dtype=h.dtype, device=h.device)
        conds[:, :mel_len1] = prompt_feat.to(h.dtype)
        mel_valid = torch.ones((h.shape[0], mel_len1 + mel_len2),
                               dtype=torch.bool, device=h.device)
        feat, new_cache = self.decoder(h, mel_valid, spks=spks, cond=conds,
                                       prompt_len=mel_len1, cache=flow_cache)
        return feat[:, mel_len1:], new_cache
