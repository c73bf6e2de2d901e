"""v-prediction diffusion flow (the cosyvoice1 GradTTS / stable-audio fork),
after the JAX package's ``models/flow/vdiff.py``.

- ``VDiffusion``: the DDIM-style v-diffusion sampler
  (cosyvoice1/flow/stable/sampling.py:48-88) over the rotary DiT of
  ``dit.py``, with alpha = cos(t pi / 2), sigma = sin(t pi / 2) tables
  computed on the host as the JAX package does, the DDIM state in f32, the
  optional CFG batch of 2;
- ``GradTTSDiffWithXvec`` (cosyvoice1/flow/flow_gradtts.py:24-142): the v1
  token encoder and interpolating length regulator feeding the sampler.

Training: the v-objective loss (``VDiffusion.compute_loss``,
``GradTTSDiffWithXvec.loss``; stable_diffusion.py:71-93), its draws passed
in as ``VDiffDraws``, and the scrambled Sobol timestep draws
(``sobol_times``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .cfm import _fixed_noise
from .dit import DiTConfig, DiTEstimator
from .flow_v1 import ConformerEncoder, InterpolateRegulator
from ...utils.config import FlowConfig

# the sampler's fixed noise buffer (the JAX package's 16384 frames)
NOISE_LEN = 16384


def get_alphas_sigmas(t: np.ndarray):
    """sampling.py:8-11: the cos / sin schedule."""
    return np.cos(t * np.pi / 2), np.sin(t * np.pi / 2)


def ddim_tables(n_timesteps: int, eta: float):
    """(t, alphas, sigmas, next alphas, adjusted next sigmas, ddim noise
    scale) of the sampler's steps, float32 numpy, the JAX package's
    arithmetic."""
    t = np.linspace(1.0, 0.0, n_timesteps + 1, dtype=np.float32)[:-1]
    alphas, sigmas = get_alphas_sigmas(t)
    a_next = np.concatenate([alphas[1:], [1.0]]).astype(np.float32)
    s_next = np.concatenate([sigmas[1:], [0.0]]).astype(np.float32)
    ddim = eta * np.sqrt(s_next ** 2 / np.maximum(sigmas ** 2, 1e-12)) \
        * np.sqrt(np.maximum(1 - alphas ** 2 /
                             np.maximum(a_next ** 2, 1e-12), 0.0))
    adj = np.sqrt(np.maximum(s_next ** 2 - ddim ** 2, 0.0))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(t), f32(alphas), f32(sigmas), a_next, f32(adj), f32(ddim)


def sobol_times(n: int, seed: int = 0) -> np.ndarray:
    """Scrambled Sobol timestep draws (stable_diffusion.py:57's SobolEngine
    role), host-side, for ``VDiffDraws.t``."""
    from scipy.stats import qmc
    return qmc.Sobol(1, scramble=True, seed=seed).random(n)[:, 0] \
        .astype(np.float32)


@dataclasses.dataclass
class VDiffDraws:
    """The v-objective loss's draws: ``t`` (B,) timesteps in [0, 1)
    (uniform or ``sobol_times``), ``eps`` (B, T, D) standard normal,
    ``cfg`` (B,) uniform (a row's conditioning is dropped where it is <=
    the dropout probability)."""
    t: torch.Tensor
    eps: torch.Tensor
    cfg: torch.Tensor

    @classmethod
    def draw(cls, shape: Tuple[int, int, int], generator: torch.Generator,
             device) -> "VDiffDraws":
        b = shape[0]
        return cls(t=torch.rand(b, generator=generator, device=device),
                   eps=torch.randn(shape, generator=generator, device=device),
                   cfg=torch.rand(b, generator=generator, device=device))


class VDiffusion(nn.Module):
    """v-objective diffusion over a rotary DiT (stable_diffusion.py:28-110);
    CFG as a batch of 2 when ``inference_cfg_rate > 0``."""

    def __init__(self, dit: DiTConfig, inference_cfg_rate: float = 0.0):
        super().__init__()
        self.dit = dit
        self.inference_cfg_rate = inference_cfg_rate
        self.estimator = DiTEstimator(dit)

    def compute_loss(self, x0: torch.Tensor, valid: torch.Tensor,
                     mu: torch.Tensor, spks: torch.Tensor,
                     cond: torch.Tensor, draws: VDiffDraws,
                     cfg_dropout_prob: float = 0.1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Masked MSE on v = eps alpha - x0 sigma (stable_diffusion.py:
        71-93); returns (loss, predicted v)."""
        d = x0.shape[-1]
        t = draws.t.to(x0.dtype)
        alphas = torch.cos(t * np.pi / 2)[:, None, None]
        sigmas = torch.sin(t * np.pi / 2)[:, None, None]
        eps = draws.eps.to(x0.dtype)
        noised = x0 * alphas + eps * sigmas
        target = eps * alphas - x0 * sigmas
        if cfg_dropout_prob > 0:
            keep = (draws.cfg > cfg_dropout_prob).to(x0.dtype)
            mu = mu * keep[:, None, None]
            spks = spks * keep[:, None]
            cond = cond * keep[:, None, None]
        v = self.estimator(noised, valid, mu, t, spks, cond)
        m = valid[..., None].to(x0.dtype)
        loss = torch.sum(((v - target) * m) ** 2) / torch.clamp(
            torch.sum(m) * d, min=1.0)
        return loss, v

    def forward(self, mu: torch.Tensor, valid: torch.Tensor,
                spks: torch.Tensor, cond: torch.Tensor,
                n_timesteps: int = 10, eta: float = 0.0,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The sampler (sampling.py:48-88): mu (B, T, d) -> mel (B, T, d)
        f32.  ``noise`` (n_timesteps, B, T, d), standard normal draws (the
        JAX package draws them from its ``rng``), adds fresh noise x the
        ddim scale at each step (zero when ``eta`` is 0)."""
        b, tt, d = mu.shape
        dev, cd = mu.device, mu.dtype
        x = torch.from_numpy(_fixed_noise(NOISE_LEN, d)[:, :tt]).to(
            dev).expand(b, tt, d).float()
        t, alphas, sigmas, a_next, adj, ddim = ddim_tables(n_timesteps, eta)
        rate = self.inference_cfg_rate
        if rate > 0:
            mu_in = torch.cat([mu, torch.zeros_like(mu)], dim=0)
            spks_in = torch.cat([spks, torch.zeros_like(spks)], dim=0)
            cond_in = torch.cat([cond, torch.zeros_like(cond)], dim=0)
            valid_in = torch.cat([valid, valid], dim=0)
        else:
            mu_in, spks_in, cond_in, valid_in = mu, spks, cond, valid

        def scalar(v):
            # the JAX package casts its tables to mu's dtype
            return torch.full((), float(v), dtype=cd, device=dev)

        for i in range(n_timesteps):
            if rate > 0:
                v = self.estimator(
                    torch.cat([x, x], dim=0).to(cd), valid_in, mu_in,
                    torch.full((2 * b,), float(t[i]), dtype=cd, device=dev),
                    spks_in, cond_in).float()
                v = (1.0 + rate) * v[:b] - rate * v[b:]
            else:
                v = self.estimator(
                    x.to(cd), valid_in, mu_in,
                    torch.full((b,), float(t[i]), dtype=cd, device=dev),
                    spks_in, cond_in).float()
            pred = x * scalar(alphas[i]) - v * scalar(sigmas[i])
            if i == n_timesteps - 1:
                x = pred
                break
            eps = x * scalar(sigmas[i]) + v * scalar(alphas[i])
            x = pred * scalar(a_next[i]) + eps * scalar(adj[i])
            if noise is not None:
                x = x + noise[i].to(dev, torch.float32) * scalar(ddim[i])
        return x.float()


class GradTTSDiffWithXvec(nn.Module):
    """flow_gradtts.MaskedDiffWithXvec: the v1 token encoder and
    interpolating length regulator feeding the v-diffusion decoder; mel
    length = tokens / frame rate x 22050 / 256, truncated."""

    def __init__(self, cfg: FlowConfig, dit: DiTConfig,
                 sample_rate: int = 22050, hop: int = 256):
        super().__init__()
        self.cfg = cfg
        self.sample_rate, self.hop = sample_rate, hop
        self.input_embedding = nn.Embedding(cfg.vocab_size, cfg.input_size)
        self.spk_embed_affine_layer = nn.Linear(cfg.spk_embed_dim,
                                                cfg.output_size)
        self.encoder = ConformerEncoder(cfg.encoder)
        self.encoder_proj = nn.Linear(cfg.encoder.output_size,
                                      cfg.output_size)
        self.length_regulator = InterpolateRegulator(cfg.output_size)
        self.decoder = VDiffusion(dit)

    def mel_len(self, n_tokens: int) -> int:
        return int(n_tokens / self.cfg.input_frame_rate
                   * self.sample_rate / self.hop)

    def _front(self, token: torch.Tensor, valid: torch.Tensor,
               embedding: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(encoded tokens (B, T, d), speaker projection (B, d))."""
        norm = torch.linalg.vector_norm(embedding, dim=-1, keepdim=True)
        spks = self.spk_embed_affine_layer(
            embedding / torch.clamp(norm, min=1e-12))
        x = self.input_embedding(torch.clamp(token.long(), min=0))
        x = x * valid[..., None].to(x.dtype)
        return self.encoder_proj(self.encoder(x, valid)), spks

    def inference(self, token: torch.Tensor, valid: torch.Tensor,
                  prompt_feat: torch.Tensor, embedding: torch.Tensor,
                  mel_len: int, n_timesteps: int = 10,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``token`` holds the prompt's tokens first (flow_gradtts.py:
        101-142); returns the mel after the prompt's frames, f32."""
        h, spks = self._front(token, valid, embedding)
        h = self.length_regulator(h, mel_len)
        p = prompt_feat.shape[1]
        cond = torch.zeros((h.shape[0], mel_len, self.cfg.output_size),
                           dtype=h.dtype, device=h.device)
        cond[:, :p] = prompt_feat.to(h.dtype)
        feat_valid = torch.ones((h.shape[0], mel_len), dtype=torch.bool,
                                device=h.device)
        mel = self.decoder(h, feat_valid, spks, cond,
                           n_timesteps=n_timesteps, noise=noise)
        return mel[:, p:]

    def loss(self, token: torch.Tensor, token_valid: torch.Tensor,
             feat: torch.Tensor, feat_valid: torch.Tensor,
             embedding: torch.Tensor, draws: VDiffDraws) -> torch.Tensor:
        """The training objective (flow_gradtts.py:55-99): the condition is
        zeros (the reference's prompt-prefix conditioning is commented
        out)."""
        h, spks = self._front(token, token_valid, embedding)
        h = self.length_regulator(h, feat.shape[1])
        loss, _ = self.decoder.compute_loss(feat, feat_valid, h, spks,
                                            torch.zeros_like(feat), draws)
        return loss
