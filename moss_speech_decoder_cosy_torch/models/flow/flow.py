"""CausalMaskedDiffWithXvec: speech tokens -> mel by conditional flow
matching, after the JAX package's ``models/flow/flow.py`` (reference
cosyvoice/flow/flow.py:151-283).  Inference is a pure function of (tokens,
valid mask, prompt mel, speaker embedding) with ``streaming``/``finalize``
flags; the pipeline owns all session state.  ``loss`` is the training
objective, its random draws passed in (``FlowLossDraws``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .cfm import CausalConditionalCFM, CFMDraws
from .encoder import Drop, UpsampleConformerEncoder
from ...utils.config import FlowConfig


@dataclasses.dataclass
class FlowLossDraws:
    """The flow loss's draws: ``prompt`` (B,) uniform in [0, 1), the
    prompt prefix as a share of 0.3 of each row's frames; ``keep`` (B,)
    bool, the prefix kept (probability 0.5); the CFM loss's ``cfm``."""
    prompt: torch.Tensor
    keep: torch.Tensor
    cfm: CFMDraws

    @classmethod
    def draw(cls, feat_shape: Tuple[int, int, int],
             generator: torch.Generator, device) -> "FlowLossDraws":
        b = feat_shape[0]
        return cls(prompt=torch.rand(b, generator=generator, device=device),
                   keep=torch.rand(b, generator=generator,
                                   device=device) < 0.5,
                   cfm=CFMDraws.draw(feat_shape, generator, device))

    def rows(self, lo: int, hi: int, frames: int) -> "FlowLossDraws":
        """Rows ``lo:hi`` (and the first ``frames`` frames) of global
        draws: a data-parallel rank's share."""
        c = self.cfm
        return FlowLossDraws(self.prompt[lo:hi], self.keep[lo:hi], CFMDraws(
            c.t[lo:hi], c.z[lo:hi, :frames], c.cfg[lo:hi]))


class CausalMaskedDiffWithXvec(nn.Module):
    def __init__(self, cfg: FlowConfig):
        super().__init__()
        self.cfg = cfg
        self.input_embedding = nn.Embedding(cfg.vocab_size, cfg.input_size)
        self.spk_embed_affine_layer = nn.Linear(cfg.spk_embed_dim,
                                                cfg.output_size)
        self.encoder = UpsampleConformerEncoder(cfg.encoder)
        self.encoder_proj = nn.Linear(cfg.encoder.output_size,
                                      cfg.output_size)
        self.decoder = CausalConditionalCFM(cfg.cfm, cfg.estimator)

    def _embed_tokens(self, token: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
        x = self.input_embedding(torch.clamp(token, min=0))
        return x * valid[..., None].to(x.dtype)

    def _spk(self, embedding: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(embedding, dim=-1, keepdim=True)
        return self.spk_embed_affine_layer(
            embedding / torch.clamp(norm, min=1e-12))

    def encode(self, token: torch.Tensor, valid: torch.Tensor,
               streaming: bool, finalize: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """token (B, Ttot) -> (mu (B, Tm, n_mel), mel_valid (B, Tm)).  In
        a non-finalize streaming hop the last ``pre_lookahead_len`` tokens
        are encoder context and produce no frames (reference
        flow.py:262-263)."""
        x = self._embed_tokens(token, valid)
        if finalize:
            h, mel_valid = self.encoder(x, valid, streaming=streaming)
        else:
            n = token.shape[1] - self.cfg.pre_lookahead_len
            h, mel_valid = self.encoder(x[:, :n], valid[:, :n],
                                        context=x[:, n:],
                                        streaming=streaming)
        return self.encoder_proj(h), mel_valid

    def forward(self, token: torch.Tensor, valid: torch.Tensor,
                prompt_feat: torch.Tensor, embedding: torch.Tensor,
                streaming: bool = False, finalize: bool = True
                ) -> torch.Tensor:
        """Returns the FULL mel (B, Tm, n_mel) f32, prompt region included;
        callers slice ``[:, prompt_len*ratio:]``.

        token (B, Ttot): prompt tokens ++ chunk tokens; prompt_feat
        (B, P, n_mel); embedding (B, spk_embed_dim)."""
        spks = self._spk(embedding)
        mu, mel_valid = self.encode(token, valid, streaming, finalize)
        p = prompt_feat.shape[1]
        conds = torch.zeros_like(mu)
        conds[:, :p] = prompt_feat.to(mu.dtype)
        return self.decoder(mu, mel_valid, spks=spks, cond=conds,
                            streaming=streaming)

    def loss(self, token: torch.Tensor, token_valid: torch.Tensor,
             feat: torch.Tensor, feat_valid: torch.Tensor,
             embedding: torch.Tensor, draws: FlowLossDraws,
             drop: Drop = None, streaming: bool = True,
             reduce=None) -> torch.Tensor:
        """The training objective (reference flow.py:189-235): unified
        streaming training, a random prompt prefix of the target mel as the
        condition, dropped for half the rows.  ``drop``: the encoder's
        dropout.  feat (B, Tm, n_mel) with Tm = tokens x token_mel_ratio.
        ``reduce``: the masked mean's denominator summed over data-parallel
        ranks (``compute_loss``)."""
        tm = feat.shape[1]
        spks = self._spk(embedding)
        h, mel_valid = self.encoder(self._embed_tokens(token, token_valid),
                                    token_valid, streaming=streaming,
                                    drop=drop)
        mu = self.encoder_proj(h)
        mel_valid = mel_valid & feat_valid
        lens = feat_valid.sum(dim=1)
        idx = (draws.prompt * 0.3 * lens).to(torch.int32)
        pos = torch.arange(tm, device=feat.device)[None, :]
        cond_mask = (pos < idx[:, None]) & draws.keep[:, None]
        conds = feat * cond_mask[..., None].to(feat.dtype)
        loss, _ = self.decoder.compute_loss(feat, mel_valid, mu[:, :tm], spks,
                                            conds, draws.cfm,
                                            streaming=streaming,
                                            reduce=reduce)
        return loss
