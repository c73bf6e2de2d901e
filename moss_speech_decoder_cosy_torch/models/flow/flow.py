"""CausalMaskedDiffWithXvec inference: speech tokens -> mel by conditional
flow matching, after the JAX package's ``models/flow/flow.py`` (reference
cosyvoice/flow/flow.py:151-283).  A pure function of (tokens, valid mask,
prompt mel, speaker embedding) with ``streaming``/``finalize`` flags; the
pipeline owns all session state.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .cfm import CausalConditionalCFM
from .encoder import UpsampleConformerEncoder
from ...utils.config import FlowConfig


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
