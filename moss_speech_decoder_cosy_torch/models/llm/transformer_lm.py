"""CosyVoice-v1 TransformerLM (the legacy text -> speech-token LM), after
the JAX package's ``models/llm/transformer_lm.py`` (reference
cosyvoice/llm/llm.py:32-229): text embedding -> conformer text encoder ->
affine -> decoder-only transformer over [sos, (spk), text_enc, task_id,
speech] with a speech head.  The v2 Qwen2 path (``speech_lm.py``)
supersedes it; it is kept for checkpoint and API parity.

Built from the flow encoder's pieces: ``ConformerEncoderLayer`` without
macaron FF or conv module (the v1 text encoder has neither, reference
transformer_lm.py:36-39), ``LinearEmbed``, the espnet rel-pos table and the
chunk mask.  Generation recomputes the whole prefix each step (no KV
cache), as the JAX package does, with the RAS pick and counter-based noise
of ``speech_lm.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..flow.encoder import ConformerEncoderLayer, LinearEmbed
from ...ops.embeddings import espnet_rel_pos
from ...ops.masks import chunk_attention_mask
from ...ops.norms import LayerNorm
from ...utils.config import EncoderConfig
from .speech_lm import SpeechLMConfig, counter_gumbel, pushed, ras_pick


@dataclasses.dataclass(frozen=True)
class TransformerLMConfig:
    """The JAX package's fields, plus ``spk_embed_dim``: the x-vector width,
    which flax infers from the first call and a torch module needs
    up front (192, llm.py:66)."""
    text_token_size: int = 51866
    speech_token_size: int = 4096
    text_encoder_input_size: int = 512
    llm_input_size: int = 1024
    llm_output_size: int = 1024
    text_encoder: EncoderConfig = EncoderConfig(
        input_size=512, output_size=1024, attention_heads=8,
        linear_units=2048, num_blocks=3, macaron_style=False,
        use_cnn_module=False, dropout_rate=0.0)
    llm_blocks: int = 3
    sampling: SpeechLMConfig = SpeechLMConfig()
    spk_embed_dim: int = 192


def tiny_transformer_lm_config() -> TransformerLMConfig:
    enc = EncoderConfig(input_size=16, output_size=24, attention_heads=2,
                        linear_units=32, num_blocks=1, macaron_style=False,
                        use_cnn_module=False, dropout_rate=0.0)
    return TransformerLMConfig(
        text_token_size=50, speech_token_size=32,
        text_encoder_input_size=16, llm_input_size=24, llm_output_size=24,
        text_encoder=enc, llm_blocks=2,
        sampling=SpeechLMConfig(speech_token_size=32, top_k=8, win_size=4),
        spk_embed_dim=12)


def _causal(valid: torch.Tensor) -> torch.Tensor:
    t = valid.shape[1]
    ar = torch.arange(t, device=valid.device)
    return (ar[None, :] <= ar[:, None])[None] & valid[:, None, :]


class _DecoderOnly(nn.Module):
    """Causal transformer over embeddings (the wenet TransformerEncoder with
    subsequent masks, ReLU feed-forward; ``linear_legacy`` input layer)."""

    def __init__(self, cfg: TransformerLMConfig):
        super().__init__()
        enc = dataclasses.replace(
            cfg.text_encoder, output_size=cfg.llm_output_size,
            input_size=cfg.llm_input_size, activation="relu")
        self.d = cfg.llm_output_size
        self.embed = LinearEmbed(cfg.llm_input_size, cfg.llm_output_size,
                                 relu=True)
        self.layers = []
        for i in range(cfg.llm_blocks):
            layer = ConformerEncoderLayer(enc)
            self.add_module(f"layers_{i}", layer)
            self.layers.append(layer)
        self.after_norm = LayerNorm(self.d, eps=1e-5)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        x = self.embed(x)
        pos = espnet_rel_pos(x.shape[1], self.d, device=x.device).to(x.dtype)
        mask = _causal(valid)
        for layer in self.layers:
            x = layer(x, mask, pos)
        return self.after_norm(x)


class TransformerLM(nn.Module):
    def __init__(self, cfg: TransformerLMConfig):
        super().__init__()
        self.cfg = cfg
        te = cfg.text_encoder
        self.text_embedding = nn.Embedding(cfg.text_token_size,
                                           cfg.text_encoder_input_size)
        self.text_encoder_layers = []
        for i in range(te.num_blocks):
            layer = ConformerEncoderLayer(te)
            self.add_module(f"text_enc_{i}", layer)
            self.text_encoder_layers.append(layer)
        self.text_embed_in = LinearEmbed(cfg.text_encoder_input_size,
                                         te.output_size)
        self.text_after_norm = LayerNorm(te.output_size, eps=1e-5)
        self.text_encoder_affine_layer = nn.Linear(te.output_size,
                                                   cfg.llm_input_size)
        self.spk_embed_affine_layer = nn.Linear(cfg.spk_embed_dim,
                                                cfg.llm_input_size)
        self.llm_embedding = nn.Embedding(2, cfg.llm_input_size)
        # speech_token_size rows (llm.py:72): eos is an output-only id
        self.speech_embedding = nn.Embedding(cfg.speech_token_size,
                                             cfg.llm_input_size)
        self.llm = _DecoderOnly(cfg)
        self.llm_decoder = nn.Linear(cfg.llm_output_size,
                                     cfg.speech_token_size + 1)
        self.noise = counter_gumbel

    def encode_text(self, text: torch.Tensor, text_valid: torch.Tensor
                    ) -> torch.Tensor:
        """Conformer text encoder; the reference decodes it with
        decoding_chunk_size=1, left=-1 (llm.py:84), a causal mask."""
        x = self.text_embed_in(self.text_embedding(text))
        pos = espnet_rel_pos(x.shape[1], self.cfg.text_encoder.output_size,
                             device=x.device).to(x.dtype)
        mask = chunk_attention_mask(text_valid, 1)
        for layer in self.text_encoder_layers:
            x = layer(x, mask, pos)
        return self.text_encoder_affine_layer(self.text_after_norm(x))

    def embed_spk(self, spk: torch.Tensor) -> torch.Tensor:
        """L2-normalize + affine the x-vector (llm.py:124-126)."""
        norm = torch.linalg.vector_norm(spk, dim=-1, keepdim=True)
        return self.spk_embed_affine_layer(spk / torch.clamp(norm, min=1e-12))

    def _lm_inputs(self, text_enc, text_valid, speech, speech_valid,
                   spk=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """[sos, (spk), text_enc, task, speech] (llm.py:91-97,196-203);
        eos-padded speech ids are clipped into the table."""
        b = text_enc.shape[0]
        sos = self.llm_embedding.weight[:1].expand(b, 1, -1)
        task = self.llm_embedding.weight[1:2].expand(b, 1, -1)
        sp = self.speech_embedding(
            torch.clamp(speech, max=self.cfg.speech_token_size - 1))
        ones = torch.ones(b, 1, dtype=torch.bool, device=text_enc.device)
        parts, vparts = [sos], [ones]
        if spk is not None:
            parts.append(self.embed_spk(spk)[:, None])
            vparts.append(ones)
        parts += [text_enc, task, sp]
        vparts += [text_valid, ones, speech_valid]
        return torch.cat(parts, dim=1), torch.cat(vparts, dim=1)

    def forward(self, text, text_valid, speech, speech_valid, spk=None):
        """Teacher-forced logits over the full sequence, and its valid
        mask."""
        text_enc = self.encode_text(text, text_valid)
        x, valid = self._lm_inputs(text_enc, text_valid, speech,
                                   speech_valid, spk)
        return self.llm_decoder(self.llm(x, valid)), valid

    @torch.inference_mode()
    def generate(self, text: torch.Tensor, text_valid: torch.Tensor,
                 seed: int = 0, max_len: int = 32,
                 spk: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, int]:
        """AR sampling with RAS, the whole prefix recomputed each step;
        draw j of ``seed`` at step j.  Returns (tokens (max_len,) padded
        with eos, count)."""
        c = self.cfg
        eos = c.speech_token_size
        if text.shape[0] != 1:
            raise ValueError("generate takes one text")
        dev = text.device
        text_enc = self.encode_text(text, text_valid)
        prefix = 1 + (0 if spk is None else 1) + text.shape[1] + 1
        long = dict(dtype=torch.long, device=dev)
        tokens = torch.full((max_len,), eos, **long)
        n = torch.zeros(1, **long)
        done = torch.zeros(1, dtype=torch.bool, device=dev)
        hist = torch.full((1, c.sampling.win_size), -1, **long)
        seeds = torch.full((1,), seed, **long)
        span = torch.arange(max_len, device=dev)
        for step in range(max_len):
            x, valid = self._lm_inputs(text_enc, text_valid, tokens[None],
                                       span[None] < n, spk)
            h = self.llm(x, valid)
            logits = self.llm_decoder(h[0, prefix - 1 + n])
            logp = torch.log_softmax(logits.float(), dim=-1)
            tok = ras_pick(logp, hist, self.noise(
                seeds, torch.full((1,), step, **long), logp.shape[-1]),
                c.sampling)
            stop = done | (tok >= eos)
            at = n.clamp(max=max_len - 1)
            tokens.scatter_(0, at, torch.where(stop, eos, tok))
            hist = torch.where(stop[:, None], hist, pushed(hist, tok))
            n = n + (~stop).long()
            done = stop
        return tokens, int(n[0])
