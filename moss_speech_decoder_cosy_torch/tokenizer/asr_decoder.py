"""Whisper ASR head of the tokenizer, after the JAX package's
``tokenizer/asr_decoder.py`` (reference modeling_whisper.py:1614-2777,
generation_whisper.py):

- ``PostVQEncoder``: the encoder layers after the VQ over
  ``codebook[ids] + embed_positions2`` (modeling_whisper.py:1466);
- ``WhisperVQDecoder``: the Whisper decoder (learned positions, causal
  self-attention, cross-attention, tied output embedding);
- ``WhisperAudioClassifier`` and ``asr_ce_loss``, the training heads;
- the decodes at the JAX package's static shapes: a ``(B, max_len)``
  token buffer prefilled with eos and a full-prefix recompute each step,
  ``max_len - 1`` steps.  ``DecodeSteps`` keeps each decode's state in
  persistent buffers on the device (positions and ``done`` included) and
  replays each step as one CUDA graph (``utils/graphs.StepGraphs``); the
  host reads nothing inside a decode.  The cross-attention keys and values
  of the encoder states are computed once a decode.  ``graphs=False`` (and
  the CPU) run the same steps eagerly;
- the host helpers of the timestamps (numpy, as in JAX) and ``WhisperASR``,
  the long-form transcriber over speech tokens with its temperature
  fallback ladder.

Temperature sampling draws Gumbel noise from ``models/llm/speech_lm.py``'s
counter-based ``counter_gumbel`` keyed by (seed, draw), in place of JAX's
threefry keys (a deliberate difference, ROADMAP): ``categorical(key, l)`` is
``argmax(gumbel + l)``, so greedy, beam and timestamp decoding give JAX's
tokens, and sampling its distribution with other draws.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.llm.speech_lm import counter_gumbel, load_lm
from ..ops.masks import mask_to_bias
from ..ops.norms import LayerNorm
from ..utils.device import resolve_device
from ..utils.graphs import StepGraphs
from .config import WhisperVQConfig
from .model import WhisperAttention, WhisperVQEncoderLayer, _gelu

_NEG = -1.0e10
KV = List[Tuple[torch.Tensor, torch.Tensor]]


class PostVQEncoder(nn.Module):
    """Encoder layers ``quantize_position .. encoder_layers`` over the
    quantized states (params ``embed_positions2``, ``layers_i``,
    ``layer_norm``)."""

    def __init__(self, cfg: WhisperVQConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_positions2 = nn.Parameter(torch.empty(
            cfg.max_source_positions // cfg.pooling_kernel_size, cfg.d_model))
        self.layers: List[WhisperVQEncoderLayer] = []
        for i in range(cfg.encoder_layers - cfg.quantize_position):
            layer = WhisperVQEncoderLayer(cfg)
            self.add_module(f"layers_{i}", layer)
            self.layers.append(layer)
        self.layer_norm = LayerNorm(cfg.d_model)

    def seed_init(self, name, shape, g):
        if name == "embed_positions2":
            return torch.randn(shape, generator=g) * 0.02
        return None

    def forward(self, quantized: torch.Tensor,
                token_valid: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        t = quantized.shape[1]
        x = quantized + self.embed_positions2[None, :t]
        pos = torch.arange(t, device=x.device)
        if c.causal_attention:
            allow = pos[None, :] <= pos[:, None]
        else:
            blk = max(1, c.quantize_causal_block_size // c.pooling_kernel_size)
            allow = (pos[None, :] // blk) <= (pos[:, None] // blk)
        bias = mask_to_bias(allow[None] & token_valid[:, None, :],
                            x.dtype)[:, None]
        for layer in self.layers:
            x = layer(x, bias)
        return self.layer_norm(x)


class WhisperDecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperVQConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn_layer_norm = LayerNorm(d)
        self.self_attn = WhisperAttention(cfg.decoder_attention_heads, d)
        self.encoder_attn_layer_norm = LayerNorm(d)
        self.encoder_attn = WhisperAttention(cfg.decoder_attention_heads, d)
        self.final_layer_norm = LayerNorm(d)
        self.fc1 = nn.Linear(d, cfg.decoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, d)

    def forward(self, x, kv, self_bias, cross_bias):
        """``kv`` the cross-attention keys and values of the encoder states
        (head layout, ``encoder_attn.kv``); returns (x, cross weights (B,
        H, T, S))."""
        b, t, d = x.shape
        x = x + self.self_attn(self.self_attn_layer_norm(x), self_bias)
        q = self.encoder_attn.q(self.encoder_attn_layer_norm(x))
        a = torch.softmax(q @ kv[0].transpose(-1, -2) + cross_bias, dim=-1)
        o = (a @ kv[1]).transpose(1, 2).reshape(b, t, d)
        x = x + self.encoder_attn.out_proj(o)
        h = _gelu(self.fc1(self.final_layer_norm(x)))
        return x + self.fc2(h), a


class WhisperVQDecoder(nn.Module):
    """Token decoder with a tied input / output embedding (params
    ``embed_tokens``, ``embed_positions``, ``layers_i``, ``layer_norm``)."""

    def __init__(self, cfg: WhisperVQConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Parameter(
            torch.empty(cfg.max_target_positions, cfg.d_model))
        self.layers: List[WhisperDecoderLayer] = []
        for i in range(cfg.decoder_layers):
            layer = WhisperDecoderLayer(cfg)
            self.add_module(f"layers_{i}", layer)
            self.layers.append(layer)
        self.layer_norm = LayerNorm(cfg.d_model)

    def seed_init(self, name, shape, g):
        if name == "embed_positions":
            return torch.randn(shape, generator=g) * 0.02
        return None

    def cross_kv(self, enc: torch.Tensor) -> KV:
        """Each layer's cross-attention keys and values of ``enc``."""
        return [layer.encoder_attn.kv(enc) for layer in self.layers]

    def forward(self, tokens: torch.Tensor, token_valid: torch.Tensor,
                enc: Optional[torch.Tensor], enc_valid: torch.Tensor,
                return_cross_attn: bool = False, cross_kv: KV = None,
                last: Optional[torch.Tensor] = None):
        """tokens (B, T), token_valid (B, T), enc (B, S, D) or its
        ``cross_kv``, enc_valid (B, S) -> logits (B, T, V), or (B, V) at
        the positions ``last`` (B,).  ``return_cross_attn`` also returns
        the cross-attention weights stacked (L, B, H, T, S), the rows the
        DTW timestamps read (generation_whisper.py:186-191)."""
        b, t = tokens.shape
        x = self.embed_tokens(tokens) + self.embed_positions[None, :t]
        ar = torch.arange(t, device=tokens.device)
        causal = (ar[None, :] <= ar[:, None])[None] & token_valid[:, None, :]
        self_bias = mask_to_bias(causal, x.dtype)[:, None]
        cross_bias = mask_to_bias(enc_valid[:, None, :], x.dtype)[:, None]
        if cross_kv is None:
            cross_kv = self.cross_kv(enc)
        attns = []
        for layer, kv in zip(self.layers, cross_kv):
            x, a = layer(x, kv, self_bias, cross_bias)
            attns.append(a)
        if last is not None:
            x = x[torch.arange(b, device=x.device), last][:, None]
        logits = self.layer_norm(x) @ self.embed_tokens.weight.t()
        if last is not None:
            logits = logits[:, 0]
        if return_cross_attn:
            return logits, torch.stack(attns)
        return logits


class WhisperAudioClassifier(nn.Module):
    """Sequence classification over encoder states
    (WhisperForAudioClassification, modeling_whisper.py:2653-2762): an
    optional softmax-weighted sum of ``num_layers`` layer states, the
    projector, a mean pool (masked by ``valid`` when given) and the
    classifier.  ``states`` (B, T, D), or (B, L, T, D) with
    ``use_weighted_layer_sum``."""

    def __init__(self, cfg: WhisperVQConfig, num_labels: int,
                 classifier_proj_size: int = 256,
                 use_weighted_layer_sum: bool = False, num_layers: int = 0):
        super().__init__()
        self.use_weighted_layer_sum = use_weighted_layer_sum
        if use_weighted_layer_sum:
            if num_layers < 1:
                raise ValueError("a weighted layer sum needs num_layers")
            self.layer_weights = nn.Parameter(torch.empty(num_layers))
        self.projector = nn.Linear(cfg.d_model, classifier_proj_size)
        self.classifier = nn.Linear(classifier_proj_size, num_labels)

    def seed_init(self, name, shape, g):
        if name == "layer_weights":
            return torch.full(shape, 1.0 / shape[0])
        return None

    def forward(self, states: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.use_weighted_layer_sum:
            w = torch.softmax(self.layer_weights, dim=0)
            states = torch.einsum("bltd,l->btd", states, w)
        h = self.projector(states)
        if valid is None:
            pooled = h.mean(dim=1)
        else:
            m = valid[..., None].to(h.dtype)
            pooled = (h * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        return self.classifier(pooled)


def asr_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the valid labels."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None]
                        )[..., 0]
    m = valid.to(logits.dtype)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


# ------------------------------------------------------------------ decodes
def _last_logits(dec: WhisperVQDecoder, tokens: torch.Tensor,
                 n: torch.Tensor, kv: KV, enc_valid: torch.Tensor
                 ) -> torch.Tensor:
    """f32 logits (R, V) at each row's position n - 1 of a full-prefix
    forward over ``tokens`` (R, L), positions < max(n, 1) valid."""
    ar = torch.arange(tokens.shape[1], device=tokens.device)
    tv = ar[None, :] < torch.clamp(n, min=1)[:, None]
    return dec(tokens, tv, None, enc_valid, cross_kv=kv,
               last=torch.clamp(n - 1, min=0)).float()


def _timestamp_rules(lg, last, penult, last_ts, n, ts0: int, eos_id: int,
                     max_initial: int) -> torch.Tensor:
    """The WhisperTimeStampLogitsProcessor grammar (JAX ``apply_rules``)
    on f32 logits (B, V)."""
    ids = torch.arange(lg.shape[-1], device=lg.device)[None, :]
    is_ts = ids >= ts0
    neg = torch.full((), _NEG, dtype=lg.dtype, device=lg.device)
    last_was = last >= ts0
    penult_was = (penult >= ts0) | (n <= 2)
    mask_ts = last_was & penult_was          # a completed pair -> text
    mask_text = last_was & ~penult_was       # an open pair -> ts or eos
    lg = torch.where(mask_ts[:, None] & is_ts, neg, lg)
    lg = torch.where(mask_text[:, None] & ~(is_ts | (ids == eos_id)), neg,
                     lg)
    floor = torch.where(mask_text, last_ts, last_ts + 1)
    below = is_ts & (ids < floor[:, None])
    lg = torch.where((last_ts >= ts0)[:, None] & below, neg, lg)
    init_ok = is_ts & (ids <= ts0 + max_initial)
    lg = torch.where((n == 1)[:, None] & ~init_ok, neg, lg)
    logp = torch.log_softmax(lg, dim=-1)
    ts_lp = torch.logsumexp(torch.where(is_ts, logp, neg), dim=-1)
    text_max = torch.where(is_ts, neg, logp).max(dim=-1).values
    return torch.where((ts_lp > text_max)[:, None] & ~is_ts, neg, lg)


class DecodeSteps:
    """The ASR decodes of one decoder at ``max_len``: each kind's state in
    persistent buffers, allocated at its first call for a shape and reused,
    and its single step replayed as one CUDA graph per (kind, shape, eos)
    through ``StepGraphs`` (eager on the CPU or with ``graphs=False``); a
    step reads only those buffers, so a replay reads this call's inputs.  A decode
    loads the encoder states and their cross keys and values into the
    buffers (eagerly), runs ``max_len - 1`` steps with no host read, and
    returns device tensors."""

    def __init__(self, decoder: WhisperVQDecoder, max_len: int = 64,
                 graphs: bool = True):
        self.dec = decoder
        self.max_len = max_len
        self.device = decoder.embed_positions.device
        self.dtype = decoder.embed_positions.dtype
        self.steps = StepGraphs(self.device, graphs)
        self._bufs: Dict[tuple, dict] = {}

    def _state(self, key: tuple, rows: int, src: int, extra) -> dict:
        st = self._bufs.get(key)
        if st is None:
            c, dev = self.dec.cfg, self.device
            dk = c.d_model // c.decoder_attention_heads
            kvs = (rows, c.decoder_attention_heads, src, dk)
            st = dict(
                kv=[(torch.zeros(kvs, dtype=self.dtype, device=dev),
                     torch.zeros(kvs, dtype=self.dtype, device=dev))
                    for _ in range(c.decoder_layers)],
                valid=torch.zeros(rows, src, dtype=torch.bool, device=dev),
                tokens=torch.zeros(rows, self.max_len, dtype=torch.long,
                                   device=dev),
                n=torch.zeros(rows, dtype=torch.long, device=dev),
                done=torch.zeros(rows, dtype=torch.bool, device=dev))
            st.update(extra(rows, dev))
            self._bufs[key] = st
        return st

    @torch.no_grad()
    def _load(self, st: dict, enc: torch.Tensor, enc_valid: torch.Tensor,
              bos_id: int, eos_id: int) -> None:
        for (k, v), (kn, vn) in zip(st["kv"], self.dec.cross_kv(
                enc.to(self.dtype))):
            k.copy_(kn)
            v.copy_(vn)
        st["valid"].copy_(enc_valid)
        st["tokens"].fill_(eos_id)
        st["tokens"][..., 0] = bos_id
        st["n"].fill_(1)
        st["done"].zero_()

    def _run(self, key: tuple, step) -> None:
        for _ in range(self.max_len - 1):
            self.steps.run(key, step)

    # ------------------------------------------------------ greedy / sample
    @torch.no_grad()
    def sample(self, enc, enc_valid, bos_id: int, eos_id: int,
               temperature: float = 0.0, seed: int = 0, draw0: int = 0):
        """Greedy (temperature 0) or temperature sampling with the summed
        log-probs of the chosen tokens: (tokens (B, L), lengths (B,) with
        bos, sum_logprob (B,)).  Step j draws ``counter_gumbel``'s draw
        ``draw0 + j`` of ``seed``."""
        b, s = enc_valid.shape
        key = ("sample", b, s, eos_id)
        st = self._state(key, b, s, lambda r, dev: dict(
            lp=torch.zeros(r, device=dev),
            seeds=torch.zeros(r, dtype=torch.long, device=dev),
            t=torch.zeros((), dtype=torch.long, device=dev),
            temp=torch.ones((), device=dev),
            greedy=torch.ones((), dtype=torch.bool, device=dev)))
        self._load(st, enc, enc_valid, bos_id, eos_id)
        st["lp"].zero_()
        st["seeds"].fill_(seed)
        st["t"].fill_(draw0)
        st["temp"].fill_(temperature if temperature > 0 else 1.0)
        st["greedy"].fill_(temperature <= 0)
        at_max = self.max_len - 1

        def step():
            last = _last_logits(self.dec, st["tokens"], st["n"], st["kv"],
                                st["valid"])
            noise = counter_gumbel(st["seeds"], st["t"].expand(b),
                                   last.shape[-1])[:, 0]
            nxt = torch.where(st["greedy"], torch.argmax(last, dim=-1),
                              torch.argmax(noise + last / st["temp"],
                                           dim=-1))
            step_lp = torch.gather(torch.log_softmax(last, dim=-1), 1,
                                   nxt[:, None])[:, 0]
            done = st["done"]
            nxt = torch.where(done, eos_id, nxt)
            st["lp"].add_(torch.where(done, 0.0, step_lp))
            st["tokens"].scatter_(1, torch.clamp(st["n"], max=at_max)[:, None],
                                  nxt[:, None])
            done |= nxt == eos_id
            st["n"].add_((~done).long())
            st["t"].add_(1)

        self._run(key, step)
        return st["tokens"].clone(), st["n"].clone(), st["lp"].clone()

    # ----------------------------------------------------------- timestamp
    @torch.no_grad()
    def timestamp(self, enc, enc_valid, bos_id: int, eos_id: int,
                  timestamp_begin: int, max_initial_timestamp_index: int = 50):
        """Greedy decoding under the timestamp grammar: (tokens, lengths)."""
        b, s = enc_valid.shape
        key = ("timestamp", b, s, eos_id, timestamp_begin,
               max_initial_timestamp_index)
        long = dict(dtype=torch.long)
        st = self._state(key, b, s, lambda r, dev: dict(
            last=torch.zeros(r, device=dev, **long),
            penult=torch.zeros(r, device=dev, **long),
            last_ts=torch.zeros(r, device=dev, **long)))
        self._load(st, enc, enc_valid, bos_id, eos_id)
        st["last"].fill_(bos_id)
        st["penult"].fill_(bos_id)
        st["last_ts"].zero_()
        at_max = self.max_len - 1

        def step():
            n, done, last = st["n"], st["done"], st["last"]
            lg = _timestamp_rules(
                _last_logits(self.dec, st["tokens"], n, st["kv"],
                             st["valid"]),
                last, st["penult"], st["last_ts"], n, timestamp_begin,
                eos_id, max_initial_timestamp_index)
            nxt = torch.where(done, eos_id, torch.argmax(lg, dim=-1))
            st["tokens"].scatter_(1, torch.clamp(n, max=at_max)[:, None],
                                  nxt[:, None])
            new_done = done | (nxt == eos_id)
            st["penult"].copy_(torch.where(done, st["penult"], last))
            st["last_ts"].copy_(torch.where((nxt >= timestamp_begin) & ~done,
                                            nxt, st["last_ts"]))
            last.copy_(torch.where(done, last, nxt))
            n.add_((~new_done).long())
            done.copy_(new_done)

        self._run(key, step)
        return st["tokens"].clone(), st["n"].clone()

    # ---------------------------------------------------------------- beam
    @torch.no_grad()
    def beam(self, enc, enc_valid, bos_id: int, eos_id: int,
             beam_size: int = 4, length_penalty: float = 1.0):
        """Beam search of width ``beam_size``: (best tokens (B, L), lengths
        (B,), best score (B,)), the score sum-logprob / length **
        length_penalty."""
        b, s = enc_valid.shape
        k, big_l = beam_size, self.max_len
        nv = self.dec.cfg.vocab_size
        key = ("beam", b, s, eos_id, k)

        def extra(r, dev):
            # finished beams extend only with eos, at no cost
            eos_row = torch.full((nv,), -1e9, device=dev)
            eos_row[eos_id] = 0.0
            return dict(scores=torch.zeros(b, k, device=dev),
                        ln=torch.ones(b, k, dtype=torch.long, device=dev),
                        step=torch.ones((), dtype=torch.long, device=dev),
                        eos_row=eos_row)
        st = self._state(key, b * k, s, extra)
        self._load(st, enc.repeat_interleave(k, 0),
                   enc_valid.repeat_interleave(k, 0), bos_id, eos_id)
        st["scores"].zero_()
        st["scores"][:, 1:] = -1e9
        st["ln"].fill_(1)
        st["step"].fill_(1)
        tokens = st["tokens"].view(b, k, big_l)
        done = st["done"].view(b, k)

        def step():
            n = st["step"]
            logp = torch.log_softmax(_last_logits(
                self.dec, st["tokens"], n.expand(b * k), st["kv"],
                st["valid"]), dim=-1).view(b, k, nv)
            logp = torch.where(done[..., None], st["eos_row"], logp)
            cand = st["scores"][..., None] + logp
            top_s, top_i = torch.topk(cand.reshape(b, k * nv), k, dim=-1)
            beam_idx = top_i // nv
            tok = top_i % nv
            tokens.copy_(torch.gather(tokens, 1, beam_idx[..., None].expand(
                b, k, big_l)))
            done_g = torch.gather(done, 1, beam_idx)
            ln_g = torch.gather(st["ln"], 1, beam_idx)
            tokens.scatter_(2, torch.clamp(n, max=big_l - 1).expand(b, k, 1),
                            tok[..., None])
            done.copy_(done_g | (tok == eos_id))
            st["ln"].copy_(torch.where(done_g, ln_g, ln_g + 1))
            st["scores"].copy_(top_s)
            n.add_(1)

        self._run(key, step)
        final = st["scores"] / st["ln"].float() ** length_penalty
        best = torch.argmax(final, dim=1)
        rows = torch.arange(b, device=self.device)
        return (tokens[rows, best].clone(), st["ln"][rows, best].clone(),
                final[rows, best])


# The JAX package's four decode functions, by name.  Each builds its own
# eager ``DecodeSteps`` (fresh buffers, no graph): a caller that decodes
# more than once, as ``WhisperASR`` does, keeps one ``DecodeSteps``.
def greedy_decode(decoder: WhisperVQDecoder, enc, enc_valid, bos_id: int,
                  eos_id: int, max_len: int = 64):
    """Greedy decoding: (tokens (B, max_len) padded with eos, lengths)."""
    toks, n, _ = DecodeSteps(decoder, max_len, graphs=False).sample(
        enc, enc_valid, bos_id, eos_id)
    return toks, n


def sample_decode(decoder: WhisperVQDecoder, enc, enc_valid, bos_id: int,
                  eos_id: int, seed: int = 0, temperature: float = 0.0,
                  max_len: int = 64):
    """Greedy (temperature 0) or temperature sampling: (tokens, lengths
    with bos, sum_logprob)."""
    return DecodeSteps(decoder, max_len, graphs=False).sample(
        enc, enc_valid, bos_id, eos_id, temperature, seed)


def timestamp_decode(decoder: WhisperVQDecoder, enc, enc_valid, bos_id: int,
                     eos_id: int, timestamp_begin: int,
                     max_initial_timestamp_index: int = 50,
                     max_len: int = 64):
    """Greedy decoding under the timestamp grammar (generation_whisper.py:
    349-352,520-525): (tokens, lengths)."""
    return DecodeSteps(decoder, max_len, graphs=False).timestamp(
        enc, enc_valid, bos_id, eos_id, timestamp_begin,
        max_initial_timestamp_index)


def beam_decode(decoder: WhisperVQDecoder, enc, enc_valid, bos_id: int,
                eos_id: int, beam_size: int = 4, max_len: int = 64,
                length_penalty: float = 1.0):
    """Beam search (HF ``generate(num_beams=...)``, generation_whisper.py:
    277): (best tokens, lengths, best score)."""
    return DecodeSteps(decoder, max_len, graphs=False).beam(
        enc, enc_valid, bos_id, eos_id, beam_size, length_penalty)


# ------------------------------------------------------------ host helpers
def extract_timestamp_segments(tokens, n: int, timestamp_begin: int,
                               time_precision: float = 0.02,
                               offset_sec: float = 0.0):
    """One decoded row -> [(start_s, end_s, text_ids)] split at timestamp
    pairs (generation_whisper.py:693-711); an unclosed trailing segment
    ends ``len(text) * time_precision`` after its start."""
    seq = np.asarray(tokens).reshape(-1)[1:int(n)]       # strip bos
    segs = []
    start = None
    text: list = []
    for tok in seq.tolist():
        if tok >= timestamp_begin:
            t_sec = (tok - timestamp_begin) * time_precision + offset_sec
            if start is None:
                start = t_sec
            elif text:
                segs.append((start, t_sec, np.asarray(text, np.int32)))
                start, text = t_sec, []
            else:
                start = t_sec                    # a consecutive pair: reset
        else:
            text.append(tok)
    if text and start is not None:
        end = start + len(text) * time_precision
        segs.append((start, end, np.asarray(text, np.int32)))
    return segs


def compression_ratio(token_ids) -> float:
    """zlib compression ratio of the token bytes, the long-form fallback's
    repetition detector (generation_whisper.py:1722-1729)."""
    import zlib
    raw = np.asarray(token_ids, np.int32).tobytes()
    if not raw:
        return 0.0
    return len(raw) / len(zlib.compress(raw))


def median_filter(x, filter_width: int):
    """Median filter along the last axis with reflect padding
    (generation_whisper.py:43-63)."""
    if filter_width <= 0 or filter_width % 2 != 1:
        raise ValueError("`filter_width` should be an odd number")
    pad = filter_width // 2
    x = np.asarray(x)
    if x.shape[-1] <= pad:
        return x
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(
        xp, filter_width, axis=-1)
    return np.sort(windows, axis=-1)[..., pad]


def dynamic_time_warping(matrix):
    """Monotonic min-cost path through a (text, time) cost matrix
    (generation_whisper.py:66-116): (text_indices, time_indices), earliest
    first.  The cost accumulates in f32, as the reference's (:72)."""
    matrix = np.asarray(matrix, np.float64)
    t_len, s_len = matrix.shape
    cost = np.full((t_len + 1, s_len + 1), np.inf, np.float32)
    trace = -np.ones((t_len + 1, s_len + 1), np.int8)
    cost[0, 0] = 0.0
    for j in range(1, s_len + 1):
        col_m = matrix[:, j - 1]
        prev = cost[:, j - 1]
        cur = cost[:, j]
        for i in range(1, t_len + 1):
            c0, c1, c2 = prev[i - 1], cur[i - 1], prev[i]
            if c0 < c1 and c0 < c2:
                c, t = c0, 0
            elif c1 < c0 and c1 < c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cur[i] = col_m[i - 1] + c
            trace[i, j] = t
    trace[0, :] = 2
    trace[:, 0] = 1
    i, j = t_len, s_len
    text_indices, time_indices = [], []
    while i > 0 or j > 0:
        text_indices.append(i - 1)
        time_indices.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return (np.array(text_indices[::-1], np.int64),
            np.array(time_indices[::-1], np.int64))


def extract_token_timestamps(cross_attn, alignment_heads,
                             median_filter_width: int = 7,
                             time_precision: float = 0.02,
                             num_positions=None):
    """Token-level timestamps from cross-attention weights (L, B, H, T, S)
    by DTW over the ``alignment_heads`` (layer, head) pairs
    (generation_whisper.py:176-255).  ``num_positions`` crops S first (an
    int or one per batch row).  Returns (B, T + 1) f32; ``[:, 1:]`` are
    the DTW jump times."""
    cross_attn = np.asarray(cross_attn, np.float32)
    w = np.stack([cross_attn[l][:, h] for l, h in alignment_heads])
    w = w.transpose(1, 0, 2, 3)                        # (B, N, T, S)
    batch, _, t_len, _ = w.shape
    timestamps = np.zeros((batch, t_len + 1), np.float32)
    per_batch = (num_positions is not None
                 and not isinstance(num_positions, int)
                 and len(np.unique(np.asarray(num_positions))) > 1)
    if not per_batch:
        if num_positions is not None:
            np_i = (num_positions if isinstance(num_positions, int)
                    else int(np.asarray(num_positions).reshape(-1)[0]))
            w = w[..., :np_i]
        std = w.std(axis=-2, keepdims=True)
        mean = w.mean(axis=-2, keepdims=True)
        w = median_filter((w - mean) / std, median_filter_width)
        w = w.mean(axis=1)                             # (B, T, S)
    for b in range(batch):
        if per_batch:
            m = w[b, ..., : int(np.asarray(num_positions)[b])]
            std = m.std(axis=-2, keepdims=True)
            mean = m.mean(axis=-2, keepdims=True)
            m = median_filter((m - mean) / std, median_filter_width)
            m = m.mean(axis=0)
        else:
            m = w[b]
        text_idx, time_idx = dynamic_time_warping(-m.astype(np.float64))
        jumps = np.pad(np.diff(text_idx), (1, 0),
                       constant_values=1).astype(bool)
        timestamps[b, 1:] = time_idx[jumps] * time_precision
    return timestamps


# --------------------------------------------------------------- long form
class WhisperASR:
    """Long-form transcription of speech tokens (generation_whisper.py:
    277-775): each of the codec's 30 s token segments (``segment_tokens``
    375) decoded on its own, the temperature fallback ladder
    (``generate_with_fallback``, :775-925) read on the host once a rung,
    gated on the compression ratio and the average log-prob (:1027-1070).
    The post-VQ encoder reads ``codebook[ids] + embed_positions2``
    (modeling_whisper.py:1466), so no acoustic states are needed.

    ``post_state`` / ``dec_state``: state dicts of ``PostVQEncoder(cfg)`` /
    ``WhisperVQDecoder(cfg)`` (``weights.post_vq_state_from_jax``, the
    ``post_vq`` / ``whisper_decoder`` converters or ``seeded_state``);
    ``codebook`` (quantize_vocab_size, d).  Runs on CUDA unless ``device``
    says otherwise, in ``dtype`` (f32 by default); the decodes replay their
    steps as CUDA graphs unless ``graphs=False``."""

    def __init__(self, cfg: WhisperVQConfig, post_state, dec_state, codebook,
                 bos_id: int = 1, eos_id: int = 2, max_len: int = 64,
                 segment_tokens: int = 375,
                 timestamp_begin: Optional[int] = None,
                 time_precision: float = 0.02, alignment_heads=None,
                 median_filter_width: int = 7, device=None, dtype=None,
                 graphs: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.post = load_lm(PostVQEncoder, cfg, post_state, self.device, dtype)
        self.dec = load_lm(WhisperVQDecoder, cfg, dec_state, self.device,
                           dtype)
        self.codebook = torch.tensor(np.asarray(codebook, np.float32),
                                     dtype=dtype or torch.float32,
                                     device=self.device)
        self.bos_id, self.eos_id = bos_id, eos_id
        self.max_len = max_len
        self.segment_tokens = segment_tokens
        # Whisper reserves the vocabulary's tail for <|0.00|>..<|30.00|>
        # (1501 ids); generation_whisper.py:520
        self.timestamp_begin = (timestamp_begin if timestamp_begin
                                is not None else cfg.vocab_size - 1501)
        self.time_precision = time_precision
        # DTW alignment heads (generation_whisper.py:946-950): every
        # cross-attention head when none are published
        self.alignment_heads = (
            tuple(tuple(p) for p in alignment_heads)
            if alignment_heads is not None else
            tuple((l, h) for l in range(cfg.decoder_layers)
                  for h in range(cfg.decoder_attention_heads)))
        self.median_filter_width = median_filter_width
        self.steps = DecodeSteps(self.dec, max_len, graphs)

    @torch.no_grad()
    def encode_segments(self, ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids (1, T) -> (post-VQ states (S, segment_tokens, D), valid (S,
        segment_tokens)) over the zero-padded segments."""
        st = self.segment_tokens
        ids = torch.as_tensor(np.asarray(ids, np.int64).reshape(1, -1),
                              device=self.device)
        t = ids.shape[1]
        pad = (-t) % st
        ids = F.pad(ids, (0, pad)).reshape(-1, st)
        valid = (torch.arange(t + pad, device=self.device) < t).reshape(-1, st)
        q = self.codebook[torch.clamp(ids, min=0)]
        return self.post(q * valid[..., None].to(q.dtype), valid), valid

    def transcribe(self, ids, beam_size: int = 0,
                   temperatures=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                   compression_ratio_threshold: float = 2.4,
                   logprob_threshold: float = -1.0,
                   return_timestamps: bool = False,
                   word_timestamps: bool = False, seed: int = 0):
        """ids (1, T) speech tokens -> per-segment transcripts (bos and eos
        stripped), in order.  ``beam_size > 1``: beam search, no ladder;
        ``return_timestamps``: [(start_s, end_s, text_ids)] across the
        segments, offset ``s * segment_tokens * 80 ms``;
        ``word_timestamps``: [(tokens, times)] a segment from DTW over the
        cross-attention.  Sampling rung r of segment s draws from seed
        ``seed + s``, draws ``r << 16`` on."""
        enc, vsegs = self.encode_segments(ids)
        seg_sec = (self.segment_tokens * self.cfg.samples_per_token
                   / self.cfg.sampling_rate)
        out = []
        for s in range(enc.shape[0]):
            e, v = enc[s:s + 1], vsegs[s:s + 1]
            if return_timestamps:
                toks, n = self.steps.timestamp(e, v, self.bos_id,
                                               self.eos_id,
                                               self.timestamp_begin)
                out.extend(extract_timestamp_segments(
                    toks[0].cpu().numpy(), int(n[0]), self.timestamp_begin,
                    self.time_precision, offset_sec=s * seg_sec))
                continue
            if beam_size > 1:
                toks, n, _ = self.steps.beam(e, v, self.bos_id, self.eos_id,
                                             beam_size)
                toks, n = toks.cpu().numpy(), int(n[0])
            else:
                toks, n = self._fallback_decode(
                    e, v, temperatures, compression_ratio_threshold,
                    logprob_threshold, seed + s)
            if word_timestamps:
                out.append(self._token_times(toks, n, e, v,
                                             offset_sec=s * seg_sec))
                continue
            seq = toks[0, 1:n]
            out.append(np.asarray(seq[seq != self.eos_id], np.int32))
        return out

    @torch.no_grad()
    def _token_times(self, toks, n: int, e, v, offset_sec: float = 0.0):
        """(tokens (m,), times (m,)) of one decoded segment by DTW over one
        full-prefix forward's cross-attention; S cropped to the segment's
        valid tokens (generation_whisper.py:186-191, 230-240)."""
        toks_t = torch.as_tensor(np.asarray(toks, np.int64)[:1],
                                 device=self.device)
        tv = torch.arange(toks_t.shape[1], device=self.device)[None] < max(
            n, 1)
        _, attn = self.dec(toks_t, tv, e, v, return_cross_attn=True)
        attn = attn.float().cpu().numpy()[:, :, :, :n, :]
        pos_sec = self.cfg.samples_per_token / self.cfg.sampling_rate
        ts = extract_token_timestamps(
            attn, self.alignment_heads,
            median_filter_width=self.median_filter_width,
            time_precision=pos_sec, num_positions=int(v.sum()))
        # position p pairs with jump p - 1 (generation_whisper.py:951)
        seq = np.asarray(toks)[0, 1:n]
        times = ts[0, 1:n] + offset_sec
        keep = seq != self.eos_id
        return (seq[keep].astype(np.int32), times[keep].astype(np.float32))

    def _fallback_decode(self, e, v, temperatures, cr_threshold,
                         lp_threshold, seed: int):
        """The temperature ladder: decode again at the next temperature
        while the output looks degenerate (generation_whisper.py:775,
        1027-1070)."""
        best = None
        for rung, temp in enumerate(temperatures):
            toks, n, lp = self.steps.sample(e, v, self.bos_id, self.eos_id,
                                            float(temp), seed, rung << 16)
            toks = toks.cpu().numpy()
            n_i = int(n[0])
            avg_lp = float(lp[0]) / max(n_i, 1)
            best = (toks, n_i)
            if (compression_ratio(toks[0, 1:n_i]) <= cr_threshold
                    and avg_lp >= lp_threshold):
                break
        return best
