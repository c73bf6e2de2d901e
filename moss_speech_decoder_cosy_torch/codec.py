"""The speech codec: wav <-> tokens <-> wav, after the JAX package's
``codec.py`` (the reference's GLM4Codec / GLM4Encoder sessions,
GLM_modules/modeling_glm4_codec.py:12-124, whisper_encoder_decoder.py:
35-314):

- ``encode``: 16 kHz wav -> tokens at 12.5 Hz, in 30 s segments
  (speech_tokenizer/utils.py:44-96), each padded to a bucket of 128 mel
  frames with a valid mask;
- ``encode_streaming``: 80 ms chunks through the causal path, equal to
  ``encode`` token for token;
- ``prepare_prompt``: a prompt wav -> (prompt tokens, prompt mel, speaker
  embedding), optionally cut to its loudest segment and RMS-normalized;
- ``decode`` / ``decode_streaming`` / ``convert_voice`` over the port's
  ``AudioDecoder``.

The tokenizer, the features and the prompt mel run on the codec's device
(CUDA unless the caller passes ``device="cpu"``); tokens come back to the
host as int32 numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional

import numpy as np
import torch

from .ops.melspec import matcha_mel_spectrogram
from .pipeline import AudioDecoder
from .tokenizer import (StreamingFeatures, WhisperFeatureExtractor,
                        WhisperVQConfig, WhisperVQEncoder)
from .utils.device import resolve_device


def _bucket(n: int, step: int = 512) -> int:
    return max(step, ((n + step - 1) // step) * step)


def _segment_frames(t: int, mel_per_tok: int, max_frames: int):
    """(tokens, padded frames) of a segment of ``t`` mel frames: tokens by
    floor, as the conv stride trims; frames padded to a bucket of 16 tokens
    but never past ``max_frames``, the position table's 2 frames a slot (a
    full 30 s segment is 3000 frames, whose bucket of 3072 would need 1536
    of the 1500 slots)."""
    n_tok = max(1, t // mel_per_tok)
    return n_tok, min(_bucket(n_tok * mel_per_tok, 16 * mel_per_tok),
                      max_frames)


@dataclasses.dataclass
class Prompt:
    token: np.ndarray        # (1, P)
    feat: np.ndarray         # (1, P * ratio, 80)
    embedding: np.ndarray    # (1, 192)


# ---------------------------------------------------------------------------
# prompt preparation (the reference VC demos' prompt picker,
# gradio_voice_converter_unstreaming.py:57-120)
# ---------------------------------------------------------------------------

def calculate_rms(wav: np.ndarray) -> float:
    """RMS of a waveform."""
    w = np.asarray(wav, np.float64).reshape(-1)
    return float(np.sqrt(np.mean(w * w))) if w.size else 0.0


def normalize_volume(wav: np.ndarray, target_rms: float) -> np.ndarray:
    """A waveform scaled to ``target_rms``; silence passes unchanged."""
    wav = np.asarray(wav, np.float32)
    rms = calculate_rms(wav)
    if rms > 0:
        wav = wav * np.float32(target_rms / rms)
    return wav


def find_loudest_segment(wav: np.ndarray, sr: int, segment_duration: float,
                         window_size: float = 0.1,
                         return_bounds: bool = False):
    """The loudest contiguous ``segment_duration``-second slice: RMS over
    ``window_size`` windows (hop a quarter window), box-smoothed over the
    segment's windows, the argmax picking the start.  ``return_bounds``
    also returns the (start, end) sample indices."""
    flat = np.asarray(wav, np.float32).reshape(-1)
    n = flat.size
    seg = int(segment_duration * sr)
    if n <= segment_duration * sr:
        return (wav, (0, n)) if return_bounds else wav
    win = int(window_size * sr)
    hop = max(win // 4, 1)
    sq = np.concatenate([[0.0], np.cumsum(flat.astype(np.float64) ** 2)])
    starts = np.arange(0, n - win + 1, hop)
    energies = np.sqrt((sq[starts + win] - sq[starts]) / win)
    kernel_size = max(1, int(segment_duration / window_size))
    if energies.size >= kernel_size:
        smoothed = np.convolve(energies, np.ones(kernel_size) / kernel_size,
                               mode="valid")
    else:
        smoothed = energies
    start = int(np.argmax(smoothed)) * hop
    end = start + seg
    if end > n:
        end = n
        start = max(0, end - seg)
    sliced = (wav[..., start:end] if np.asarray(wav).ndim > 1
              else flat[start:end])
    return (sliced, (start, end)) if return_bounds else sliced


class SpeechCodec:
    """``tok_state`` a state dict of ``WhisperVQEncoder(tok_cfg)``
    (``weights.tokenizer_state_from_jax`` or a seeded one);
    ``speaker_encoder`` a ``models.campplus.SpeakerEncoder`` or None (zero
    embeddings)."""

    def __init__(self, tok_cfg: WhisperVQConfig,
                 tok_state: Mapping[str, torch.Tensor],
                 decoder: AudioDecoder, speaker_encoder=None,
                 segment_seconds: float = 30.0, prompt_mel_fn=None,
                 device=None):
        self.device = resolve_device(device)
        self.tok_cfg = tok_cfg
        with torch.device("meta"):
            tok = WhisperVQEncoder(tok_cfg)
        tok.load_state_dict(tok_state, strict=True, assign=True)
        self.tokenizer = tok.to(self.device).eval()
        self.decoder = decoder
        self.speaker_encoder = speaker_encoder
        self.features = WhisperFeatureExtractor(
            tok_cfg.n_fft, tok_cfg.hop_length, tok_cfg.num_mel_bins,
            tok_cfg.sampling_rate)
        # a segment's frames never exceed the position table: at the
        # GLM-4-Voice config the 30 s segmentation is the ring's capacity
        # (1500 post-conv positions * 2 * hop = 30 s), rounded down to
        # whole tokens so that no frame is dropped at a segment's end; the
        # bucket padding is capped at the table too (``_segment_frames``)
        ring_samples = tok_cfg.max_source_positions * 2 * tok_cfg.hop_length
        seg = min(int(segment_seconds * tok_cfg.sampling_rate), ring_samples)
        self.segment_samples = max(tok_cfg.samples_per_token,
                                   seg - seg % tok_cfg.samples_per_token)
        self.prompt_mel_fn = prompt_mel_fn or matcha_mel_spectrogram

    def _wav(self, wav) -> torch.Tensor:
        return torch.as_tensor(np.asarray(wav, np.float32).reshape(1, -1)
                               ).to(self.device)

    # ------------------------------------------------------------- encode
    @torch.inference_mode()
    def encode_features(self, wav_16k: np.ndarray):
        """``encode`` with the pooled pre-VQ features: a list of (ids (1, n)
        on the device, pooled (1, n, d)) per segment."""
        wav = np.asarray(wav_16k, np.float32).reshape(1, -1)
        mel_per_tok = 2 * self.tok_cfg.pooling_kernel_size
        out = []
        for s in range(0, wav.shape[1], self.segment_samples):
            feats, _ = self.features(self._wav(wav[:, s: s +
                                                   self.segment_samples]))
            t = feats.shape[1]
            n_tok, t_pad = _segment_frames(
                t, mel_per_tok, 2 * self.tok_cfg.max_source_positions)
            feats = torch.nn.functional.pad(
                feats, (0, 0, 0, max(t_pad - t, 0)))[:, :t_pad]
            valid = torch.zeros((1, t_pad), dtype=torch.bool,
                                device=self.device)
            valid[:, : n_tok * mel_per_tok] = True
            ids, token_valid, pooled = self.tokenizer.encode(feats, valid)
            out.append((ids[token_valid][None], pooled[token_valid][None]))
        return out

    def encode(self, wav_16k: np.ndarray) -> np.ndarray:
        """wav (L,) or (1, L) float32 at 16 kHz -> (1, n_tokens) int32."""
        return np.concatenate([ids.cpu().numpy() for ids, _ in
                               self.encode_features(wav_16k)],
                              axis=1).astype(np.int32)

    def new_encode_session(self) -> "TokenizerSession":
        return TokenizerSession(self)

    def encode_streaming(self, wav_16k: np.ndarray,
                         chunk_samples: Optional[int] = None) -> np.ndarray:
        """The wav fed in 80 ms chunks through the causal path; equal to
        ``encode`` token for token."""
        wav = np.asarray(wav_16k, np.float32).reshape(-1)
        step = chunk_samples or self.tok_cfg.samples_per_token
        sess = self.new_encode_session()
        toks: List[np.ndarray] = []
        for s in range(0, len(wav), step):
            toks.extend(sess.push(wav[s: s + step]))
        toks.extend(sess.flush())
        return (np.concatenate(toks, axis=1).astype(np.int32) if toks
                else np.zeros((1, 0), np.int32))

    # ------------------------------------------------------------- prompt
    def prompt_embedding(self, prompt_wav_16k: np.ndarray) -> np.ndarray:
        if self.speaker_encoder is None:
            return np.zeros((1, self.decoder.flow_cfg.spk_embed_dim),
                            np.float32)
        return np.asarray(self.speaker_encoder(prompt_wav_16k),
                          np.float32).reshape(1, -1)

    @torch.inference_mode()
    def prepare_prompt(self, prompt_wav_24k: np.ndarray,
                       prompt_wav_16k: np.ndarray,
                       pick_loudest_seconds: Optional[float] = None,
                       target_rms: Optional[float] = None) -> Prompt:
        """The flow's conditioning from a reference utterance
        (whisper_encoder_decoder.py:210-240): tokens of the 16 kHz wav, the
        matcha mel of the 24 kHz one, trimmed to ``ratio`` frames a token,
        and the speaker embedding.  ``pick_loudest_seconds`` cuts both
        rates to the loudest segment (picked once, on the 16 kHz wav);
        ``target_rms`` normalizes their loudness."""
        if pick_loudest_seconds is not None:
            w16 = np.asarray(prompt_wav_16k, np.float32).reshape(-1)
            _, (s16, e16) = find_loudest_segment(
                w16, 16000, pick_loudest_seconds, return_bounds=True)
            prompt_wav_16k = w16[s16:e16]
            w24 = np.asarray(prompt_wav_24k, np.float32).reshape(-1)
            s24 = (s16 * 3) // 2                   # the same instant at 24k
            prompt_wav_24k = w24[s24: s24 + ((e16 - s16) * 3) // 2]
        if target_rms is not None:
            prompt_wav_16k = normalize_volume(prompt_wav_16k, target_rms)
            prompt_wav_24k = normalize_volume(prompt_wav_24k, target_rms)
        ratio = self.decoder.ratio
        token = self.encode(prompt_wav_16k)
        feat = self.prompt_mel_fn(self._wav(prompt_wav_24k)).float().cpu(
        ).numpy()
        token_len = min(feat.shape[1] // ratio, token.shape[1])
        return Prompt(token=token[:, :token_len].astype(np.int32),
                      feat=feat[:, : ratio * token_len].astype(np.float32),
                      embedding=self.prompt_embedding(prompt_wav_16k))

    # ------------------------------------------------------------- decode
    def _prompt(self, prompt: Optional[Prompt]) -> Prompt:
        return prompt or Prompt(
            np.zeros((1, 0), np.int32),
            np.zeros((1, 0, self.decoder.flow_cfg.output_size), np.float32),
            np.zeros((1, self.decoder.flow_cfg.spk_embed_dim), np.float32))

    def decode(self, token: np.ndarray,
               prompt: Optional[Prompt] = None) -> np.ndarray:
        p = self._prompt(prompt)
        return self.decoder.token2wav(np.asarray(token), p.token, p.feat,
                                      p.embedding)

    def decode_streaming(self, token: np.ndarray,
                         prompt: Optional[Prompt] = None,
                         block_size: Optional[int] = None,
                         max_token_len: Optional[int] = None) -> np.ndarray:
        p = self._prompt(prompt)
        return self.decoder.stream_inference(
            np.asarray(token), p.token, p.feat, p.embedding,
            block_size=block_size, max_token_len=max_token_len)

    def convert_voice(self, wav_16k: np.ndarray, prompt: Prompt,
                      streaming: bool = False) -> np.ndarray:
        """wav -> tokens -> wav in the prompt's voice."""
        token = self.encode(wav_16k)
        if streaming:
            return self.decode_streaming(token, prompt)
        return self.decode(token, prompt)


class TokenizerSession:
    """Incremental 16 kHz samples -> tokens at 80 ms granularity, equal to
    the batch ``encode``: features from ``StreamingFeatures`` (a 12.5 ms
    hold-back gives every frame its true context), and a new segment (fresh
    features, caches and position) whenever the KV caches would reach
    ``max_source_positions``, the twin of the batch path's 30 s segments.
    The clamp's maximum carries over to the next segment."""

    def __init__(self, codec: SpeechCodec):
        self.codec = codec
        self.mel_per_tok = 2 * codec.tok_cfg.pooling_kernel_size
        self._stream = StreamingFeatures(codec.features, codec.device)
        self._feat_buf: Optional[torch.Tensor] = None   # < 8 frames left
        self._seg_fed = 0                               # samples this segment
        self.state = codec.tokenizer.init_state(1)

    @torch.inference_mode()
    def _consume(self, feats: Optional[torch.Tensor]) -> List[np.ndarray]:
        if feats is None:
            return []
        if self._feat_buf is not None:
            feats = torch.cat([self._feat_buf, feats], dim=1)
        t = (feats.shape[1] // self.mel_per_tok) * self.mel_per_tok
        ids = [self.codec.tokenizer.step(feats[:, i: i + self.mel_per_tok],
                                         self.state)[0]
               for i in range(0, t, self.mel_per_tok)]
        self._feat_buf = feats[:, t:] if t < feats.shape[1] else None
        return [i.cpu().numpy() for i in ids]

    def _next_segment(self) -> List[np.ndarray]:
        """Closes the segment and starts a fresh one, as the batch path
        extracts each segment on its own; the clamp's maximum carries."""
        out = self._consume(self._stream.flush())
        max_carry = self._stream.max_log_spec
        self._stream = StreamingFeatures(self.codec.features,
                                         self.codec.device)
        self._stream.max_log_spec = max_carry
        self._feat_buf = None
        self.state = self.codec.tokenizer.init_state(1)
        self._seg_fed = 0
        return out

    def push(self, samples: np.ndarray) -> List[np.ndarray]:
        samples = np.asarray(samples, np.float32).reshape(-1)
        seg_cap = self.codec.segment_samples
        out: List[np.ndarray] = []
        pos = 0
        while pos < len(samples):
            take = samples[pos: pos + seg_cap - self._seg_fed]
            pos += len(take)
            self._seg_fed += len(take)
            out.extend(self._consume(self._stream.push(take)))
            if self._seg_fed == seg_cap:
                out.extend(self._next_segment())
        return out

    def flush(self) -> List[np.ndarray]:
        """The tokens of the buffered tail (floor(T / 8) in all, as the
        batch path)."""
        return self._consume(self._stream.flush())
