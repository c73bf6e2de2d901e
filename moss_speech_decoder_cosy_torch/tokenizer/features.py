"""Whisper log-mel features (128 bins), after the JAX package's
``tokenizer/features.py`` (the reference's forked WhisperFeatureExtractor,
whisper_feat_extractor.py:127-161): STFT (400 / 160, Hann, centered) ->
power with the last frame dropped -> slaney mel -> log10 -> clamp at
(max - 8) -> (x + 4) / 4.

``max_log_spec`` lets chunked extraction clamp against a running maximum
instead of each chunk's own (the fork's addition), in raw log10 units in
and out.  ``StreamingFeatures`` emits exactly the offline frames.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import stft as stft_ops
from ..utils.device import resolve_device


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(freq >= 1000.0,
                    15.0 + np.log(np.maximum(freq, 1e-10) / 1000.0)
                    * logstep, mels)


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(mels >= 15.0, 1000.0 * np.exp(logstep * (mels - 15.0)),
                    freq)


@functools.lru_cache(maxsize=None)
def mel_filter_bank(n_freqs: int, n_mels: int, sampling_rate: int,
                    fmin: float = 0.0, fmax: Optional[float] = None
                    ) -> np.ndarray:
    """(n_freqs, n_mels) slaney-scale, slaney-normalized triangular filters
    (HF ``mel_filter_bank(norm='slaney', mel_scale='slaney')``)."""
    fmax = fmax if fmax is not None else sampling_rate / 2
    fft_freqs = np.linspace(0, sampling_rate / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_slaney(np.array(fmin)),
                          _hz_to_mel_slaney(np.array(fmax)), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    fb *= (2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


class WhisperFeatureExtractor:
    """wav (B, L) at 16 kHz -> log-mel (B, L // hop, n_mels), on the wav's
    device."""

    def __init__(self, n_fft: int = 400, hop_length: int = 160,
                 n_mels: int = 128, sampling_rate: int = 16000):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.sampling_rate = sampling_rate
        self.window = stft_ops.hann_window(n_fft)
        self.filters = mel_filter_bank(n_fft // 2 + 1, n_mels, sampling_rate)

    def log_mel(self, wav: torch.Tensor, center: bool = True
                ) -> torch.Tensor:
        """The raw log10 mel power of the frames of ``wav`` (B, L) f32."""
        real, imag = stft_ops.stft(wav.float(), self.n_fft, self.hop_length,
                                   self.window, center=center)
        power = real * real + imag * imag
        if center:
            power = power[:, :-1]                        # drop the last frame
        mel = power @ stft_ops._t(self.filters, wav.device)
        return torch.log10(torch.clamp(mel, min=1e-10))

    @torch.inference_mode()
    def __call__(self, wav: torch.Tensor,
                 max_log_spec: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (features (B, T, n_mels), max_log_spec 0-d).  Pass the
        returned ``max_log_spec`` back for later chunks, so that chunked
        normalization matches offline extraction."""
        log_spec = self.log_mel(wav)
        max_val = torch.amax(log_spec)
        if max_log_spec is not None:
            max_val = torch.as_tensor(max_log_spec, dtype=log_spec.dtype,
                                      device=log_spec.device)
        log_spec = torch.maximum(log_spec, max_val - 8.0)
        return (log_spec + 4.0) / 4.0, max_val


class StreamingFeatures:
    """Incremental extraction equal, frame for frame, to the offline
    extractor.  The offline STFT is centered: frame t sees samples
    [t*hop - n_fft/2, t*hop + n_fft/2).  Instead of the reference's
    per-chunk padding, ``n_fft / 2`` samples are held back so that every
    emitted frame has its true context.  The clamp uses the maximum of the
    first emitted block, then stays (the fork's ``max_log_spec`` carry).
    Samples are kept on the host; each emitted block is computed on
    ``device`` (CUDA unless the caller passes ``device="cpu"``)."""

    def __init__(self, fe: WhisperFeatureExtractor, device=None):
        self.fe = fe
        self.device = resolve_device(device)
        self._buf = np.zeros(0, np.float32)   # samples from frame _f0's left
        self._f0 = 0                          # next frame to emit
        self._started = False
        self.max_log_spec: Optional[torch.Tensor] = None

    @property
    def _half(self) -> int:
        return self.fe.n_fft // 2

    def push(self, samples: np.ndarray) -> Optional[torch.Tensor]:
        """Feeds samples; returns the features of every frame whose whole
        (centered) context is now here, or None."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        hop, half = self.fe.hop_length, self._half
        if not self._started:
            if len(self._buf) + len(samples) <= half:
                self._buf = np.concatenate([self._buf, samples])
                return None
            buf = np.concatenate([self._buf, samples])
            # the left reflect padding of center=True at the stream's start
            self._buf = np.concatenate([buf[half:0:-1], buf])
            self._started = True
        else:
            self._buf = np.concatenate([self._buf, samples])
        n = (len(self._buf) - self.fe.n_fft) // hop + 1
        if n <= 0:
            return None
        return self._emit(n, self._buf[: (n - 1) * hop + self.fe.n_fft])

    def flush(self) -> Optional[torch.Tensor]:
        """Emits the remaining frames with right reflect padding, as the
        offline extractor's tail (L // hop frames in all)."""
        hop, half = self.fe.hop_length, self._half
        if not self._started:
            if len(self._buf) == 0:
                return None
            buf = self._buf
            self._buf = np.concatenate([buf[half:0:-1], buf])
            self._started = True
        total_len = len(self._buf)
        length = self._f0 * hop + total_len - half    # raw samples seen
        n = length // hop - self._f0
        if n <= 0:
            return None
        need = (n - 1) * hop + self.fe.n_fft
        pad = need - total_len
        buf = self._buf
        if pad > 0:
            buf = np.concatenate([buf, buf[-2: -2 - pad: -1]])
        return self._emit(n, buf[:need])

    @torch.inference_mode()
    def _emit(self, n: int, window: np.ndarray) -> torch.Tensor:
        hop = self.fe.hop_length
        wav = torch.from_numpy(np.ascontiguousarray(window)).to(
            self.device).reshape(1, -1)
        log_spec = self.fe.log_mel(wav, center=False)
        if self.max_log_spec is None:
            self.max_log_spec = torch.amax(log_spec)
        feats = (torch.maximum(log_spec, self.max_log_spec - 8.0) + 4.0) / 4.0
        self._buf = self._buf[n * hop:]
        self._f0 += n
        return feats
