"""Mel features of the prompt and speaker paths, after the JAX package's
``ops/melspec.py``:

- ``matcha_mel_spectrogram``: the flow prompt's mel (80 bins at 24 kHz,
  n_fft 1920, hop 480, no centering but (n_fft - hop) / 2 reflect padding,
  log clamped at 1e-5; the reference's matcha ``mel_spectrogram``);
- ``kaldi_fbank``: torchaudio's ``compliance.kaldi.fbank(num_mel_bins=80,
  dither=0)``, the CAM++ input: ``snip_edges``, DC removal, preemphasis
  0.97, the povey window, an FFT rounded up to a power of two, HTK mel
  triangles from 20 Hz, log with a float-eps floor.

The DFTs are f32 matrix products against cached bases (``ops/stft.py``),
on the wav's device.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch
import torch.nn.functional as F

from . import stft as stft_ops
from ..tokenizer.features import mel_filter_bank


def matcha_mel_spectrogram(wav: torch.Tensor, n_fft: int = 1920,
                           num_mels: int = 80, sampling_rate: int = 24000,
                           hop_size: int = 480, win_size: int = 1920,
                           fmin: float = 0.0, fmax: float = 8000.0
                           ) -> torch.Tensor:
    """wav (B, L) -> log-mel (B, T, num_mels), T = (L - hop) // hop + 1
    after (n_fft - hop) / 2 reflect padding on both sides."""
    pad = (n_fft - hop_size) // 2
    x = stft_ops.reflect_pad(wav.float(), pad)
    real, imag = stft_ops.stft(x, n_fft, hop_size,
                               _hann(win_size), center=False)
    mag = torch.sqrt(real * real + imag * imag + 1e-9)
    filters = mel_filter_bank(n_fft // 2 + 1, num_mels, sampling_rate,
                              fmin, fmax)
    mel = mag @ stft_ops._t(filters, wav.device)
    return torch.log(torch.clamp(mel, min=1e-5))


@functools.lru_cache(maxsize=None)
def _hann(n: int) -> np.ndarray:
    return stft_ops.hann_window(n)


@functools.lru_cache(maxsize=None)
def _povey_window(n: int) -> np.ndarray:
    """Kaldi's povey window: (0.5 - 0.5 cos(2 pi i / (n - 1))) ** 0.85."""
    i = np.arange(n, dtype=np.float64)
    return ((0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))) ** 0.85
            ).astype(np.float32)


def _hz_to_mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


@functools.lru_cache(maxsize=None)
def kaldi_mel_banks(num_bins: int, n_fft: int, sample_rate: int,
                    low_freq: float = 20.0, high_freq: float = 0.0
                    ) -> np.ndarray:
    """Kaldi mel triangles in the mel domain (no slaney norm), (n_fft // 2,
    num_bins), as torchaudio's ``compliance.kaldi.get_mel_banks`` (Kaldi
    drops the Nyquist bin)."""
    if high_freq <= 0:
        high_freq = sample_rate / 2 + high_freq
    mel_low, mel_high = _hz_to_mel_htk(low_freq), _hz_to_mel_htk(high_freq)
    delta = (mel_high - mel_low) / (num_bins + 1)
    centers = mel_low + np.arange(num_bins + 2) * delta
    mel_f = _hz_to_mel_htk(np.arange(n_fft // 2) * sample_rate / n_fft)
    left, center, right = (centers[:-2][None, :], centers[1:-1][None, :],
                           centers[2:][None, :])
    up = (mel_f[:, None] - left) / (center - left)
    down = (right - mel_f[:, None]) / (right - center)
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def kaldi_fbank(wav: torch.Tensor, num_mel_bins: int = 80,
                sample_rate: int = 16000, frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0,
                preemphasis: float = 0.97) -> torch.Tensor:
    """wav (B, L) in [-1, 1] -> (B, T, num_mel_bins) log-mel with Kaldi's
    semantics and dither 0.  The float wav is used as it is, as torchaudio
    does (Kaldi itself scales to the int16 range)."""
    win = int(sample_rate * frame_length_ms / 1000)      # 400
    hop = int(sample_rate * frame_shift_ms / 1000)       # 160
    n_fft = 1 << (win - 1).bit_length()                  # 512
    dev = wav.device
    frames = wav.float().unfold(-1, win, hop)            # snip_edges
    frames = frames - frames.mean(dim=-1, keepdim=True)
    # preemphasis with the first sample replicated (Kaldi's offset)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - preemphasis * prev) * stft_ops._t(
        _povey_window(win), dev)
    frames = F.pad(frames, (0, n_fft - win))
    cos_b, sin_b = stft_ops._dft_bases(n_fft)
    real = frames @ stft_ops._t(cos_b, dev)
    imag = frames @ stft_ops._t(sin_b, dev)
    power = (real * real + imag * imag)[..., : n_fft // 2]
    mel = power @ stft_ops._t(kaldi_mel_banks(num_mel_bins, n_fft,
                                              sample_rate), dev)
    return torch.log(torch.clamp(mel, min=sys.float_info.epsilon))
