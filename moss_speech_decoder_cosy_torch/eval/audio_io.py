"""WAV IO and resampling on the host (the port's own copy of the JAX
package's ``eval/audio_io.py``; scipy, no torchaudio)."""

from __future__ import annotations

from math import gcd
from typing import Tuple

import numpy as np


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Returns (mono float32 samples in [-1, 1], sample_rate)."""
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)
    return x, int(sr)


def read_wav_bytes(fileobj) -> Tuple[np.ndarray, int]:
    """``read_wav`` over an in-memory file-like (network blobs)."""
    return read_wav(fileobj)


def write_wav(path, samples: np.ndarray, sample_rate: int) -> None:
    """16-bit PCM mono, the reference's output format
    (CLIENT_STREAMING_USAGE.md:110)."""
    from scipy.io import wavfile
    x = np.clip(np.asarray(samples, np.float32).reshape(-1), -1.0, 1.0)
    wavfile.write(path, sample_rate, (x * 32767.0).astype(np.int16))


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (``scipy.signal.resample_poly``)."""
    if sr_in == sr_out:
        return np.asarray(x, np.float32)
    from scipy.signal import resample_poly
    g = gcd(sr_in, sr_out)
    return resample_poly(np.asarray(x, np.float32),
                         sr_out // g, sr_in // g).astype(np.float32)
