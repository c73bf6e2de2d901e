"""Silence-boundary audio chunker for web emission (the JAX package's
``serving/audio_process.py``; GLM_modules/audio_process.py:10-96 rebuilt).

Buffers synthesized audio and emits chunks cut at low-energy boundaries, so
the browser never splices mid-phoneme."""

from __future__ import annotations

from typing import Optional

import numpy as np


class AudioStreamProcessor:
    def __init__(self, sr: int = 24000, min_chunk_seconds: float = 0.5,
                 silence_threshold: float = 0.01,
                 silence_window: int = 240):
        self.sr = sr
        self.min_chunk = int(sr * min_chunk_seconds)
        self.threshold = silence_threshold
        self.window = silence_window
        self.buf = np.zeros(0, np.float32)

    def push(self, samples: np.ndarray) -> Optional[np.ndarray]:
        """Appends audio; returns a chunk ending at a silence boundary once
        at least ``min_chunk`` samples are buffered, else None.  The cut is
        the middle of the first window under the threshold after
        ``min_chunk``, else of the quietest one, else the buffer's end."""
        self.buf = np.concatenate(
            [self.buf, np.asarray(samples, np.float32).reshape(-1)])
        if len(self.buf) < self.min_chunk:
            return None
        n_win = (len(self.buf) - self.min_chunk) // self.window
        best, best_rms = None, np.inf
        for i in range(n_win):
            s = self.min_chunk + i * self.window
            w = self.buf[s: s + self.window]
            rms = float(np.sqrt(np.mean(w * w) + 1e-12))
            if rms < best_rms:
                best, best_rms = s + self.window // 2, rms
            if rms < self.threshold:
                best = s + self.window // 2
                break
        cut = best if best is not None else len(self.buf)
        chunk, self.buf = self.buf[:cut], self.buf[cut:]
        return chunk

    def flush(self) -> np.ndarray:
        chunk, self.buf = self.buf, np.zeros(0, np.float32)
        return chunk
