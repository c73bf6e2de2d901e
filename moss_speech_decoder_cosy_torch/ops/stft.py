"""STFT / iSTFT with torch.stft / torch.istft semantics, in the matmul form
of the JAX package's ``ops/stft.py``: f32 DFT bases applied with a matmul
(no FFT), ``center=True`` reflect padding, the (T-1)*hop output length of
``torch.istft``, and overlap-add by the stride decomposition when
``n_fft % hop == 0``.

Conventions: audio (B, L); spectra (B, T, F) with F = n_fft//2 + 1.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann window, as torch.hann_window / scipy get_window."""
    n = np.arange(n_fft, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_bases(n_fft: int):
    """cos/sin bases (n_fft, F) for the forward real DFT."""
    f = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(f)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _idft_bases(n_fft: int):
    """Weighted bases (F, n_fft) for the inverse real DFT (irfft)."""
    f = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :]
    k = np.arange(f)[:, None]
    ang = 2.0 * np.pi * n * k / n_fft
    w = np.full((f, 1), 2.0 / n_fft)
    w[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        w[-1] = 1.0 / n_fft
    return ((np.cos(ang) * w).astype(np.float32),
            (np.sin(ang) * w).astype(np.float32))


# (id(array), device) -> (array, its copy on the device)
_ON_DEVICE: Dict[Tuple[int, str], Tuple[np.ndarray, torch.Tensor]] = {}


def _t(a: np.ndarray, device) -> torch.Tensor:
    """``a`` (a window or a DFT basis) on ``device``, uploaded once per
    array and device, so a vocoder step captured in a CUDA graph uploads
    nothing; a normal tensor even when inference mode uploads it, so a
    training forward may use it too."""
    key = (id(a), str(torch.device(device)))
    got = _ON_DEVICE.get(key)
    if got is None or got[0] is not a:
        with torch.inference_mode(False):
            got = _ON_DEVICE[key] = (a, torch.from_numpy(a).to(device))
    return got[1]


def frame(x: torch.Tensor, n_fft: int, hop: int,
          center: bool = True) -> torch.Tensor:
    """(B, L) -> (B, T, n_fft) frames, torch.stft framing (``center``:
    n_fft // 2 reflect padding on both sides)."""
    if center:
        x = reflect_pad(x, n_fft // 2)
    return x.unfold(-1, n_fft, hop)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, L) reflect-padded by ``pad`` on both sides; a pad of L or more
    reflects again at each end (numpy's and the JAX package's ``reflect``,
    where ``F.pad`` refuses it)."""
    n = x.shape[-1]
    if pad < n:
        return F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    period = 2 * (n - 1)
    idx = np.arange(-pad, n + pad) % period
    idx = np.where(idx >= n, period - idx, idx)
    return x[:, torch.as_tensor(idx, device=x.device)]


def stft(x: torch.Tensor, n_fft: int, hop: int, window: np.ndarray,
         center: bool = True):
    """torch.stft equivalent.  Returns (real, imag) each (B, T, F) in the
    input dtype; the DFT runs in f32."""
    frames = frame(x.float(), n_fft, hop, center)
    frames = frames * _t(window, x.device)[None, None, :]
    cos_b, sin_b = _dft_bases(n_fft)
    real = frames @ _t(cos_b, x.device)
    imag = -(frames @ _t(sin_b, x.device))
    return real.to(x.dtype), imag.to(x.dtype)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T, n_fft) -> (B, (T-1)*hop + n_fft) overlap-add."""
    b, t, n_fft = frames.shape
    out_len = (t - 1) * hop + n_fft
    if n_fft % hop == 0:
        r = n_fft // hop
        out = frames.new_zeros((b, t + r - 1, hop))
        blocks = frames.reshape(b, t, r, hop)
        for j in range(r):
            out[:, j:j + t] += blocks[:, :, j]
        return out.reshape(b, -1)[:, :out_len]
    idx = (torch.arange(t, device=frames.device)[:, None] * hop
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    out = frames.new_zeros((b, out_len))
    return out.index_add(1, idx, frames.reshape(b, -1))


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int,
          window: np.ndarray) -> torch.Tensor:
    """torch.istft(center=True, length=None): (B, T, F) -> (B, (T-1)*hop),
    f32."""
    dev = real.device
    cos_b, sin_b = _idft_bases(n_fft)
    frames = (real.float() @ _t(cos_b, dev)
              - imag.float() @ _t(sin_b, dev))
    win = _t(window, dev)
    sig = _overlap_add(frames * win[None, None, :], hop)
    t = real.shape[1]
    env = _overlap_add((win * win)[None, None, :].expand(1, t, n_fft), hop)
    sig = sig / torch.clamp(env, min=1e-11)
    return sig[:, n_fft // 2: sig.shape[1] - n_fft // 2]
