"""How ``correct`` is decided: the served outputs against the plain
reference.

Once the window has closed and the program is freed, a sample of the
requests the program finished is drawn from the seed, the longest among
them (``choose``), and each compared number is held to its limit
(``verdict``).  What is compared is the configuration's family's
(``families/<family>.py``).  For the decoder family the reference decodes
each request from the same tokens and speaker vector with the same weights
(drawn again from the seed), and the numbers compared are:

- ``wav_gap``: ||served - reference|| / ||reference|| over all the sampled
  audio (a served pcm16 body read back as int16 / 32767, against the
  reference's waveform encoded the same way), so each request weighs by its
  length;
- ``band_gap_db``: over all the sampled audio's frames, the mean of the RMS
  over 24 mel-spaced bands of the difference in band energy (dB;
  2048-point frames one mel frame apart, energies floored 80 dB below the
  request's loudest reference band);
- ``length_gap``: the largest difference in samples between a served
  waveform and the reference's (a lost or extra chunk).

``per_request`` gives each sampled request's ``wav_gap`` and
``band_gap_db`` beside them.

A cell compares those named in its file's ``check.limits``, each against
its limit; the others are reported as readings.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


def choose(indices: Sequence[int], lengths: Dict[int, int], k: int,
           seed: int) -> List[int]:
    """The longest request (lowest index among equals) and ``k - 1`` others
    drawn from the seed."""
    if not indices:
        return []
    idx = sorted(indices)
    longest = max(idx, key=lambda i: (lengths[i], -i))
    rest = [i for i in idx if i != longest]
    rng = np.random.default_rng([int(seed), 2])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[int(j)] for j in pick)


def pcm16(wav: np.ndarray) -> np.ndarray:
    """The pcm16 encoding of a float waveform read back: clipped to
    [-1, 1], scaled by 32767, truncated toward zero, over 32767."""
    q = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    return q.astype(np.float32) / 32767.0


def wav_gap(served: np.ndarray, ref: np.ndarray) -> float:
    if served.shape != ref.shape:
        return math.inf
    den = float(np.linalg.norm(ref))
    return float(np.linalg.norm(served - ref)) / max(den, 1e-12)


def _mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def band_gap_frames(served: np.ndarray, ref: np.ndarray, sample_rate: int,
                    hop: int, n_fft: int = 2048, n_bands: int = 24,
                    floor_db: float = 80.0) -> np.ndarray:
    """Each frame's band-energy distance in dB on the common length (see
    the module doc)."""
    n = min(len(served), len(ref))
    if n < n_fft:
        return np.full(1, math.inf)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    edges = np.linspace(0.0, _mel(sample_rate / 2.0), n_bands + 1)
    band = np.clip(np.searchsorted(edges, _mel(freqs), side="right") - 1,
                   0, n_bands - 1)
    onehot = np.eye(n_bands)[band]                      # (bins, bands)

    def energies(x):
        frames = np.lib.stride_tricks.sliding_window_view(x[:n], n_fft)[::hop]
        power = np.abs(np.fft.rfft(frames * np.hanning(n_fft), axis=-1)) ** 2
        return power @ onehot

    a, b = energies(served), energies(ref)
    floor = max(b.max(), 1e-30) * 10.0 ** (-floor_db / 10.0)
    d = 10.0 * np.log10((a + floor) / (b + floor))
    return np.sqrt(np.mean(d * d, axis=-1))


def compare(pairs: List[Tuple[np.ndarray, np.ndarray]], sample_rate: int,
            hop: int) -> Dict[str, float]:
    """The readings of (served, reference) pairs over all the sampled
    audio."""
    if not pairs:
        return {"wav_gap": math.inf, "band_gap_db": math.inf,
                "length_gap": math.inf}
    if any(s.shape != r.shape for s, r in pairs):
        wav = math.inf
    else:
        wav = wav_gap(np.concatenate([s for s, _ in pairs]),
                      np.concatenate([r for _, r in pairs]))
    band = np.concatenate([band_gap_frames(s, r, sample_rate, hop)
                           for s, r in pairs])
    return {"wav_gap": wav, "band_gap_db": float(np.mean(band)),
            "length_gap": max(abs(len(s) - len(r)) for s, r in pairs)}


def per_request(pairs: List[Tuple[np.ndarray, np.ndarray]], sample_rate: int,
                hop: int) -> List[List[float]]:
    """[wav_gap, band_gap_db] of each pair."""
    return [[wav_gap(s, r), float(np.mean(band_gap_frames(
        s, r, sample_rate, hop)))] for s, r in pairs]


def frame_hop(cfg: Dict) -> int:
    """Samples a mel frame: the vocoder's upsampling."""
    hop = cfg["hift"]["istft_hop_len"]
    for r in cfg["hift"]["upsample_rates"]:
        hop *= r
    return hop


def verdict(readings: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every compared number within its limit, {name: {value, limit}})."""
    out = {name: {"value": readings[name], "limit": lim}
           for name, lim in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
