"""The data processors of the port, after the JAX package's
``data/processor.py`` (the reference's Processor chain,
cosyvoice/dataset/processor.py:1-437):

parquet_opener -> filter -> resample -> truncate -> compute_fbank ->
compute_f0 -> parse_embedding -> tokenize -> shuffle -> sort -> batch ->
padding

Host numpy throughout, but ``compute_fbank``: the matcha mel of
``ops/melspec.py`` on a torch device (the CUDA card unless the caller
passes ``device="cpu"``).  ``padding`` emits a dict of padded arrays and
valid masks, lengths rounded up to a multiple so few shapes reach the
train step.  ``pyarrow`` and ``scipy`` are imported where they are used.
"""

from __future__ import annotations

import random
from typing import Callable, Iterable, Iterator, List

import numpy as np


def parquet_opener(data: Iterable[dict]) -> Iterator[dict]:
    """{'src': path} -> one dict per row (processor.py:33-55)."""
    import pyarrow.parquet as pq
    for sample in data:
        table = pq.read_table(sample["src"]).to_pylist()
        for row in table:
            row.update({k: v for k, v in sample.items() if k != "src"})
            yield row


def jsonl_opener(data: Iterable[dict]) -> Iterator[dict]:
    """{'src': path.jsonl} -> one dict per line (the cosyvoice1
    cosy_jsonl_opener family, cosyvoice1/dataset/processor.py:100+);
    rows may reference wav paths loaded lazily downstream."""
    import json
    for sample in data:
        with open(sample["src"]) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                row.update({k: v for k, v in sample.items() if k != "src"})
                yield row


def cosy_jsonl_opener(data: Iterable[dict], jsonl_suffix: str = ".jsonl",
                      tar_suffix: str = ".tar",
                      token_key: str = "cosy_token") -> Iterator[dict]:
    """jsonl shards of pre-tokenized rows + an mmap tar of their wavs.

    One parameterized opener replaces the reference's five copy-paste
    variants (cosy_jsonl_opener / _vq0918_nopool / _pool2 / _pool4 /
    _pool8, cosyvoice1/dataset/processor.py:158-311): each jsonl line has
    ``{token_key: [...], 'filename': member}``; the wav bytes come from
    ``src.replace(jsonl_suffix, tar_suffix)`` via data/tar.py.  Rows that
    fail to decode are skipped with a warning, like the reference."""
    import json
    import logging
    from .tar import IndexedTar
    for sample in data:
        src = sample["src"]
        tar_path = src[: -len(jsonl_suffix)] + tar_suffix \
            if src.endswith(jsonl_suffix) else src + tar_suffix
        try:
            tar = IndexedTar(tar_path)
        except Exception as ex:           # noqa: BLE001 — skip bad shards
            logging.warning("Failed to open %s: %s", tar_path, ex)
            continue
        try:
            with open(src) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:                  # per-ROW skip, not per-shard
                        item = json.loads(line)
                        wav, sr = tar.read_wav(item["filename"])
                    except Exception as ex:     # noqa: BLE001
                        logging.warning("Bad row in %s: %s", src, ex)
                        continue
                    row = {k: v for k, v in sample.items() if k != "src"}
                    row.update(item)
                    row["speech_token"] = np.asarray(item[token_key],
                                                     np.int32)
                    row["speech"] = wav
                    row["sample_rate"] = sr
                    yield row
        except Exception as ex:           # noqa: BLE001
            logging.warning("Failed to read %s: %s", src, ex)
        finally:
            tar.close()


def sft_npy_opener(data: Iterable[dict], npy_suffix: str = ".npy",
                   token_rate: float = 12.5,
                   split_token: int = 0) -> Iterator[dict]:
    """SFT shards: ``<wav>.vqXXXX.npy`` token files next to their wavs
    (cosyvoice1/dataset/processor.py:312-433 process_sft_* family).

    ``split_token > 0`` expands each utterance into growing-prefix samples
    every ``split_token`` tokens with the wav cut at the matching
    ``ceil(end/token_rate*sr)`` sample — the streaming-TTS curriculum of
    process_sft_vq0918_pool4_split (:332-371)."""
    import logging
    from ..eval.audio_io import read_wav
    for sample in data:
        src = sample["src"]
        wav_path = src[: -len(npy_suffix)] if src.endswith(npy_suffix) \
            else src
        if not wav_path.endswith(".wav") and "." in wav_path:
            # '<utt>.wav.vq0918.npy' with the default '.npy' suffix:
            # strip the vq tag down to the wav path
            head, tail = wav_path.rsplit(".", 1)
            if head.endswith(".wav") and not tail.startswith("wav"):
                wav_path = head
        try:
            token = np.load(src).reshape(-1).astype(np.int32)
            wav, sr = read_wav(wav_path)
            base = {k: v for k, v in sample.items() if k != "src"}
            base["sample_rate"] = sr
            if split_token <= 0:
                yield {**base, "speech_token": token, "speech": wav}
                continue
            n_splits = (len(token) + split_token - 1) // split_token
            for i in range(n_splits):
                end_tok = min((i + 1) * split_token, len(token))
                end_sample = int(np.ceil(end_tok / token_rate * sr))
                yield {**base, "speech_token": token[:end_tok],
                       "speech": wav[:end_sample]}
        except Exception as ex:           # noqa: BLE001
            logging.warning("Failed to open %s: %s", src, ex)


def wav_loader(data, sample_rate_key: str = "sample_rate"):
    """Loads rows' 'wav' paths into float32 'speech' (jsonl datasets)."""
    from ..eval.audio_io import read_wav
    for s in data:
        if "speech" not in s and "wav" in s:
            wav, sr = read_wav(s["wav"])
            s["speech"] = wav
            s[sample_rate_key] = sr
        yield s


def filter_samples(data, max_length: float = 40960, min_length: float = 0.1,
                   token_max_length: int = 200, token_min_length: int = 1,
                   sample_rate_key: str = "sample_rate"):
    """Drop out-of-range utterances (processor.py:57-98); lengths in
    10ms frames like the reference."""
    for s in data:
        sr = s.get(sample_rate_key, 16000)
        num_frames = len(s["speech"]) / sr * 100
        if not (min_length < num_frames < max_length):
            continue
        if "speech_token" in s and not (
                token_min_length <= len(s["speech_token"])
                <= token_max_length):
            continue
        yield s


def resample(data, resample_rate: int = 24000,
             min_sample_rate: int = 16000):
    """Polyphase resampling through scipy (the reference's cached
    torchaudio Resample, processor.py:101-121)."""
    from scipy.signal import resample_poly
    from math import gcd
    for s in data:
        sr = s.get("sample_rate", 16000)
        if sr != resample_rate:
            if sr < min_sample_rate:
                continue
            g = gcd(sr, resample_rate)
            s["speech"] = resample_poly(np.asarray(s["speech"], np.float32),
                                        resample_rate // g, sr // g)
            s["sample_rate"] = resample_rate
        m = np.max(np.abs(s["speech"])) if len(s["speech"]) else 0.0
        if m > 1.0:
            s["speech"] = np.asarray(s["speech"]) / m
        yield s


def truncate(data, truncate_length: int = 24576):
    """Random crop / zero-pad to a fixed length (processor.py:124-142)."""
    for s in data:
        wav = np.asarray(s["speech"], np.float32)
        if len(wav) > truncate_length:
            start = random.randint(0, len(wav) - truncate_length)
            wav = wav[start: start + truncate_length]
        else:
            wav = np.pad(wav, (0, truncate_length - len(wav)))
        s["speech"] = wav
        yield s


def compute_fbank(data, n_fft: int = 1920, num_mels: int = 80,
                  sampling_rate: int = 24000, hop_size: int = 480,
                  win_size: int = 1920, device=None):
    """speech -> speech_feat (T, num_mels) f32 through the matcha mel
    (processor.py:145-160; the feat_extractor of the checkpoint's yaml),
    computed on ``device`` (the CUDA card by default)."""
    import torch
    from ..ops.melspec import matcha_mel_spectrogram
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    for s in data:
        wav = torch.from_numpy(np.asarray(s["speech"], np.float32).reshape(
            1, -1)).to(dev)
        with torch.inference_mode():
            mel = matcha_mel_spectrogram(wav, n_fft, num_mels, sampling_rate,
                                         hop_size, win_size)
        s["speech_feat"] = mel[0].cpu().numpy()
        yield s


def compute_f0(data, sample_rate: int = 24000, hop_size: int = 480,
               f0_min: float = 60.0, f0_max: float = 500.0):
    """Frame-wise f0 for GAN training.

    The reference uses pyworld harvest/dio + stonemask
    (processor.py:188-210, a C++ host lib); here an autocorrelation pitch
    tracker with parabolic interpolation, the same contract: f0 per mel
    frame, 0 where unvoiced, interpolated to speech_feat's length."""
    for s in data:
        wav = np.asarray(s["speech"], np.float32)
        frame = int(sample_rate * 0.04)                  # 40 ms windows
        lo = int(sample_rate / f0_max)
        hi = int(sample_rate / f0_min)
        n_frames = max(1, len(wav) // hop_size)
        f0 = np.zeros(n_frames, np.float32)
        for i in range(n_frames):
            c = i * hop_size
            seg = wav[max(0, c - frame // 2): c + frame // 2]
            if len(seg) < hi + 2 or np.std(seg) < 1e-5:
                continue
            seg = seg - seg.mean()
            ac = np.correlate(seg, seg, mode="full")[len(seg) - 1:]
            if ac[0] <= 0:
                continue
            ac = ac / ac[0]
            window = ac[lo:hi]
            if len(window) == 0:
                continue
            peak = int(np.argmax(window)) + lo
            if ac[peak] < 0.3:                           # unvoiced
                continue
            # octave-error guard (pyworld stonemask's role): the
            # autocorrelation also peaks at period multiples; if half the
            # lag scores nearly as high, the true pitch is an octave up
            half = peak // 2
            if half >= lo and ac[half] > 0.9 * ac[peak]:
                peak = half
            # parabolic interpolation around the peak
            if 1 <= peak < len(ac) - 1:
                a, b, c2 = ac[peak - 1], ac[peak], ac[peak + 1]
                denom = a - 2 * b + c2
                shift = 0.5 * (a - c2) / denom if abs(denom) > 1e-9 else 0.0
            else:
                shift = 0.0
            f0[i] = sample_rate / (peak + shift)
        f0 = _median3_voiced(f0)
        t = len(s.get("speech_feat", f0))
        if t != n_frames:
            idx = np.linspace(0, n_frames - 1, t)
            f0 = np.interp(idx, np.arange(n_frames), f0).astype(np.float32)
        s["pitch_feat"] = f0
        yield s


def _median3_voiced(f0: np.ndarray) -> np.ndarray:
    """3-tap median over voiced runs — removes isolated octave jumps (the
    trajectory-smoothing role of pyworld harvest's candidate selection)
    without smearing voiced/unvoiced boundaries."""
    out = f0.copy()
    for i in range(1, len(f0) - 1):
        a, b, c = f0[i - 1], f0[i], f0[i + 1]
        if a > 0 and b > 0 and c > 0:
            out[i] = np.median([a, b, c])
    return out


def parse_embedding(data, normalize: bool = True):
    for s in data:
        for k in ("utt_embedding", "spk_embedding"):
            if k in s:
                e = np.asarray(s[k], np.float32)
                if normalize:
                    e = e / max(np.linalg.norm(e), 1e-12)
                s[k] = e
        yield s


def tokenize(data, tokenize_fn: Callable[[np.ndarray], np.ndarray]):
    """speech (its 16 kHz view, else itself) -> speech_token through
    ``tokenize_fn`` (the reference runs an onnx tokenizer here; the port's
    is ``SpeechCodec.encode``)."""
    for s in data:
        if "speech_token" not in s:
            wav16 = s.get("speech_16k", s["speech"])
            s["speech_token"] = np.asarray(
                tokenize_fn(np.asarray(wav16, np.float32))).reshape(-1)
        yield s


def shuffle(data, shuffle_size: int = 10000):
    buf: List[dict] = []
    for s in data:
        buf.append(s)
        if len(buf) >= shuffle_size:
            random.shuffle(buf)
            yield from buf
            buf = []
    random.shuffle(buf)
    yield from buf


def sort(data, sort_size: int = 500):
    buf: List[dict] = []
    for s in data:
        buf.append(s)
        if len(buf) >= sort_size:
            buf.sort(key=lambda x: x["speech_feat"].shape[0])
            yield from buf
            buf = []
    buf.sort(key=lambda x: x["speech_feat"].shape[0])
    yield from buf


def static_batch(data, batch_size: int = 16):
    buf: List[dict] = []
    for s in data:
        buf.append(s)
        if len(buf) >= batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def dynamic_batch(data, max_frames_in_batch: int = 12000):
    """Batches until the padded frames would exceed the budget
    (processor.py:320-346)."""
    buf: List[dict] = []
    longest = 0
    for s in data:
        n = s["speech_feat"].shape[0]
        if (max(longest, n)) * (len(buf) + 1) > max_frames_in_batch and buf:
            yield buf
            buf, longest = [s], n
        else:
            buf.append(s)
            longest = max(longest, n)
    if buf:
        yield buf


def _pad_stack(arrays: List[np.ndarray], length: int,
               dtype=None) -> np.ndarray:
    out = np.zeros((len(arrays), length) + arrays[0].shape[1:],
                   dtype or arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padding(data, gan: bool = False, use_spk_embedding: bool = False,
            pad_to_multiple: int = 32, token_mel_ratio: int = 4):
    """List[sample] -> padded numpy batch with valid masks
    (processor.py:360-437), lengths rounded up so few shapes occur.

    Emits: speech_token (B,Tt) i32, token_valid, speech_feat (B,Tm,80) f32,
    feat_valid, embedding (B,E); + speech/pitch_feat for GAN."""
    for samples in data:
        samples = sorted(samples, key=lambda x: -x["speech_feat"].shape[0])
        tok = [np.asarray(s["speech_token"], np.int64) for s in samples]
        feat = [np.asarray(s["speech_feat"], np.float32) for s in samples]
        tt = _round_up(max(t.shape[0] for t in tok), max(
            1, pad_to_multiple // token_mel_ratio))
        tm = max(tt * token_mel_ratio,
                 _round_up(max(f.shape[0] for f in feat), pad_to_multiple))
        tt = tm // token_mel_ratio
        batch = {
            "utts": [s.get("utt") for s in samples],
            "speech_token": _pad_stack(tok, tt, np.int64).astype(np.int32),
            "token_valid": np.arange(tt)[None, :] < np.asarray(
                [t.shape[0] for t in tok])[:, None],
            "speech_feat": _pad_stack(feat, tm, np.float32),
            "feat_valid": np.arange(tm)[None, :] < np.asarray(
                [f.shape[0] for f in feat])[:, None],
        }
        key = "spk_embedding" if use_spk_embedding else "utt_embedding"
        if key in samples[0]:
            batch["embedding"] = np.stack(
                [np.asarray(s[key], np.float32) for s in samples])
        if gan:
            speech = [np.asarray(s["speech"], np.float32) for s in samples]
            batch["speech"] = _pad_stack(speech,
                                         max(len(x) for x in speech))
            pitch = [np.asarray(s["pitch_feat"], np.float32)
                     for s in samples]
            batch["pitch_feat"] = _pad_stack(pitch, tm)
        yield batch
