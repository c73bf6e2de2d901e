"""RTF measurement, after the JAX package's ``eval/rtf.py`` (cal_RTF.py:
349-421): warm up on the first items, then RTF = sum(processing time) /
sum(audio duration), each item's time read on the host clock after the
card is synchronized; the streaming decode also reports the first chunk's
latency."""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device) -> float:
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def measure_encode_rtf(codec, wavs_16k: Sequence[np.ndarray],
                       warmup: int = 2, streaming: bool = False) -> dict:
    """The tokenizer side's RTF over 16 kHz waveforms."""
    fn = codec.encode_streaming if streaming else codec.encode
    for w in wavs_16k[:warmup]:
        fn(w)
    proc = audio = 0.0
    for w in wavs_16k:
        proc += _timed(lambda: fn(w), codec.device)
        audio += len(np.asarray(w).reshape(-1)) / 16000.0
    return {"rtf": proc / audio, "proc_s": proc, "audio_s": audio,
            "streaming": streaming}


def measure_tokenizer_rtf(encode_fn: Callable[[np.ndarray], object],
                          wavs: Sequence[np.ndarray], sample_rate: int,
                          warmup: int = 2, name: str = "",
                          device=None) -> dict:
    """Any ``wav -> tokens`` callable under the same protocol (the
    cal_RTF.py:427-516 tokenizer comparison); ``device`` the card it runs
    on, synchronized around each item."""
    for w in wavs[:warmup]:
        encode_fn(w)
    proc = audio = 0.0
    for w in wavs:
        proc += _timed(lambda: encode_fn(w), device)
        audio += len(np.asarray(w).reshape(-1)) / sample_rate
    return {"rtf": proc / audio, "proc_s": proc, "audio_s": audio,
            "tokenizer": name}


def measure_decode_rtf(decoder, token_lists: Sequence[np.ndarray],
                       warmup: int = 1, streaming: bool = True,
                       sample_rate: int = 24000,
                       block_size: Optional[int] = None) -> dict:
    """The decoder side's RTF and first-chunk latency over (1, T) token
    arrays, through ``stream_inference`` or ``token2wav``."""
    run = ((lambda t: decoder.stream_inference(t, block_size=block_size))
           if streaming else decoder.token2wav)
    dev = decoder.device
    for t in token_lists[:warmup]:
        run(np.asarray(t))
    first_chunk_ms = None
    if streaming:
        sess = decoder.new_session(block_size=block_size)
        need = (block_size or decoder.pipe_cfg.block_size) + decoder.lookahead
        first_chunk_ms = 1e3 * _timed(lambda: next(iter(sess.push(
            np.asarray(token_lists[0]).reshape(-1)[:need]))), dev)
    proc = audio = 0.0
    for t in token_lists:
        out = []
        proc += _timed(lambda: out.append(run(np.asarray(t))), dev)
        audio += out[0].shape[-1] / sample_rate
    res = {"rtf": proc / audio, "proc_s": proc, "audio_s": audio,
           "streaming": streaming}
    if first_chunk_ms is not None:
        res["first_chunk_ms"] = first_chunk_ms
    return res
