"""The Seed-TTS benchmark runner (benchmark_moss_decoder.py), after the
JAX package's ``eval/benchmark.py``, over the port's ``SpeechCodec``.

Per sample: encode the label wav to tokens, decode them streaming behind
the prompt utterance, and write ``pred.wav``, ``prompt_concat_pred.wav``
and ``metadata.json`` into ``save_dir/<lang>/<sample>/``, the layout the
seed-tts-eval scorer reads (scripts/evaluate_moss_decoder.sh:40-94).
Shards by rank as the reference does (benchmark_moss_decoder.py:175-189);
resumes by ``pred.wav``'s existence; a sample that raises is counted as
failed, with its traceback printed, and the shard goes on (the harness's
contract: the caller reads ``failed``)."""

from __future__ import annotations

import json
import time
import traceback
from pathlib import Path
from typing import List, Tuple

import numpy as np

from .audio_io import read_wav, resample, write_wav


def load_benchmark_data(benchmark_dir: str, lang: str
                        ) -> List[Tuple[str, str, str, str, str]]:
    """The Seed-TTS layout: ``<dir>/<lang>/<sample>/{prompt.wav, label.wav,
    prompt.txt, label.txt}`` (benchmark_moss_decoder.py:30-71) -> [(name,
    prompt wav, label wav, prompt text, label text)]."""
    root = Path(benchmark_dir) / lang
    data = []
    if not root.exists():
        return data
    for sample_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        prompt_wav = sample_dir / "prompt.wav"
        label_wav = sample_dir / "label.wav"
        if not (prompt_wav.exists() and label_wav.exists()):
            continue
        texts = []
        for name in ("prompt.txt", "label.txt"):
            p = sample_dir / name
            texts.append((p.read_text().strip().splitlines() or [""])[0]
                         if p.exists() else "")
        data.append((sample_dir.name, str(prompt_wav), str(label_wav),
                     *texts))
    return data


def run_seed_tts_benchmark(codec, benchmark_dir: str, save_dir: str,
                           lang: str = "en", block_size: int = 5,
                           max_token_len: int = 40, rank: int = 0,
                           world_size: int = 1, sample_rate: int = 24000,
                           score: bool = False, asr=None,
                           text_to_units=None) -> dict:
    """``codec`` a ``codec.SpeechCodec``.  Returns ``{"ok", "failed",
    "skipped", "total"}``.  ``score=True`` then scores the run in process
    (``eval/score.py``: WER through ``asr``, a ``WhisperASR`` over the
    codec's tokens, SIM through ``codec.speaker_encoder``), writes
    ``<save_dir>/result.json`` and adds ``"scores"`` and
    ``"result_json"``."""
    data = load_benchmark_data(benchmark_dir, lang)[rank::world_size]
    out_root = Path(save_dir) / lang
    out_root.mkdir(parents=True, exist_ok=True)
    ok = failed = skipped = 0
    for name, prompt_path, label_path, ptext, ltext in data:
        sample_dir = out_root / name
        sample_dir.mkdir(exist_ok=True)
        pred = sample_dir / "pred.wav"
        if pred.exists():                              # resume by existence
            skipped += 1
            continue
        try:
            t0 = time.perf_counter()
            label_wav, sr = read_wav(label_path)
            tokens = codec.encode(resample(label_wav, sr, 16000))
            prompt_wav, psr = read_wav(prompt_path)
            prompt_24k = resample(prompt_wav, psr, sample_rate)
            prompt = codec.prepare_prompt(prompt_24k,
                                          resample(prompt_wav, psr, 16000))
            wav = codec.decode_streaming(tokens, prompt,
                                         block_size=block_size,
                                         max_token_len=max_token_len)[0]
            write_wav(str(pred), wav, sample_rate)
            write_wav(str(sample_dir / "prompt_concat_pred.wav"),
                      np.concatenate([prompt_24k, wav]), sample_rate)
            meta = {"sample_name": name, "prompt_text": ptext,
                    "label_text": ltext, "num_tokens": int(tokens.shape[1]),
                    "wall_s": time.perf_counter() - t0,
                    "audio_s": len(wav) / sample_rate}
            (sample_dir / "metadata.json").write_text(
                json.dumps(meta, indent=2))
            ok += 1
        except Exception:                              # keep the shard alive
            traceback.print_exc()
            failed += 1
    out = {"ok": ok, "failed": failed, "skipped": skipped,
           "total": len(data)}
    if score:
        from .score import (make_asr_transcriber, score_seed_tts_run,
                            write_result_json)
        res = score_seed_tts_run(
            save_dir, lang,
            transcribe_fn=(make_asr_transcriber(codec, asr)
                           if asr is not None else None),
            speaker_fn=codec.speaker_encoder, benchmark_dir=benchmark_dir,
            text_to_units=text_to_units, sample_rate=sample_rate)
        out["scores"] = res
        out["result_json"] = write_result_json(save_dir, {lang: res})
    return out
