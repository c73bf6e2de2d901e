"""Scoring a Seed-TTS run in the port: WER and speaker similarity, after
the JAX package's ``eval/score.py``.

The reference hands its synthesized wavs to the external seed-tts-eval
scorer and prints ``result.json`` (scripts/evaluate_moss_decoder.sh:76-94).
The port owns both scoring models, the Whisper ASR over speech tokens
(``tokenizer/asr_decoder.py``) and CAM++ (``models/campplus.py``), so the
scores compute in process:

- WER: corpus unit error rate of the transcribed ``pred.wav`` against a
  reference unit sequence: ``text_to_units(label_text)`` when a text
  tokenizer is given, else the transcription of ``label.wav`` through the
  same ASR (tokenizer-free: a perfect synthesis still scores 0);
- SIM: cosine similarity of the speaker embeddings of ``pred.wav`` and the
  prompt utterance.

Corpus WER = sum of edits / sum of reference lengths; SIM = mean cosine.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

from .audio_io import read_wav, resample


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance over any hashable units."""
    ref, hyp = list(ref), list(hyp)
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    prev = np.arange(len(hyp) + 1)
    for i, r in enumerate(ref, 1):
        cur = np.empty(len(hyp) + 1, dtype=np.int64)
        cur[0] = i
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (r != h))
        prev = cur
    return int(prev[-1])


def word_error_rate(ref: Sequence, hyp: Sequence) -> float:
    """edits / len(ref); 1.0 for an empty reference and a non-empty
    hypothesis, 0.0 for both empty."""
    if not len(ref):
        return 0.0 if not len(hyp) else 1.0
    return edit_distance(ref, hyp) / len(ref)


def speaker_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Cosine similarity of two speaker embeddings (0 for a zero one)."""
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def make_asr_transcriber(codec, asr) -> Callable[[np.ndarray], tuple]:
    """wav at 16 kHz -> tuple of transcript ids: ``SpeechCodec.encode``,
    then ``WhisperASR.transcribe`` over the tokens, segments stitched."""

    def transcribe(wav_16k: np.ndarray) -> tuple:
        tokens = codec.encode(np.asarray(wav_16k, np.float32).reshape(-1))
        segs = asr.transcribe(tokens)
        if not segs:
            return ()
        return tuple(int(t) for t in np.concatenate(
            [np.asarray(s).reshape(-1) for s in segs]))

    return transcribe


def _prompt_wav_for(sample_dir: Path, benchmark_dir: Optional[str],
                    lang: str, sample_rate: int) -> Optional[np.ndarray]:
    """The prompt utterance at the run's rate: from the benchmark layout
    when there is one, else the head of ``prompt_concat_pred.wav`` (the
    benchmark writes concat(prompt, pred))."""
    if benchmark_dir is not None:
        p = Path(benchmark_dir) / lang / sample_dir.name / "prompt.wav"
        if p.exists():
            wav, sr = read_wav(str(p))
            return resample(wav, sr, sample_rate)
    concat = sample_dir / "prompt_concat_pred.wav"
    pred = sample_dir / "pred.wav"
    if concat.exists() and pred.exists():
        cw, _ = read_wav(str(concat))
        pw, _ = read_wav(str(pred))
        n = len(cw.reshape(-1)) - len(pw.reshape(-1))
        if n > 0:
            return cw.reshape(-1)[:n]
    return None


def _reference_units(sample_dir: Path, lang: str, transcribe_fn,
                     benchmark_dir, text_to_units):
    if text_to_units is not None:
        meta = sample_dir / "metadata.json"
        if meta.exists():
            label_text = json.loads(meta.read_text()).get("label_text", "")
            return list(text_to_units(label_text))
    elif benchmark_dir is not None:
        lp = Path(benchmark_dir) / lang / sample_dir.name / "label.wav"
        if lp.exists():
            lw, lsr = read_wav(str(lp))
            return list(transcribe_fn(resample(lw.reshape(-1), lsr, 16000)))
    return None


def score_seed_tts_run(save_dir: str, lang: str,
                       transcribe_fn: Optional[Callable] = None,
                       speaker_fn: Optional[Callable] = None,
                       benchmark_dir: Optional[str] = None,
                       text_to_units: Optional[Callable] = None,
                       sample_rate: int = 24000) -> dict:
    """Scores one language of a finished Seed-TTS run.

    ``transcribe_fn(wav_16k) -> units`` (``make_asr_transcriber``),
    ``speaker_fn(wav_16k) -> embedding``; either None skips its metric.
    The WER reference of a sample is ``text_to_units(label_text)`` when
    given, else the transcription of ``label.wav`` (needs
    ``benchmark_dir``).  Returns ``{"lang", "wer", "sim", "n",
    "per_sample"}``; a metric that could not be computed is None."""
    root = Path(save_dir) / lang
    per_sample = {}
    tot_edits = tot_ref = 0
    sims = []
    n = 0
    dirs = sorted(p for p in root.iterdir() if p.is_dir()) \
        if root.exists() else []
    for sample_dir in dirs:
        pred_path = sample_dir / "pred.wav"
        if not pred_path.exists():
            continue
        n += 1
        entry = {}
        pred_wav, sr = read_wav(str(pred_path))
        pred_16k = resample(pred_wav.reshape(-1), sr, 16000)
        if transcribe_fn is not None:
            ref_units = _reference_units(sample_dir, lang, transcribe_fn,
                                         benchmark_dir, text_to_units)
            if ref_units is not None:
                hyp = list(transcribe_fn(pred_16k))
                edits = edit_distance(ref_units, hyp)
                tot_edits += edits
                tot_ref += len(ref_units)
                entry["wer"] = word_error_rate(ref_units, hyp)
        if speaker_fn is not None:
            prompt = _prompt_wav_for(sample_dir, benchmark_dir, lang,
                                     sample_rate)
            if prompt is not None:
                prompt_16k = resample(np.asarray(prompt).reshape(-1),
                                      sample_rate, 16000)
                sim = speaker_similarity(speaker_fn(pred_16k),
                                         speaker_fn(prompt_16k))
                sims.append(sim)
                entry["sim"] = sim
        per_sample[sample_dir.name] = entry
    return {"lang": lang,
            "wer": (tot_edits / tot_ref) if tot_ref else None,
            "sim": float(np.mean(sims)) if sims else None,
            "n": n, "per_sample": per_sample}


def write_result_json(save_dir: str, lang_results: dict) -> str:
    """Merges per-language scores into ``<save_dir>/result.json``, the file
    the reference prints at the end of its eval (evaluate_moss_decoder.sh:
    85-94)."""
    path = Path(save_dir) / "result.json"
    existing = {}
    if path.exists():
        try:
            existing = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            existing = {}
    for lang, res in lang_results.items():
        existing[lang] = {"wer": res.get("wer"), "sim": res.get("sim"),
                          "n": res.get("n")}
    path.write_text(json.dumps(existing, indent=2))
    return str(path)
