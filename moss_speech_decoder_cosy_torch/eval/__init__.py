"""Evaluation of the port: host WAV IO, the RTF harness, the Seed-TTS
benchmark runner and its in-process scoring (WER through the Whisper ASR,
SIM through CAM++), after the JAX package's ``eval/``."""
from .audio_io import read_wav, write_wav  # noqa: F401
from .benchmark import load_benchmark_data, run_seed_tts_benchmark  # noqa: F401
from .rtf import (measure_decode_rtf, measure_encode_rtf,  # noqa: F401
                  measure_tokenizer_rtf)
from .score import (edit_distance, make_asr_transcriber,  # noqa: F401
                    score_seed_tts_run, speaker_similarity, word_error_rate,
                    write_result_json)
