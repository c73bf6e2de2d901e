"""Scores a synthesized Seed-TTS run directory in the port (the JAX
package's ``bin/score.py``; the reference's external
``seed-tts-eval/benchmark.sh ${OUTPUT_DIR}`` step,
scripts/evaluate_moss_decoder.sh:76-94):

- WER through the port's Whisper ASR over the codec's tokens (the label's
  transcription is the reference when no text tokenizer is given);
- speaker SIM through CAM++.

    python -m moss_speech_decoder_cosy_torch.bin.score --save_dir out \
        --benchmark_dir seedtts_testset --lang en \
        --tokenizer_ckpt tok.safetensors --campplus_onnx campplus.onnx

Runs on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--save_dir", required=True)
    p.add_argument("--benchmark_dir", default=None,
                   help="the benchmark layout (label and prompt wavs); "
                        "without it SIM reads the prompt from the head of "
                        "prompt_concat_pred.wav and WER is skipped")
    p.add_argument("--lang", default="en", choices=["en", "zh"])
    p.add_argument("--tokenizer_ckpt", default=None,
                   help="tokenizer + decoder weights for the ASR (WER)")
    p.add_argument("--campplus_onnx", default=None,
                   help="CAM++ onnx for the speaker SIM")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from ..eval.score import (make_asr_transcriber, score_seed_tts_run,
                              write_result_json)

    transcribe_fn = speaker_fn = None
    if args.tokenizer_ckpt:
        from .benchmark import build_asr
        from .inference import build_codec
        codec = build_codec(argparse.Namespace(
            model_dir=None, flow_ckpt=None, hift_ckpt=None,
            tokenizer_ckpt=args.tokenizer_ckpt, flow_version=None,
            block_size=5, max_token_len=40, bf16=False, device=args.device))
        asr = build_asr(args.tokenizer_ckpt, codec)
        if asr is not None:
            transcribe_fn = make_asr_transcriber(codec, asr)
    if args.campplus_onnx:
        from ..models.campplus import SpeakerEncoder
        speaker_fn = SpeakerEncoder.from_onnx(args.campplus_onnx,
                                              device=args.device)
    res = score_seed_tts_run(
        args.save_dir, args.lang, transcribe_fn=transcribe_fn,
        speaker_fn=speaker_fn, benchmark_dir=args.benchmark_dir)
    path = write_result_json(args.save_dir, {args.lang: res})
    print(json.dumps({args.lang: {"wer": res["wer"], "sim": res["sim"],
                                  "n": res["n"]}}))
    print(f"result.json: {path}")
    return res


if __name__ == "__main__":
    main()
