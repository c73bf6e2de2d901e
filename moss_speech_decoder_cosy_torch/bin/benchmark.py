"""The Seed-TTS benchmark CLI of the port (the JAX package's
``bin/benchmark.py``; scripts/evaluate_moss_decoder.sh and
benchmark_moss_decoder.py):

    RANK=0 WORLD_SIZE=1 python -m moss_speech_decoder_cosy_torch.bin.benchmark \
        --benchmark_dir seedtts_testset --save_dir out --lang en \
        --model_dir DIR [--tokenizer_ckpt tok.safetensors --score \
        --campplus_onnx campplus.onnx]

Shards the samples by the RANK / WORLD_SIZE environment (the reference's
torchrun pattern, benchmark_moss_decoder.py:175-189), resumes by
``pred.wav``'s existence, and prints the counts.  ``--score`` scores the
run in process (WER through the port's Whisper ASR, SIM through CAM++) and
writes ``<save_dir>/result.json``; ``bin.score`` scores a finished run.
Runs on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

from .inference import add_model_args


def build_asr(tokenizer_ckpt: str, codec, **asr_kw):
    """``WhisperASR`` from the tokenizer's checkpoint: the GLM-4-Voice
    tokenizer ships the whole WhisperVQ encoder-decoder
    (whisper_encoder_decoder.py:90-100), so the post-VQ layers and the text
    decoder convert from the same file (the ``post_vq`` and
    ``whisper_decoder`` plans), over the codec's codebook (``asr_kw`` go
    to ``WhisperASR``).  None, with a warning, when the file holds no
    decoder."""
    from ..tokenizer.asr_decoder import WhisperASR
    from ..utils import checkpoint as ckpt

    sd = ckpt.load_torch_state_dict(tokenizer_ckpt)
    enc_sd = ckpt.strip_prefix(sd, "generator.encoder.", "encoder.")
    dec_sd = {}
    for pre in ("generator.decoder.", "generator.whisper_model.decoder.",
                "whisper_model.decoder.", "decoder."):
        dec_sd = {k[len(pre):]: v for k, v in sd.items()
                  if k.startswith(pre)}
        if dec_sd:
            break
    if not dec_sd:
        print("WARNING: the tokenizer checkpoint has no decoder.* weights; "
              "WER is skipped")
        return None
    cfg = codec.tok_cfg
    post_state, _ = ckpt.convert_post_vq_state_dict(enc_sd, cfg)
    dec_state, _ = ckpt.convert_whisper_decoder_state_dict(dec_sd, cfg)
    return WhisperASR(cfg, post_state, dec_state,
                      codec.tokenizer.codebook.detach().float().cpu().numpy(),
                      device=codec.device, **asr_kw)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--benchmark_dir", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--lang", default="en", choices=["en", "zh"])
    p.add_argument("--score", action="store_true",
                   help="score the run in process (WER + SIM) and write "
                        "result.json")
    p.add_argument("--campplus_onnx", default=None,
                   help="CAM++ onnx for the speaker SIM")
    add_model_args(p)
    args = p.parse_args(argv)
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))

    from ..eval import run_seed_tts_benchmark
    from .inference import build_codec

    codec = build_codec(args)
    if args.campplus_onnx:
        from ..models.campplus import SpeakerEncoder
        codec.speaker_encoder = SpeakerEncoder.from_onnx(
            args.campplus_onnx, device=codec.device)
    asr = (build_asr(args.tokenizer_ckpt, codec)
           if args.score and args.tokenizer_ckpt else None)
    stats = run_seed_tts_benchmark(
        codec, args.benchmark_dir, args.save_dir, lang=args.lang,
        block_size=args.block_size, max_token_len=args.max_token_len,
        rank=rank, world_size=world, score=args.score, asr=asr)
    scores = stats.pop("scores", None)
    print(json.dumps({"rank": rank, **stats}))
    if scores is not None:
        print(json.dumps({args.lang: {"wer": scores["wer"],
                                      "sim": scores["sim"],
                                      "n": scores["n"]}}))
        print(f"result.json: {stats.get('result_json')}")
    return stats


if __name__ == "__main__":
    main()
