"""Inference CLI of the port: tokens or wav -> wav (the JAX package's
``bin/inference.py``; the whisper_encoder_decoder.py __main__ and
cosyvoice/bin/inference.py use cases).

    python -m moss_speech_decoder_cosy_torch.bin.inference --mode decode \
        --model_dir DIR --input tokens.npy --output out.wav [--streaming \
        [--engine kv]] [--bf16]
    python -m moss_speech_decoder_cosy_torch.bin.inference \
        --mode reconstruct --model_dir DIR --input in.wav --output out.wav \
        [--prompt_wav speaker.wav]
    python -m moss_speech_decoder_cosy_torch.bin.inference --mode decode \
        --flow_version v1 [--model_dir DIR] --input tokens.npy \
        --output out.wav [--streaming]

Modes:
  reconstruct  wav -> tokens -> wav (voice conversion with --prompt_wav)
  decode       token .npy / .json -> wav

Weights come from a reference-layout model directory (``--model_dir``,
``model_dir.load_model_dir``) or from ``--flow_ckpt`` / ``--hift_ckpt`` /
``--tokenizer_ckpt`` (reference torch files, at the MOSS and GLM-4-Voice
configs, or with ``--flow_version v1`` the CosyVoice-v1 / stock
GLM-4-Voice 22.05 kHz ones); what neither gives is drawn from a seed, with a
warning.  ``--flow_version v1`` decodes tokens only (``--mode decode``, no
prompt), offline or through the v1 streaming session (``--streaming``), as
the JAX CLI's ``decode_v1``.  Runs on the CUDA card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Tuple

import numpy as np
import torch


def _warn(what: str) -> None:
    print(f"WARNING: seeded random {what} weights (no checkpoint given)")


def build_decoder(args) -> Tuple[object, Optional[object]]:
    """(AudioDecoder or V1Decoder, SpeechCodec or None): from
    ``--model_dir`` (its codec when it holds a tokenizer), else from the
    reference checkpoints given, seeded weights for the rest."""
    from ..model_dir import V1Decoder, load_model_dir
    from ..pipeline import AudioDecoder
    from ..utils import checkpoint as ckpt
    from ..utils.config import (PipelineConfig, cosyvoice1_flow_config,
                                cosyvoice1_hift_config, moss_flow_config,
                                moss_hift_config)
    from ..weights import seeded_states

    v1 = args.flow_version == "v1"
    dt = torch.bfloat16 if args.bf16 else None
    pipe = PipelineConfig(block_size=args.block_size,
                          max_token_len=args.max_token_len)
    if args.model_dir:
        md = load_model_dir(args.model_dir, tokenizer=args.tokenizer_ckpt,
                            pipeline=pipe, compute_dtype=dt,
                            flow_version=args.flow_version,
                            device=args.device)
        return md.decoder, md.codec
    flow_cfg, hift_cfg = ((cosyvoice1_flow_config(), cosyvoice1_hift_config())
                          if v1 else (moss_flow_config(), moss_hift_config()))
    flow_state, hift_state = seeded_states(flow_cfg, hift_cfg, v1=v1)
    if args.flow_ckpt:
        convert = (ckpt.convert_flow_v1_state_dict if v1
                   else ckpt.convert_flow_state_dict)
        flow_state, unused = convert(
            ckpt.load_torch_state_dict(args.flow_ckpt), flow_cfg)
        print(f"flow: {len(unused)} unused reference keys")
    else:
        _warn("flow")
    if args.hift_ckpt:
        hift_state, _ = ckpt.convert_hift_state_dict(
            ckpt.strip_prefix(ckpt.load_torch_state_dict(args.hift_ckpt),
                              "generator."), hift_cfg)
    else:
        _warn("hift")
    if v1:
        return V1Decoder(flow_cfg, hift_cfg, flow_state, hift_state,
                         compute_dtype=dt, device=args.device), None
    dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state, pipe,
                       compute_dtype=dt, device=args.device)
    return dec, None


def build_codec(args):
    """``SpeechCodec``: the model directory's, else one over
    ``build_decoder``'s decoder with the ``--tokenizer_ckpt`` weights (or
    seeded ones) at the GLM-4-Voice config."""
    from ..codec import SpeechCodec
    from ..tokenizer import WhisperVQEncoder, glm4_voice_tokenizer_config
    from ..utils import checkpoint as ckpt
    from ..weights import seeded_state

    dec, codec = build_decoder(args)
    if codec is not None:
        return codec
    tok_cfg = glm4_voice_tokenizer_config()
    if args.tokenizer_ckpt:
        sd = ckpt.strip_prefix(ckpt.load_torch_state_dict(args.tokenizer_ckpt),
                               "generator.encoder.", "encoder.")
        tok_state, _ = ckpt.convert_tokenizer_state_dict(sd, tok_cfg)
    else:
        with torch.device("meta"):
            tok = WhisperVQEncoder(tok_cfg)
        tok_state = seeded_state(tok, 2)
        _warn("tokenizer")
    return SpeechCodec(tok_cfg, tok_state, dec, device=dec.device)


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The model options every CLI of the port shares."""
    p.add_argument("--model_dir", default=None,
                   help="reference-layout model directory (flow.pt, "
                        "hift.pt, [config.yaml, speech_tokenizer/, ...])")
    p.add_argument("--flow_ckpt", default=None)
    p.add_argument("--hift_ckpt", default=None)
    p.add_argument("--tokenizer_ckpt", default=None)
    p.add_argument("--flow_version", choices=["v2", "v1"], default=None,
                   help="v1: the CosyVoice-v1 / stock GLM-4-Voice "
                        "MaskedDiffWithXvec stack at 22.05 kHz (decode "
                        "mode, no prompt); default: what --model_dir's "
                        "config.yaml says, else v2")
    p.add_argument("--block_size", type=int, default=5)
    p.add_argument("--max_token_len", type=int, default=40)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")


def read_tokens(path: str) -> np.ndarray:
    """A token file (.json list or .npy) -> (1, T) int32."""
    if path.endswith(".json"):
        with open(path) as f:
            return np.asarray(json.load(f), np.int32).reshape(1, -1)
    return np.load(path).astype(np.int32).reshape(1, -1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["reconstruct", "decode"],
                   default="reconstruct")
    p.add_argument("--input", required=True,
                   help="wav (reconstruct) or token .npy/.json (decode)")
    p.add_argument("--output", required=True)
    p.add_argument("--prompt_wav", default=None)
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--engine", choices=["windowed", "kv"],
                   default="windowed",
                   help="streaming engine: the reference-semantics windowed "
                        "re-decode, or the compute-once KV wavefront "
                        "(pipeline/kv_session.py; fastest)")
    add_model_args(p)
    args = p.parse_args(argv)

    from ..eval.audio_io import read_wav, resample, write_wav

    if args.flow_version == "v1":
        if args.mode != "decode" or args.prompt_wav:
            p.error("--flow_version v1 decodes tokens only (--mode decode, "
                    "no --prompt_wav)")
        if args.streaming and args.engine == "kv":
            p.error("--flow_version v1 streams through its own session; "
                    "--engine kv is the v2 KV wavefront")

    codec = None
    if args.mode == "reconstruct" or args.prompt_wav:
        codec = build_codec(args)
        dec = codec.decoder
    else:
        dec, _ = build_decoder(args)

    kw = {}
    if args.prompt_wav:
        wav, sr = read_wav(args.prompt_wav)
        prompt = codec.prepare_prompt(resample(wav, sr, 24000),
                                      resample(wav, sr, 16000))
        kw = dict(prompt_token=prompt.token, prompt_feat=prompt.feat,
                  embedding=prompt.embedding)

    if args.mode == "reconstruct":
        wav, sr = read_wav(args.input)
        tokens = codec.encode(resample(wav, sr, 16000))
        print(f"{tokens.shape[1]} tokens")
    else:
        tokens = read_tokens(args.input)

    if args.streaming and args.engine == "kv":
        kv = dec.kv_stream_decoder(
            block_size=args.block_size,
            ring_tokens=args.max_token_len - args.block_size,
            token_cap=tokens.shape[1] + 16, **kw)
        out = kv.stream_decode(tokens)
    elif args.streaming:
        out = dec.stream_inference(tokens, block_size=args.block_size,
                                   max_token_len=args.max_token_len, **kw)
    else:
        out = dec.token2wav(tokens, **kw)
    sr = dec.hift_cfg.sampling_rate
    write_wav(args.output, out[0], sr)
    print(f"wrote {args.output}: {out.shape[-1] / sr:.2f}s")


if __name__ == "__main__":
    main()
