"""Why the bulk vocoder runs its hop windows in batches of one shape, on one
CUDA card.

    python -m moss_speech_decoder_cosy_torch.bin.window_batch [--out x.json]

At full width in bf16 (the MOSS presets, seeded weights, ``bench.py``'s KV
protocol: 250 tokens, block 5, ring 35, graphed):

- HiFT over the stream's 48 steady hop windows at once against the same
  windows in two calls of 22 and 26 (as a segmented decode cuts them): the
  largest difference of the audio, beside its peak;
- the KV session's int16 stream, segmented (``seg_iters=32``) against
  unsegmented, with the windows in batches of ``bulk_voc.WINDOW_BATCH``
  (the port) and with all of a segment's windows in one batch (the bulk
  vocoder before batches of one shape): samples that differ, the largest
  difference in 16-bit steps;
- the wall of ``stream_decode(output="int16")`` both ways, in turns
  (batched, one batch, one batch, batched), each 1 warm-up + median of 3.

Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from ..pipeline import AudioDecoder
from ..pipeline import bulk_voc
from ..utils import config as C
from ..utils.device import card_line
from ..weights import seeded_states


def _one_batch(fn, *xs):
    return fn(*xs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("window_batch needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flow_cfg = C.moss_flow_config()
    flow_cfg = dataclasses.replace(flow_cfg, cfm=dataclasses.replace(
        flow_cfg.cfm, max_noise_len=4096))
    hift_cfg = C.moss_hift_config()
    dec = AudioDecoder(flow_cfg, hift_cfg, *seeded_states(flow_cfg, hift_cfg),
                       C.PipelineConfig(block_size=5, mel_cache_len=8,
                                        max_token_len=40),
                       compute_dtype=torch.bfloat16)
    kv = dec.kv_stream_decoder(token_cap=266)
    tokens = np.random.RandomState(0).randint(0, flow_cfg.vocab_size,
                                              (1, 250))
    out = dict(card=card_line(), window_batch=bulk_voc.WINDOW_BATCH)

    wins = torch.randn((48, kv.cf + kv.mel_cache_len, kv.n_mel),
                       generator=torch.Generator().manual_seed(0)).to(
        "cuda", torch.bfloat16)
    hift = dec.hift
    with torch.inference_mode():
        s = hift.source(wins)
        whole = hift.decode(wins, s).float()
        parts = torch.cat([hift.decode(wins[:22], s[:22]),
                           hift.decode(wins[22:], s[22:])]).float()
    out["hift_48_vs_22_26"] = dict(
        max_abs_diff=float((whole - parts).abs().max()),
        peak=float(whole.abs().max()))

    batched = bulk_voc._in_batches

    def decode(segmented):
        return kv.stream_decode(tokens, output="int16", segmented=segmented)

    for name, fn in (("batches", batched), ("one_batch", _one_batch)):
        bulk_voc._in_batches = fn
        diff = np.abs(decode(True).astype(np.int32) - decode(False))
        out[f"segmented_vs_unsegmented_{name}"] = dict(
            differing_samples=int((diff > 0).sum()),
            max_lsb_diff=int(diff.max()))
    walls = {"batches": [], "one_batch": []}
    for name in ("batches", "one_batch", "one_batch", "batches"):
        bulk_voc._in_batches = batched if name == "batches" else _one_batch
        decode(False)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(False)
            walls[name].append(time.perf_counter() - t0)
    bulk_voc._in_batches = batched
    out["stream_decode_int16_wall_s"] = {
        k: dict(walls=v, median=statistics.median(v)) for k, v in
        walls.items()}
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
