#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Phases (any failure raises and the script exits non-zero):

1. Card: name and power limit (nvidia-smi), torch and CUDA versions; TF32
   off for matmuls and convolutions, so f32 comparisons are f32.
2. Build every kernel of ``moss_speech_decoder_cosy_torch/csrc`` with nvcc
   (one process per source, in parallel).
3. Kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes, with its time, the plain version's time, the
   time of one PyTorch library call computing the same function where
   there is one (a yardstick only; the port never calls it) and the
   card's bound.  ``flash_chunk_attention``: both entries, f32 and bf16.
   ``fused_tf_group``: the down, mid and up groups (L = 4) in f32 and
   bf16, a shared write offset with and without a wrap, the per-row mode,
   disabled rows, rings in ramp-up and full, and the mid group as the
   continuous batcher's tick runs it (per-row mode, rot 0, 20 to 80 rows);
   timed with the L2 cache flushed and warm.  Both group kernels take their scalar (write offset,
   ``n_tok``) as an int32 on the card, as the KV session passes it.
   ``fused_conformer_group``:
   the encoder's blocks group (L 6, C 5, Rt 35) and up group (L 4, C 20,
   Rt 140) in f32 and bf16, with an empty ring, in ramp-up, full, and with
   a wrapping write; timed with the L2 cache flushed before each launch
   (as the stream finds it) and warm.
4. Offline and windowed slice at full width: ``moss_flow_config()`` with
   flash attention and ``moss_hift_config()``, weights drawn from seed 0,
   bf16 compute.  ``token2wav`` of 250 tokens and ``stream_inference`` of
   100 tokens, 1 warm-up + median of 3 and one timed call after a
   50-token warm-up, with the launch counts read around every timed
   call, and the first chunk's latency of a new streaming session.
5. KV slice at full width, the configuration ``bench.py`` runs at batch 1:
   ``moss_flow_config()`` (ring attention, no flash), 10 steps with a
   4096-frame noise buffer, block 5, mel cache 8, max_token_len 40,
   ``kv_stream_decoder()`` with its defaults (ring 35 tokens, fused
   write-then-attend, kernel engine, CUDA graphs), bf16.  ``stream_decode``
   of 250 tokens, 1 warm-up + median of 3, with exactly 14
   ``fused_tf_group`` launches per wavefront iteration, graphed (each
   iteration and each per-hop step one graph replay, the default) then
   eager (``graphs=False``; 1 warm-up + 1 run) then graphed
   again (A B A); and the first
   hop's latency (a warm ``_hop`` + ``_voc``) graphed and eager.  Then the
   same through ``kv_stream_decoder(enc_kernel=True)``: exactly two
   ``fused_conformer_group`` launches per steady hop and the same
   ``fused_tf_group`` launches, graphed, eager, graphed.  Then the
   session's API at ``bench.py``'s KV protocol (``kv_api``):
   ``stream_decode(output="int16")`` equal to ``_pcm16`` of the f32 stream;
   the segmented decode (``segmented=True, seg_iters=32``) and
   ``stream_chunks(wavefront=True)`` equal to the unsegmented int16
   stream, sample for sample; each 1 warm-up + median of
   3 with the ``fused_tf_group`` launches checked, the first chunk's
   latency; ``program_flops(250)`` of the KV and windowed sessions
   (``utils/flops.py``) and the KV MFU beside the card line; and the
   full-width offline mel's bf16 deviation from f32, beside the JAX
   package's (a TPU figure).  Then the
   continuous batcher on the same decoder geometry: ``kv_batcher(n_lanes=
   4)`` (kernel engine, per-row writes, CUDA graphs) serving four
   250-token streams admitted one pump apart and fed 5 tokens a pump:
   aggregate x-realtime, each stream's completion RTF, the first chunk of
   the stream admitted into a busy pool, exactly 14 ``fused_tf_group``
   launches a tick, host and graph launches; the same eager (one run)
   and through one lane (1 warm-up + 1 run); each stream's wav against ``kv_stream_decoder()`` (reported).
   Then the windowed device session (``device_stream_decoder()``, the
   reference's windowed re-decode kept on the card) at ``bench.py``'s
   windowed protocol and configuration: bf16, 250 tokens, block 5, mel
   cache 8, window 40, no flash; 1 warm-up then the median of 5
   ``stream_decode(output="int16")`` graphed (every step a CUDA graph),
   one eager (``graphs=False``, its first call is no slower);
   the first hop (a warm ``_flow_step`` + ``_voc_step``) graphed and
   eager; host launch calls and graph launches of one graphed decode
   (profiled); the graphed and eager int16 streams must be equal; and 4
   streams in lockstep (``batch=4``, graphed, 1 warm-up and 1 timed
   run): aggregate x-realtime, each row held against the same tokens
   through the batch-1 session (within 30% of the stream's peak: bf16
   at another row count moves the seeded wav 14-18%).  It
   runs none of the CUDA kernels (its windows are right-padded, so flash
   is off), and the launch counts are checked to stay 0.
6. Cross-device: the flow mel in f32 on the card (kernels) and on the CPU
   (plain versions), same weights: offline over 50 tokens, one 40-token
   streaming window, the KV wavefront over 40 tokens with the per-layer
   encoder and with the kernel encoder hop, every exit mel of the
   batcher serving two staggered 40-token streams, and every emit mel of
   the windowed device session over 58 tokens (buckets of 4, 4 and 2
   windows as batched flow forwards, one straddling the filled window),
   the card's side graphed; and on the card the graphed KV, batcher and
   windowed mels against the eager ones, and the windowed lockstep pair's
   first row (flow scans) against the same stream alone.  The same for
   the KV session's concat dataflow (``fused=False``), its one-hot fused
   write (ring 36 at hop 5) and the batcher's concat lanes
   (``kv_batcher(fused=False)``), each on the unfused engine.  Then
   the lockstep pair (``batch=2``) card against CPU and each row against
   the batch-1 session, the int8 session card against CPU
   (``cross_kv_batch``), and the codec at full width card against CPU
   (``cross_codec``: pooled tokenizer features and tokens over 10 s, a
   3 s prompt's matcha mel and CAM++ embedding) with one ``convert_voice``
   round trip timed on the card.
   Lockstep streams, int8 rings and the tokenizer (after ``kv_api``):
   ``kv_batch`` is ``bench.py --batch 4``'s protocol (4 streams of 250
   tokens in lockstep, 812 ``fused_tf_group`` launches of 80 rows a
   decode, graphed median of 3 and one eager decode, each row within
   ``BATCH_ROWS_TOL`` of the batch-1 stream, device memory a stream);
   ``kv_quant`` the int8-ring session against full-precision rings (RTF,
   bytes, mel rel-L1 under the JAX package's 5e-2); ``tokenizer`` the
   WhisperVQ encoder at full width over 20 s of seeded audio, batch and
   80 ms streaming, their RTFs, chunk latency and token agreement.  The
   kernel phase holds ``fused_tf_group`` at the lockstep launch too (the
   mid group, 80 rows, one shared offset).
   The serving path (``serve``, after ``tokenizer``): a full-width model
   directory (``flow.pt``, ``hift.pt`` under the reference's key names)
   through ``load_model_dir`` bit-equal to the seeded states; the decode
   server's engine warmed by ``boot_warmup_batcher``, then four concurrent
   250-token ``decode_stream`` requests (pcm16; time to first byte, x
   realtime, bodies equal to the engine's chunks, 14 launches a tick, no
   graph captured after the boot), one oggopus request and an unknown
   format; the voice-conversion websocket core (``ChatSession`` over
   ``make_vc_handler``) fed 10 s of audio in 80 ms frames; and which host
   libraries the machine has.
   The speech LM (``lm``, after ``serve``) at CosyVoice2-0.5B width, bf16,
   weights from seed 10: ``generate`` of 250 tokens (10 s of speech at 25
   Hz, ``min_len = max_len = 250``) from 60 seeded text ids, graphed (one
   CUDA graph of 16 single-token steps, captured once, 1 warm-up + median
   of 3) and eager, the tokens equal; ms a token, tokens a second, the
   LM's RTF, the prefill alone and the per-token bound of the weights and
   K/V a step reads; one profiled graphed run (kernels and device time a
   token); the continuous batcher (4 slots, four 250-token requests
   submitted one step apart, graphed twice after a warm-up and once
   eager), each request's tokens equal to ``generate``'s with its seed;
   ``SpeechSynthesizer.tts`` end to end (the batcher's first 125-id text
   and seed -> 250 tokens, the text ratio's minimum -> ``token2wav`` at
   ``cosyvoice2_flow_config()`` with flash attention -> 24 kHz), exactly
   560 ``flash_chunk_attention`` launches, the LM's seconds beside the
   decoder's; ``tts_stream`` of a 25-id text (50 tokens); and
   ``ChatAudioConsumer`` over an interleaved 13-text / 26-audio id stream
   of the 250 tokens (blocks 25, 50, 100, 75).  ``cross_lm``: f32 logits of
   the full-width LM cut to 4 layers through prefill and 32 teacher-forced
   decode steps, card against CPU, within 1e-3 of the logits' peak.
   The ``lm`` phase also serves the batcher's four requests through its
   two-tier cache (``recent=64``), graphed, in turns with the single-tier
   batcher: tokens a second of each, and whether each bf16 stream equals
   ``generate``'s.
   The CosyVoice-v1 / stock GLM-4-Voice decoder (``v1``, after ``lm``):
   ``cosyvoice1_flow_config()`` with the flash kernel and
   ``cosyvoice1_hift_config()`` at full width, f32, weights from seeds 20
   and 21; ``V1Decoder.token2wav`` of 500 tokens (10 s at 50 Hz) behind a
   3 s prompt (150 tokens, a 258-frame mel, a 192-d x-vector), 1 warm-up +
   median of 3, exactly 640 flash launches a call and a wav of 256 x 861
   samples, the same in bf16 beside it and one profiled f32 call;
   ``stream_inference`` of the same tokens (5 flow calls, 3,200 launches)
   and the wall from the 120th pushed token to the first chunk; a model
   directory under the reference's v1 key names through
   ``load_model_dir(flow_version="v1")`` bit-equal to the seeded states;
   ``bin/inference.py --flow_version v1 --mode decode`` once.
   ``cross_v1``: f32 card against CPU, the flow mel over 60 tokens behind
   a 20-token prompt and every chunk mel of a ``StreamSessionV1`` over 150
   tokens (``CROSS_TOL``), the 22.05 kHz source over 1 s with the same
   draws (``V1_SOURCE_TOL``), one ``DiTConditionalCFM`` solve at
   ``DiTConfig()`` over 200 frames.  The kernel phase holds the flash
   kernel at the v1 U-Net's two shapes, (2, 8, 1119, 64) and (2, 8, 560,
   64), chunk 0, f32 and bf16, timed with the L2 cache flushed and warm.
   The ASR head, the eval harness and the data pipeline (after ``v1``):
   ``asr``, the Whisper ASR at the GLM-4-Voice tokenizer's full width with
   its post-VQ layers (``asr_config()``: 16 post-VQ layers of d 1280, a
   4-layer decoder, vocab 51866; seeded weights) over 60 s of seeded
   tokens (two 375-token segments), f32 and bf16: ``transcribe`` greedy
   with the fallback ladder, beam 5, ``return_timestamps``,
   ``word_timestamps`` (wall a segment), ms a decode step graphed (each
   step one CUDA graph replay) and eager, their tokens equal, one
   profiled decode; ``eval``, ``run_seed_tts_benchmark(score=True)`` over
   2 seeded 3-4 s utterances with 3 s prompts
   through the full-width codec, the bf16 MOSS decoder with flash and the
   f32 ASR (``failed == 0``, WER and SIM in ``result.json``, each
   sample's RTF, the flash
   launches); ``data``, the data chain over 32 seeded 24 kHz utterances
   from parquet and indexed-tar shards (samples a second, the fbank card
   against CPU).  ``cross_asr``: f32 card against CPU, the post-VQ states
   and the decoder's logits over a 32-token prefix (1e-4 of the peak),
   one segment's greedy tokens, ``encode_train``'s hidden states and ids.
   ``cross_hift`` (C3): the 24 kHz NSF source over 20 s and 30 s card
   against CPU (``HIFT_SOURCE_TOL``) with its scan drift (strided,
   contiguous, CPU) against float64, and one whole HiFT wav of a
   250-token decode card against CPU, reported.  CUPTI is set up before
   the first graph capture, and every profiled run opens with a lead-in
   of marker kernels (a trace misses its first milliseconds) and must show
   markers traced on both sides of its work (``utils/graphs.py``).
   The card-vs-CPU KV, batcher and windowed phases
   (``cross_kv``, ``cross_kv_options``, ``cross_batcher``,
   ``cross_batcher_concat``, ``cross_windowed``, ``cross_kv_batch``) run
   the estimator with ``CROSS_MID_BLOCKS`` (2) mid blocks in place of 12:
   the same widths, schedules, buckets, rings and tolerances, 4 fused
   groups an iteration of the same shapes in place of 14 (their CPU sides
   took 218-318 s at full depth); ``cross`` (offline and one window) and
   the kernel phases keep the full depth.
   Training (``train``, after ``data``), f32 with TF32 off, each step 1
   warm-up + the median of 5, peak memory, FLOPs, with every kernel's
   launch count held at 0 and the three CUDA entries' autograd guard
   raising on the card: the flow at ``moss_flow_config()`` (dropout 0.1,
   4 x 10 s, ``accum_steps`` 1 and 2, one profiled step), the HiFT GAN
   (``moss_hift_config()`` + MPD ++ MRD, 4 x 1 s, a discriminator and a
   generator turn), the speech LM at CosyVoice2-0.5B width (2 x (60 + 250
   ids), CE and DPO, one profiled CE step) and the VQ codebook (the
   GLM-4-Voice tokenizer, 2 x 10 s, a dead-code restart).
   ``cross_train``: one flow loss and its gradient (2 mid blocks, 2 x 40
   tokens) and one HiFT generator loss and its gradient (0.2 s), card
   against CPU with the same draws.
   The multi-device modules and the tools, after ``cross_train``:
   ``spmd``: ``spmd_decoder(["cuda:0"], batch=4)`` over ``kv_batch``'s 4 x
   250 tokens on its bf16 decoder (1 warm-up + 1 timed int16 decode, its
   ``fused_tf_group`` launches counted; within 1 LSB of ``kv_batch``'s
   lockstep stream), and two replicas on ``cuda:0`` in f32 at
   ``CROSS_MID_BLOCKS`` over 4 x 40 tokens against the batch-4 session
   (``CROSS_TOL``), every replica tensor on ``cuda:0``.  ``dist``: one
   NCCL group of world size 1 on 127.0.0.1; the data-parallel flow step
   with ZeRO-sharded moments at full width (the ``train`` batch) against
   the single-process step with the same draws (loss 1e-5 relative), 1
   warm-up + the median of 3; the 4-layer LM (``cross_lm``'s) made
   tensor-parallel at world size 1 against the unsharded one (prefill +
   8 forced decode steps' logits, 1e-4 of the peak); the NCCL kernels of
   one profiled DP step and one profiled TP forward counted (the
   collectives are issued on the card).  ``tools``: ``profile_wave`` at
   ``kernel:5:35`` (graphed, median of 3) and ``kernel:10:30`` (the
   kernel's limit reported); one ``profile_tail`` (graphed, median of
   3); ``ablate_dtype`` at full width; ``ablate_block
   --random-init`` at blocks 5 and 10; the copy audit of one wavefront
   iteration; one ``utils.profiling.trace`` of a 20-token KV decode whose
   Chrome trace holds its ``fused_tf_group`` kernels; one ``aot_compile``
   replay of ``forward_causal`` over the 4-layer LM's first layer against
   the eager call (1e-6 of the peak) and one ``torch.export`` round trip
   of it; ``ablate_dtype`` and ``ablate_block`` on the seeded states the
   other phases share.
7. One ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when CUDA is unavailable or the port's
package is not beside this script.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PACKAGE = "moss_speech_decoder_cosy_torch"

# flow mel, f32 on the card (kernel, cuBLAS/cuDNN without TF32) vs the CPU
CROSS_TOL = 1e-4
# KV mels, f32 on the card: the graphed steps vs the same steps run eagerly
GRAPH_TOL = 1e-5
# the KV, batcher and windowed card-vs-CPU phases run the estimator with 2
# mid blocks in place of 12 (4 fused groups of the same shapes in place of
# 14): their CPU sides ran the full depth in f32 for 218-318 s of a smoke
CROSS_MID_BLOCKS = 2
# bf16 windowed stream: a lockstep row against the same tokens alone, as a
# share of the stream's peak.  The two run the flow at other row counts, and
# at bf16 the seeded full-width wav moves 14-18% of its peak with the row
# count (the batcher against the KV session as well; in f32 both agree to
# 1e-8), so this catches a lost or misplaced hop; the f32 lockstep check in
# ``cross_windowed_phase`` is the strict one
BATCH_ROWS_TOL = 0.3
# the KV slice: bench.py's stream length and noise buffer
KV_TOKENS, KV_NOISE_LEN = 250, 4096
# bench.py --seg's default segment
SEG_ITERS = 32
# the JAX package's full-width offline bf16 mel, relative MAE against its
# f32 mel (BENCH_NOTES.md, round-2 ablation; a TPU figure, the reference's)
REFERENCE_BF16_MEL_REL_MAE = 0.029
FUSED_NOTE = ("no single PyTorch call computes a causal resnet followed by "
              "L transformer blocks with ring writes")
CONFORMER_NOTE = ("no single PyTorch call computes a group of rel-pos "
                  "conformer layers with ring writes")
# the encoder's two conformer groups in the KV session: (L, C, Rt) at
# block 5, ring 35 tokens and the x4 upsample
CONFORMER_GROUPS = {"blocks": (6, 5, 35), "up": (4, 20, 140)}


# the CosyVoice-v1 slice: 10 s of target speech (500 tokens at 50 Hz) behind
# a 3 s prompt (150 tokens, 258 mel frames at 22050 / 256 Hz)
V1_TOKENS, V1_PROMPT_TOKENS, V1_PROMPT_FRAMES = 500, 150, 258
V1_RATE = 50.0
# the flash launches' T at the U-Net's full and half rate: 258 + 861 frames
V1_FLASH_T = (1119, 560)
# the 22.05 kHz NSF source, card vs CPU over 1 s with the same draws: the
# phase is an f32 cumsum over 22,050 samples, a parallel scan on the card
# and a sequential one on the CPU (``cross_v1`` reports each one's drift
# from a float64 sum: 4.8e-4 and 6.1e-5 cycles on an H100 and its host)
V1_SOURCE_TOL = 1e-3


def time_cuda(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events).
    A spin kernel ahead of the first event keeps the card busy while the
    host enqueues the calls, so a call that does not wait on the card is
    timed on the device alone, without its host launch cost."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)        # ~25 ms of clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_cuda_cold(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call with the 50 MB L2 cache flushed before each call:
    a 128 MB buffer is written between calls, outside the timed events,
    then a spin kernel keeps the card busy while the host enqueues the
    call, so only the call's device time lies between the events."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.fill_(1)
        torch.cuda._sleep(2_000_000)     # ~1 ms of clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def attention_bound_ms(b: int, h: int, t: int, dk: int, chunk: int,
                       valid_len: int, dtype: str):
    """Least time for one attention call: the larger of the bytes moved
    (q read and out written over all T rows, k and v read up to valid_len)
    over HBM bandwidth and the operations this mask needs (2 QK^T + 2 PV
    flops per visible pair and feature) over the dtype's peak."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * t + 2 * valid_len) * b * h * dk * elem
    pairs = 0
    for i in range(t):
        end = valid_len if chunk == 0 else min(valid_len,
                                               (i // chunk + 1) * chunk)
        pairs += end
    flops = 4 * pairs * dk * b * h
    from moss_speech_decoder_cosy_torch.utils.flops import (
        PEAK_BYTES, PEAK_FLOPS)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def kernel_phase(torch, fa) -> list:
    """Both entries, f32 and bf16, at the main path's shapes, against the
    plain version; returns one record per case.  q and k at scale 0.3 give
    a near-uniform softmax; at scale 2 the scores spread over several units,
    so the online rescale and the bf16 rounding of p carry weight."""
    import torch.nn.functional as F
    cases = [(1000, 0, 1000, 0.3), (160, 50, 160, 0.3), (1000, 0, 777, 0.3),
             (160, 50, 131, 0.3), (1000, 0, 1000, 2.0), (160, 50, 131, 2.0)]
    # the v1 U-Net's two levels behind a 3 s prompt (``v1_phase``), also
    # timed with the L2 cache flushed
    cases += [(t, 0, t, 0.3) for t in V1_FLASH_T]
    b, h, dk = 2, 8, 64
    records = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for t, chunk, vl, qk_scale in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q, k = [(qk_scale * torch.randn(b, h, t, dk, device="cuda",
                                       generator=gen)).to(dtype)
                    for _ in range(2)]
            v = torch.randn(b, h, t, dk, device="cuda", generator=gen
                            ).to(dtype)
            pos = torch.arange(t, device="cuda")
            allow = (pos < vl)[None, :]
            if chunk:
                allow = allow & ((pos[None, :] // chunk)
                                 <= (pos[:, None] // chunk))
            want = fa.flash_chunk_attention_plain(q, k, v, chunk, vl)
            tol = fa.kernel_tolerance(want)
            plain_ms = time_cuda(
                lambda: fa.flash_chunk_attention_plain(q, k, v, chunk, vl))
            library_ms = time_cuda(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=allow))
            bound, bound_by = attention_bound_ms(b, h, t, dk, chunk, vl,
                                                 dname)
            for layout in ("bhtd", "fl"):
                if layout == "bhtd":
                    args = (q, k, v)
                    call = lambda: fa.flash_chunk_attention(  # noqa: E731
                        *args, chunk_size=chunk, valid_len=vl)
                    back = lambda o: o  # noqa: E731
                else:
                    args = tuple(x.transpose(1, 2).reshape(b, t, h * dk)
                                 .contiguous() for x in (q, k, v))
                    call = lambda: fa.flash_chunk_attention_fl(  # noqa: E731
                        *args, heads=h, chunk_size=chunk, valid_len=vl)
                    back = lambda o: o.reshape(  # noqa: E731
                        b, t, h, dk).transpose(1, 2)
                got = back(call())
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ms = time_cuda(call)
                rec = dict(layout=layout, dtype=dname, shape=[b, h, t, dk],
                           chunk=chunk, valid_len=vl, qk_scale=qk_scale,
                           out_max_abs=want.float().abs().max().item(),
                           max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound,
                           bound_by=bound_by)
                if t in V1_FLASH_T:
                    rec.update(v1=True, ms_cold_l2=time_cuda_cold(call))
                print("kernel", json.dumps(rec), flush=True)
                if not err <= tol:
                    raise AssertionError(f"kernel disagrees with its plain "
                                         f"version: {rec}")
                records.append(rec)
    return records


def group_bound_ms(rows: int, cf: int, cin: int, ch: int, inner: int,
                   ff: int, tdim: int, n_layers: int, rp: int, nd, enable,
                   dtype: str):
    """Least time for one ``fused_tf_group`` call.  Bytes: every input read
    once (x, mt, conv caches, the group's weights, and of each layer's ring
    only the valid slots the chunk does not overwrite), every output written
    once (x_out, conv caches, the enabled rows' chunk K/V).  Operations: the
    resnet's convs and time projection, each layer's QKV, out-proj and FF
    products, and QK^T and A V over each row's valid slots.  Over the
    dtype's peak: tensor cores in bf16, CUDA cores in f32."""
    elem = 2 if dtype == "bfloat16" else 4
    valid = [min(int(n), rp) for n in nd]
    written = [cf if e else 0 for e in enable]
    res_w = (3 * cin * ch + 3 * ch * ch + tdim * ch + cin * ch + 7 * ch)
    tf_w = n_layers * (3 * ch * inner + inner * ch + 2 * ch * ff + 6 * ch
                       + ff)
    ring_read = n_layers * sum(max(v - w, 0) for v, w in
                               zip(valid, written)) * 2 * inner
    ring_write = n_layers * sum(written) * 2 * inner
    nbytes = elem * (rows * (cf * cin + tdim + 2 * cin + 2 * ch)
                     + res_w + tf_w + ring_read + ring_write
                     + rows * (cf * ch + 2 * cin + 2 * ch))
    flops = (2 * rows * cf * (3 * cin * ch + 3 * ch * ch + cin * ch)
             + 2 * rows * tdim * ch
             + n_layers * 2 * rows * cf * (3 * ch * inner + inner * ch
                                           + 2 * ch * ff)
             + n_layers * 4 * sum(valid) * cf * inner)
    from moss_speech_decoder_cosy_torch.utils.flops import (
        PEAK_BYTES, PEAK_FLOPS)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


# lanes of the batcher's per-row cases: (w, avail, k_total, base frames)
# at 10 ODE steps and hop 20: a full ring, ramp-up (slots 0..3 valid),
# draining (slots 7..9 valid) and a stalled lane (every row disabled)
LANE_STATES = ((40, 41, 1 << 30, 0), (3, 4, 1 << 30, 40),
               (18, 21, 12, 0), (5, 5, 1 << 30, 20))


def lanes_rows(n_lanes: int, s_steps: int, cf: int):
    """The per-row scalars of a lanes tick of the first ``n_lanes`` of
    ``LANE_STATES``, rows ordered (s, cfg, lane) as ``wave_lanes_step``
    orders them: ([n_done + cf], [enable])."""
    nd, enable = [], []
    for s in range(s_steps):
        for _ in range(2):
            for w, avail, k_total, base in LANE_STATES[:n_lanes]:
                h = w - s
                nd.append(base + max(h, 0) * cf + cf)
                enable.append(int(0 <= h < k_total and w < avail))
    return nd, enable


def fused_group_phase(torch, fb) -> list:
    """``fused_tf_group`` against its plain version at the KV slice's shapes
    (20 wavefront rows, hop 20 frames, ring 160 slots, 8 x 64 heads, L 4):
    the down (cin 320), mid (256) and up (512) groups in their steady state
    (shared offset on the hop grid, full rings, every row enabled), and for
    the mid group a wrapping write at align 12 into ramp-up rings with two
    rows drained, the per-row mode, and disabled rows.  Then the mid group
    as the batcher's lanes tick runs it: the per-row mode with rot 0 at 20,
    40, 60 and 80 rows (1 to 4 lanes of ``LANE_STATES``: full and ramp-up
    rings, draining and stalled lanes).  Checks x_out, the rings and both
    conv caches (``fused_block.kernel_tolerance``), that disabled rows keep
    their rings and that no input changes.  Times each case with the L2
    cache flushed before each launch (as the stream finds it: each
    wavefront iteration streams 367 MB of rings through L2) and warm."""
    cf, rp, heads, hd, ch, n_layers = 20, 160, 8, 64, 256, 4
    ff = tdim = 4 * ch
    rows = 20
    rot = [((r // 2) * cf) % rp for r in range(rows)]
    steady = dict(shared=True, offset=100, nd=[rp + cf] * rows,
                  enable=[1] * rows, rot=rot)
    cases = [("down", 320, "steady", steady), ("mid", 256, "steady", steady),
             ("up", 512, "steady", steady),
             ("mid", 256, "wrap_rampup", dict(
                 shared=True, offset=152,
                 nd=[cf * (1 + r // 2) for r in range(rows)],
                 enable=[1] * (rows - 2) + [0, 0], rot=rot)),
             ("mid", 256, "per_row", dict(
                 shared=False, offset=0,
                 nd=[20, 45, 160, 171, 213, 300, 20, 99, 140, 180] * 2,
                 enable=[1, 1, 1, 0, 1, 1, 0, 1, 1, 1] * 2, rot=rot)),
             ("mid", 256, "disabled_rows", dict(
                 shared=True, offset=0, nd=[rp + cf] * rows,
                 enable=[int(r % 3 != 0) for r in range(rows)], rot=rot))]
    # the lockstep session at batch 4 (bench.py --batch 4): 2 * 4 * 10 rows
    # at one shared offset, rows ordered s * 8 + cfg * 4 + b
    lock = 2 * KV_BATCH * 10
    cases.append(("mid", 256, f"lockstep_{KV_BATCH}", dict(
        shared=True, offset=100, nd=[rp + cf] * lock, enable=[1] * lock,
        rot=[((r // (2 * KV_BATCH)) * cf) % rp for r in range(lock)])))
    for n_lanes in range(1, len(LANE_STATES) + 1):
        nd, enable = lanes_rows(n_lanes, 10, cf)
        cases.append(("mid", 256, f"lanes_{n_lanes}", dict(
            shared=False, offset=0, nd=nd, enable=enable,
            rot=[0] * len(nd))))
    records = []
    for group, cin, mode, c in cases:
        rows = len(c["nd"])
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            p, rp_, mt, cc1, cc2, x, rings = fb.make_group_inputs(
                rows, cf, cin, ch, heads, hd, n_layers, rp, dtype, "cuda",
                seed=cin + len(mode))
            scal = fb.group_scalars(c["nd"], c["rot"], c["enable"], "cuda")
            # the write offset held on the card, as the KV session passes it
            # (a host int would be uploaded by every timed call)
            offset = torch.tensor([c["offset"]], dtype=torch.int32,
                                  device="cuda")
            kw = dict(heads=heads, head_dim=hd, shared_offset=c["shared"])
            inputs = [t.clone() for t in (mt, cc1, cc2, x)]
            r_plain, r_kern = rings.clone(), rings.clone()
            want = fb.fused_tf_group_plain(p, rp_, mt, cc1, cc2, x, r_plain,
                                           scal, c["offset"], **kw)
            got = fb.fused_tf_group(p, rp_, mt, cc1, cc2, x, r_kern, scal,
                                    offset, **kw)
            torch.cuda.synchronize()
            errs, tols = {}, {}
            for g, w, what in zip(got, want, ("x", "rings", "cc1", "cc2")):
                errs[what] = (g.float() - w.float()).abs().max().item()
                tols[what] = fb.kernel_tolerance(w)
            off = torch.tensor(c["enable"], device="cuda") == 0
            kept = bool(torch.equal(r_kern[:, off], rings[:, off]))
            untouched = all(torch.equal(a, b) for a, b in
                            zip(inputs, (mt, cc1, cc2, x)))
            call = lambda: fb.fused_tf_group(  # noqa: E731
                p, rp_, mt, cc1, cc2, x, r_kern, scal, offset, **kw)
            ms = time_cuda_cold(call)
            ms_warm = time_cuda(call)
            plain_ms = time_cuda(lambda: fb.fused_tf_group_plain(
                p, rp_, mt, cc1, cc2, x, r_plain, scal, offset, **kw))
            bound, bound_by = group_bound_ms(
                rows, cf, cin, ch, heads * hd, ff, tdim, n_layers, rp,
                c["nd"], c["enable"], dname)
            rec = dict(group=group, mode=mode, dtype=dname,
                       shape=dict(rows=rows, cf=cf, cin=cin, ch=ch, L=n_layers,
                                  rp=rp, heads=heads, head_dim=hd),
                       max_abs_err=errs, tol=tols,
                       disabled_rows_kept=kept, inputs_untouched=untouched,
                       ms=ms, ms_warm_l2=ms_warm, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bound, bound_by=bound_by)
            print("fused_tf_group", json.dumps(rec), flush=True)
            if not (all(errs[k] <= tols[k] for k in errs) and kept
                    and untouched):
                raise AssertionError(f"fused_tf_group disagrees with its "
                                     f"plain version: {rec}")
            records.append(rec)
    return records


def conformer_bound_ms(n_layers: int, c: int, d: int, ff: int, rt: int,
                       n_tok: int, dtype: str):
    """Least time for one ``fused_conformer_group`` call.  Bytes: every input
    read once (x, the position rows, the group's weights, and of each
    layer's rings only the valid slots), every output written once (x_out,
    the chunk's [k | v] and pk).  Operations: each layer's QKV, position,
    out-proj and FF products, and the two score products and A V over the
    valid slots.  Over the dtype's peak: tensor cores in bf16, CUDA cores in
    f32."""
    elem = 2 if dtype == "bfloat16" else 4
    layer_w = (d * 3 * d + 3 * d + d * d + 2 * d + d * d + d + 4 * d
               + d * ff + ff + ff * d + d)
    valid = min(n_tok, rt)
    nbytes = elem * (n_layers * (layer_w + valid * 3 * d + c * 3 * d)
                     + 3 * c * d)
    flops = n_layers * (2 * c * d * (5 * d + 2 * ff)
                        + 6 * c * (valid + c) * d)
    from moss_speech_decoder_cosy_torch.utils.flops import (
        PEAK_BYTES, PEAK_FLOPS)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def conformer_phase(torch, fc) -> list:
    """``fused_conformer_group`` against its plain version at the KV
    session's shapes (D 512, 8 x 64 heads, FF 2048): the blocks group and
    the up group with an empty ring, in ramp-up, full, and with a write
    that wraps.  Checks x_out and both rings (``kernel_tolerance``), that
    only the chunk's slots change and that no input changes.  Times each
    case cold (L2 flushed before each launch) and warm, and records the
    launcher's grid and shared bytes a block."""
    d, heads, ff = 512, 8, 2048
    records = []
    for group, (n_layers, c, rt) in CONFORMER_GROUPS.items():
        cases = {"empty": 0, "rampup": 2 * c, "full": 3 * rt,
                 "wrap": 3 * rt + rt - c // 2 - 1}
        for mode, n_tok in cases.items():
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[1]
                p, x, pe, kv, pk = fc.make_conformer_inputs(
                    n_layers, c, d, heads, ff, rt, dtype, "cuda",
                    seed=c + n_tok)
                kw = dict(heads=heads, head_dim=d // heads)
                held = torch.tensor([n_tok], dtype=torch.int32,
                                    device="cuda")   # as the session passes it
                inputs = [t.clone() for t in (x, pe)]
                kv_p, pk_p, kv_k, pk_k = kv.clone(), pk.clone(), kv.clone(), \
                    pk.clone()
                want = fc.fused_conformer_group_plain(p, x, pe, kv_p, pk_p,
                                                      n_tok, **kw)
                got = fc.fused_conformer_group(p, x, pe, kv_k, pk_k, held,
                                               **kw)
                torch.cuda.synchronize()
                errs, tols = {}, {}
                for g, w, what in zip(got, want, ("x", "ring_kv", "ring_pk")):
                    errs[what] = (g.float() - w.float()).abs().max().item()
                    tols[what] = fc.kernel_tolerance(w)
                written = {(n_tok + f) % rt for f in range(c)}
                kept = [s for s in range(rt) if s not in written]
                kept_ok = bool(torch.equal(kv_k[:, :, kept], kv[:, :, kept])
                               and torch.equal(pk_k[:, :, kept],
                                               pk[:, :, kept]))
                untouched = all(torch.equal(a, b) for a, b in
                                zip(inputs, (x, pe)))
                call = lambda: fc.fused_conformer_group(  # noqa: E731
                    p, x, pe, kv_k, pk_k, held, **kw)
                ms_cold = time_cuda_cold(call)
                ms_warm = time_cuda(call)
                plain_ms = time_cuda(lambda: fc.fused_conformer_group_plain(
                    p, x, pe, kv_p, pk_p, held, **kw))
                bound, bound_by = conformer_bound_ms(n_layers, c, d, ff, rt,
                                                     n_tok, dname)
                rc, grid, smem = fc.launch_config(c, d, heads, d // heads, ff,
                                                  n_layers, rt, dtype)
                if rc:
                    raise AssertionError(f"fused_conformer_group_config "
                                         f"returned {rc} for a shape that "
                                         f"launched")
                rec = dict(group=group, mode=mode, dtype=dname,
                           shape=dict(L=n_layers, C=c, Rt=rt, D=d,
                                      heads=heads, FF=ff, n_tok=n_tok),
                           grid=grid, smem_bytes=smem,
                           max_abs_err=errs, tol=tols,
                           other_slots_kept=kept_ok,
                           inputs_untouched=untouched, ms=ms_cold,
                           ms_warm_l2=ms_warm, plain_ms=plain_ms,
                           library_ms=None, bound_ms=bound,
                           bound_by=bound_by)
                print("fused_conformer_group", json.dumps(rec), flush=True)
                if not (all(errs[k] <= tols[k] for k in errs) and kept_ok
                        and untouched):
                    raise AssertionError(f"fused_conformer_group disagrees "
                                         f"with its plain version: {rec}")
                records.append(rec)
    return records


def seeded_models(flash: bool = True, mid_blocks: int | None = None):
    """(flow_cfg, hift_cfg, flow_state, hift_state): the MOSS presets,
    weights from seeds 0 and 1.  ``flash``: the estimator's attention
    through the flash kernel (offline and windowed decode); without it, the
    KV session's configuration, with ``bench.py``'s 4096-frame noise
    buffer.  The states (the same for both: neither switch changes a
    parameter) are drawn once, ~4 s of host time, and each call gets its
    own copy.  ``mid_blocks``: the estimator cut to that many mid blocks
    (the same widths; the state keeps the first ones' weights)."""
    from moss_speech_decoder_cosy_torch.utils import config as C
    from moss_speech_decoder_cosy_torch.weights import seeded_states

    flow_cfg = C.moss_flow_config()
    hift_cfg = C.moss_hift_config()
    if "moss" not in SEEDED:
        SEEDED["moss"] = seeded_states(flow_cfg, hift_cfg)
    if flash:
        flow_cfg = dataclasses.replace(flow_cfg, estimator=dataclasses.replace(
            flow_cfg.estimator, use_flash_attention=True))
    else:
        flow_cfg = dataclasses.replace(flow_cfg, cfm=dataclasses.replace(
            flow_cfg.cfm, max_noise_len=KV_NOISE_LEN))
    flow_state, hift_state = (
        {k: v.clone() for k, v in state.items()} for state in SEEDED["moss"])
    if mid_blocks is not None:
        flow_cfg = dataclasses.replace(flow_cfg, estimator=dataclasses.replace(
            flow_cfg.estimator, num_mid_blocks=mid_blocks))
        cut = re.compile(r"\.mid_(?:res|tf)_(\d+)[._]")
        flow_state = {k: v for k, v in flow_state.items()
                      if not (m := cut.search(k))
                      or int(m.group(1)) < mid_blocks}
    return flow_cfg, hift_cfg, flow_state, hift_state


def launches_per_decode(flow_cfg) -> int:
    """Attention calls of one decode: every transformer block of the U-Net
    at every Euler step (CFG runs as one batch of 2)."""
    e = flow_cfg.estimator
    blocks = (2 * len(e.channels) + e.num_mid_blocks) * e.n_blocks
    return blocks * flow_cfg.cfm.n_timesteps


def timed_runs(call, what: str, want: dict, runs: int = 3, warmup=None):
    """One warm-up call (``warmup()`` if given, else ``call()``), then
    ``runs`` timed calls with each kernel's launch count
    (``counter.launches`` for each counter of ``want``) set to 0 just
    before each call and checked against ``want[counter]`` just after.
    Returns (last output, walls)."""
    (warmup or call)()
    walls = []
    for _ in range(runs):
        for counter in want:
            counter.launches = 0
        t0 = time.perf_counter()
        out = call()
        walls.append(time.perf_counter() - t0)
        for counter, n in want.items():
            if counter.launches != n:
                raise AssertionError(f"{what} launched {counter.__name__} "
                                     f"{counter.launches} times, expected "
                                     f"{n}")
    return out, walls


def slice_phase(torch, fa) -> dict:
    """Full-width token2wav and stream_inference through the port's entry
    points; returns the measurements."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder

    n_tokens, n_stream = 250, 100
    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models()
    dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                       compute_dtype=torch.bfloat16)
    per_decode = launches_per_decode(flow_cfg)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, flow_cfg.vocab_size, (1, n_tokens))
    samples = n_tokens * flow_cfg.token_mel_ratio * hift_cfg.total_upsample
    audio_s = samples / hift_cfg.sampling_rate

    counter = fa.launch_flash_chunk_attention
    wav, walls = timed_runs(lambda: dec.token2wav(tokens), "token2wav",
                            {counter: per_decode})
    launches = per_decode
    if wav.shape != (1, samples) or not np.isfinite(wav).all() or \
            np.abs(wav).max() > hift_cfg.audio_limit:
        raise AssertionError(f"bad token2wav output {wav.shape} "
                             f"max|x| {np.abs(wav).max()}")
    wall = statistics.median(walls)

    stream_tokens = rng.randint(0, flow_cfg.vocab_size, (1, n_stream))
    # one window per complete hop (hop + lookahead tokens), one to finish
    hop, ahead = dec.pipe_cfg.block_size, flow_cfg.pre_lookahead_len
    windows = max(0, (n_stream - ahead) // hop) + 1
    stream_launches = per_decode * windows
    # one timed call after a 50-token warm-up (every window shape, the
    # filled 40-token window included): the smoke's time goes to the v1
    # and train phases
    swav, stream_walls = timed_runs(
        lambda: dec.stream_inference(stream_tokens), "stream_inference",
        {counter: stream_launches}, runs=1,
        warmup=lambda: dec.stream_inference(stream_tokens[:, :50]))
    want_len = n_stream * flow_cfg.token_mel_ratio * hift_cfg.total_upsample
    if swav.shape != (1, want_len) or not np.isfinite(swav).all():
        raise AssertionError(f"bad stream output {swav.shape}")
    stream_wall = statistics.median(stream_walls)
    # first-chunk latency: a new session fed its first hop's tokens
    t0 = time.perf_counter()
    first = next(dec.new_session().push(stream_tokens[0, :hop + ahead]))
    first_chunk_s = time.perf_counter() - t0
    if not np.isfinite(first).all():
        raise AssertionError("bad first stream chunk")
    out = dict(tokens=n_tokens, audio_s=audio_s, launches=launches,
               launches_per_decode=per_decode, wall_s=walls, median_s=wall,
               rtf=wall / audio_s, wav_max_abs=float(np.abs(wav).max()),
               stream_tokens=n_stream, stream_windows=windows,
               stream_launches=stream_launches, stream_wall_s=stream_walls,
               stream_median_s=stream_wall,
               stream_rtf=stream_wall / (want_len / hift_cfg.sampling_rate),
               first_chunk_s=first_chunk_s)
    print("slice", json.dumps(out), flush=True)
    return out


def kv_decoder(flow_cfg, hift_cfg, flow_state, hift_state, n_tokens, **kw):
    """``AudioDecoder(...).kv_stream_decoder()`` with bench.py's pipeline
    geometry and the session's defaults; checks that it runs the kernel
    engine, graphed on the card.  ``twin`` makes the ``enc_kernel=True``
    and ``graphs=False`` sessions on the same decoder."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils.config import PipelineConfig

    dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                       PipelineConfig(block_size=5, mel_cache_len=8,
                                      max_token_len=40), **kw)
    kv = dec.kv_stream_decoder(token_cap=n_tokens + 16)
    if not (kv._kernel and kv._fused and kv.ring_tokens == 35
            and not kv._enc_kernel
            and kv._graphs == (kv.dev.type == "cuda")):
        raise AssertionError("kv_stream_decoder() did not select the fused "
                             "kernel engine over a 35-token ring, graphed "
                             "on the card")
    return kv


def twin(kv, n_tokens, enc_kernel: bool, graphs: bool = True):
    """A session on ``kv``'s decoder with ``enc_kernel`` and ``graphs``."""
    sess = kv.dec.kv_stream_decoder(token_cap=n_tokens + 16,
                                    enc_kernel=enc_kernel, graphs=graphs)
    if not (sess._enc_kernel == enc_kernel and sess._kernel
            and sess.ring_tokens == 35
            and sess._graphs == (graphs and sess.dev.type == "cuda")):
        raise AssertionError(f"kv_stream_decoder(enc_kernel={enc_kernel}, "
                             f"graphs={graphs}) did not select its engines")
    return sess


def steady_hops(kv, n_tokens: int) -> int:
    return sum(1 for _, fin in kv.schedule(n_tokens) if not fin)


def wave_launches(kv, flow_cfg, n_tokens: int) -> int:
    """fused_tf_group launches of one wavefront: one per resnet + group
    (down, each mid, up) in each of the k + S - 1 live iterations."""
    e = flow_cfg.estimator
    return ((steady_hops(kv, n_tokens) + flow_cfg.cfm.n_timesteps - 1)
            * (2 + e.num_mid_blocks))


def first_hop_s(torch, kv, tokens) -> float:
    """First-hop latency as bench.py times it: the per-hop flow step and the
    vocoder of the first hop from a fresh state, the second of two calls
    (the first captures the hop's graph)."""
    buf = kv._token_buf(tokens)
    for _ in range(2):
        cache, voc = kv.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel, _ = kv._hop(buf, cache, kv.hop, False)
        seg, _ = kv._voc(mel, voc, True, False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not torch.isfinite(seg).all():
        raise AssertionError("bad first KV chunk")
    return wall


def kv_slice_phase(torch, fb, fc) -> dict:
    """Full-width bf16 ``stream_decode`` of 250 tokens through the KV
    session with the per-layer encoder and with ``enc_kernel=True``, each
    graphed (the default), eager (``graphs=False``) and graphed again in
    one call, each 1 warm-up + median of 3, with the launch counts checked
    around every timed call;
    the first hop graphed and eager.  Returns the measurements."""

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(flash=False)
    kv = kv_decoder(flow_cfg, hift_cfg, flow_state, hift_state,
                    KV_TOKENS, compute_dtype=torch.bfloat16)
    launches = wave_launches(kv, flow_cfg, KV_TOKENS)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, flow_cfg.vocab_size, (1, KV_TOKENS))
    samples = KV_TOKENS * flow_cfg.token_mel_ratio * hift_cfg.total_upsample
    audio_s = samples / hift_cfg.sampling_rate
    conformer = fc.launch_fused_conformer_group
    enc_launches = 2 * steady_hops(kv, KV_TOKENS)

    def check(wav, what):
        if wav.shape != (1, samples) or not np.isfinite(wav).all() or \
                np.abs(wav).max() > hift_cfg.audio_limit:
            raise AssertionError(f"bad {what} output {wav.shape} "
                                 f"max|x| {np.abs(wav).max()}")

    out = dict(tokens=KV_TOKENS, audio_s=audio_s, launches=launches,
               launches_per_iteration=2 + flow_cfg.estimator.num_mid_blocks)
    for enc_kernel in (False, True):
        mode = "enc_kernel" if enc_kernel else "default"
        graphed = kv if not enc_kernel else twin(kv, KV_TOKENS, True)
        eager = twin(kv, KV_TOKENS, enc_kernel, graphs=False)
        want = {fb.launch_fused_tf_group: launches,
                conformer: enc_launches if enc_kernel else 0}
        walls = {}
        for name, sess in (("graphed", graphed), ("eager", eager),
                           ("graphed_again", graphed)):
            wav, walls[name] = timed_runs(
                lambda: sess.stream_decode(tokens),
                f"{mode} {name} stream_decode", want)
            check(wav, f"{mode} {name} stream_decode")
        rec = dict(launches=want[conformer] if enc_kernel else launches,
                   fused_tf_group_launches=launches,
                   graphs=sorted(str(k) for k in graphed._graph),
                   wav_max_abs=float(np.abs(wav).max()))
        for name, w in walls.items():
            rec[f"{name}_wall_s"] = w
            rec[f"{name}_stream_rtf"] = statistics.median(w) / audio_s
        rec["stream_rtf"] = rec["graphed_stream_rtf"]
        rec["first_chunk_s"] = first_hop_s(torch, graphed, tokens)
        rec["first_chunk_eager_s"] = first_hop_s(torch, eager, tokens)
        print(f"kv_{mode}", json.dumps(rec), flush=True)
        if enc_kernel:
            out["enc_kernel"] = rec
        else:
            out.update(rec)
        del eager
    return out


def cross_kv_phase(fb, fc) -> dict:
    """f32 KV wavefront over 40 tokens on the card (kernels, graphed; and
    the same steps eager) vs on the CPU (their plain versions), same
    weights: the flow mel of ``_flow_mels_wave`` including the finalize
    tail, with the per-layer encoder and with the kernel encoder hop
    (``enc_kernel=True``).  The wav is not compared: the NSF source's
    random draws differ between devices."""

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(
        flash=False, mid_blocks=CROSS_MID_BLOCKS)
    n_tokens = 40
    tokens = np.random.RandomState(2).randint(0, flow_cfg.vocab_size,
                                              (1, n_tokens))
    counters = (fb.launch_fused_tf_group, fc.launch_fused_conformer_group)
    mels = {}
    for dev in ("cuda", "cpu"):
        kv = kv_decoder(flow_cfg, hift_cfg, flow_state, hift_state,
                        n_tokens, device=dev)
        runs = [(e, g) for e in (False, True)
                for g in ((True, False) if dev == "cuda" else (True,))]
        for enc_kernel, graphs in runs:
            sess = (kv if (enc_kernel, graphs) == (False, True)
                    else twin(kv, n_tokens, enc_kernel, graphs))
            cache, _ = sess.init_state()
            for counter in counters:
                counter.launches = 0
            mel, _ = sess._flow_mels_wave(sess._token_buf(tokens), cache,
                                          sess.schedule(n_tokens))
            want = ((wave_launches(sess, flow_cfg, n_tokens),
                     2 * steady_hops(sess, n_tokens) if enc_kernel else 0)
                    if dev == "cuda" else (0, 0))
            got = tuple(counter.launches for counter in counters)
            if got != want:
                raise AssertionError(f"{dev} KV wavefront (enc_kernel="
                                     f"{enc_kernel}, graphs={graphs}) "
                                     f"launched the kernels {got} times, "
                                     f"expected {want}")
            mels[dev, enc_kernel, graphs] = mel.float().cpu().numpy()
        del kv
    out = {}
    for enc_kernel in (False, True):
        got = mels["cuda", enc_kernel, True]
        want = mels["cpu", enc_kernel, True]
        err = float(np.abs(got - want).max())
        graph_err = float(np.abs(got - mels["cuda", enc_kernel, False]).max())
        rec = dict(tokens=n_tokens, enc_kernel=enc_kernel,
                   mel_shape=list(want.shape),
                   mel_max_abs=float(np.abs(want).max()), max_abs_diff=err,
                   tol=CROSS_TOL, graphed_vs_eager_max_abs_diff=graph_err,
                   graphed_vs_eager_tol=GRAPH_TOL)
        print("cross_kv", json.dumps(rec), flush=True)
        if want.shape != (1, n_tokens * flow_cfg.token_mel_ratio,
                          flow_cfg.output_size) or \
                not np.isfinite(got).all() or not err <= CROSS_TOL \
                or not graph_err <= GRAPH_TOL:
            raise AssertionError(f"card (graphed), card (eager) and CPU KV "
                                 f"mels disagree: {rec}")
        out["enc_kernel" if enc_kernel else "default"] = rec
    return out


def kv_api_phase(torch, fb) -> dict:
    """``bench.py``'s KV protocol through the session's API, full width,
    bf16, graphed: 250 tokens, block 5, ring 35.  ``stream_decode(output=
    "int16")`` must equal ``_pcm16`` of the f32 stream exactly; the
    segmented decode (``segmented=True, seg_iters=32``) and the chunks of
    ``stream_chunks(wavefront=True)`` must equal the unsegmented int16
    stream exactly (the bulk vocoder runs every batch of hop windows at one
    shape, so the segments change no float sum).  Each timed 1 warm-up + median of 3 with the
    ``fused_tf_group`` launches checked around every call; the first
    chunk's latency of ``stream_chunks``; ``program_flops(250)`` of the KV
    session and of the windowed device session, and the KV MFU; then the
    full-width bf16 deviation: the offline mel, bf16 against f32, as a
    relative MAE, beside the JAX package's (a TPU figure)."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.pipeline.kv_session import _pcm16
    from moss_speech_decoder_cosy_torch.utils.config import PipelineConfig
    from moss_speech_decoder_cosy_torch.utils.device import card_line
    from moss_speech_decoder_cosy_torch.utils.flops import (
        chip_peak_flops, mfu)

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(flash=False)
    kv = kv_decoder(flow_cfg, hift_cfg, flow_state, hift_state,
                    KV_TOKENS, compute_dtype=torch.bfloat16)
    tokens = np.random.RandomState(0).randint(0, flow_cfg.vocab_size,
                                              (1, KV_TOKENS))
    samples = KV_TOKENS * flow_cfg.token_mel_ratio * hift_cfg.total_upsample
    audio_s = samples / hift_cfg.sampling_rate
    launches = wave_launches(kv, flow_cfg, KV_TOKENS)
    want = {fb.launch_fused_tf_group: launches}

    f32 = kv.stream_decode(tokens)
    first_chunk = []

    def chunks():
        t0 = time.perf_counter()
        got = []
        for c in kv.stream_chunks(tokens, wavefront=True,
                                  seg_iters=SEG_ITERS):
            if not got:
                first_chunk.append(time.perf_counter() - t0)
            got.append(c)
        return np.concatenate(got, axis=1)

    calls = {"int16": lambda: kv.stream_decode(tokens, output="int16"),
             "segmented": lambda: kv.stream_decode(
                 tokens, output="int16", segmented=True,
                 seg_iters=SEG_ITERS),
             "chunks": chunks}
    out, streams = dict(tokens=KV_TOKENS, audio_s=audio_s,
                        seg_iters=SEG_ITERS, launches=launches), {}
    for name, call in calls.items():
        streams[name], walls = timed_runs(call, f"kv_api {name}", want)
        out[name] = dict(wall_s=walls, rtf=statistics.median(walls)
                         / audio_s)
    out["chunks"]["first_chunk_s"] = first_chunk[1:]
    out["chunks"]["first_chunk_median_s"] = statistics.median(
        first_chunk[1:])
    out["chunks"]["n_chunks"] = len(kv._seg_sizes(
        steady_hops(kv, KV_TOKENS) + kv.s_steps - 1, SEG_ITERS, grow=True))
    out["segmented_launches"] = launches
    i16 = streams["int16"]
    if not (i16.dtype == np.int16 and i16.shape == (1, samples)
            and np.array_equal(i16, _pcm16(torch.from_numpy(f32)).numpy())):
        raise AssertionError("stream_decode(output='int16') is not _pcm16 "
                             "of the f32 stream")
    for name in ("segmented", "chunks"):
        got = streams[name]
        if name == "chunks":
            out[name]["f32_max_abs_diff"] = float(np.abs(got - f32).max())
            got = _pcm16(torch.from_numpy(got)).numpy()
        diff = np.abs(got.astype(np.int32) - i16)
        rec = out[name]
        rec["differing_samples"] = int((diff > 0).sum())
        rec["max_lsb_diff"] = int(diff.max())
        if got.shape != i16.shape or rec["max_lsb_diff"]:
            raise AssertionError(f"kv_api {name} stream differs from the "
                                 f"unsegmented int16 stream: {rec}")

    flops = kv.program_flops(KV_TOKENS, output="int16")
    win = kv.dec.device_stream_decoder()
    win_flops = win.program_flops(KV_TOKENS)
    del win
    out["program_flops"] = dict(
        kv=flops, windowed_device=win_flops,
        kv_segmented=kv.program_flops(KV_TOKENS, output="int16",
                                      segmented=True, seg_iters=SEG_ITERS),
        peak_bf16=chip_peak_flops(dtype=torch.bfloat16),
        kv_mfu=mfu(flops, statistics.median(out["int16"]["wall_s"]),
                   dtype=torch.bfloat16), card=card_line())
    if not (0 < flops < win_flops and out["program_flops"]["kv_mfu"]):
        raise AssertionError(f"bad FLOP counts: {out['program_flops']}")

    # the bf16 deviation of the offline mel at full width
    f32_dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                           PipelineConfig(block_size=5, mel_cache_len=8,
                                          max_token_len=40))
    none = kv.dec._defaults(None, None, None)
    m16 = kv.dec._flow_mel(tokens, *none, streaming=False, finalize=True)
    m32 = f32_dec._flow_mel(tokens, *none, streaming=False, finalize=True)
    del f32_dec
    if not (np.isfinite(m16).all() and m16.shape == m32.shape):
        raise AssertionError("bad bf16 offline mel")
    out["bf16_mel_rel_mae"] = dict(
        port=float(np.abs(m16 - m32).mean() / np.abs(m32).mean()),
        reference_tpu=REFERENCE_BF16_MEL_REL_MAE, tokens=KV_TOKENS,
        mel_abs_mean=float(np.abs(m32).mean()))
    print("kv_api", json.dumps(out), flush=True)
    return out


def cross_kv_options_phase(fb) -> dict:
    """f32 KV wavefront over 40 tokens for the concat dataflow
    (``fused=False``, ring 35: one shared offset under rotated rings) and
    the one-hot fused write (ring 36 at hop 5), each on the unfused engine:
    the card graphed against the CPU (plain path) and the card eager; no
    kernel launches."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils.config import PipelineConfig

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(
        flash=False, mid_blocks=CROSS_MID_BLOCKS)
    n_tokens = 40
    tokens = np.random.RandomState(3).randint(0, flow_cfg.vocab_size,
                                              (1, n_tokens))
    options = {"concat": (dict(fused=False), "concat", "dus"),
               "onehot_ring_36": (dict(ring_tokens=36), "fused", "onehot")}
    mels = {}
    for dev in ("cuda", "cpu"):
        dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                           PipelineConfig(block_size=5, mel_cache_len=8,
                                          max_token_len=40), device=dev)
        for name, (kw, dataflow, write) in options.items():
            for graphs in ((True, False) if dev == "cuda" else (True,)):
                sess = dec.kv_stream_decoder(token_cap=n_tokens + 16,
                                             graphs=graphs, **kw)
                if (sess._kernel or sess._dataflow != dataflow
                        or sess._write != write):
                    raise AssertionError(f"kv_stream_decoder({kw}) took "
                                         f"the wrong dataflow")
                cache, _ = sess.init_state()
                fb.launch_fused_tf_group.launches = 0
                mel, _ = sess._flow_mels_wave(sess._token_buf(tokens),
                                              cache,
                                              sess.schedule(n_tokens))
                if fb.launch_fused_tf_group.launches:
                    raise AssertionError(f"{name} launched fused_tf_group")
                mels[dev, name, graphs] = mel.float().cpu().numpy()
                del sess
        del dec
    out = {}
    for name in options:
        got, want = mels["cuda", name, True], mels["cpu", name, True]
        err = float(np.abs(got - want).max())
        graph_err = float(np.abs(got - mels["cuda", name, False]).max())
        rec = dict(tokens=n_tokens, mel_shape=list(want.shape),
                   mel_max_abs=float(np.abs(want).max()), max_abs_diff=err,
                   tol=CROSS_TOL, graphed_vs_eager_max_abs_diff=graph_err,
                   graphed_vs_eager_tol=GRAPH_TOL)
        print(f"cross_kv_{name}", json.dumps(rec), flush=True)
        if not np.isfinite(got).all() or not err <= CROSS_TOL \
                or not graph_err <= GRAPH_TOL:
            raise AssertionError(f"card (graphed), card (eager) and CPU "
                                 f"{name} KV mels disagree: {rec}")
        out[name] = rec
    return out


def batcher(dec, n_lanes: int, n_tokens: int, graphs: bool = True,
            fused: bool = True):
    """``dec.kv_batcher(n_lanes)`` with its defaults (ring 35 tokens, the
    kernel engine when ``kernel_limit`` allows it, CUDA graphs on the
    card); checks that it took them.  ``fused=False``: the concat lanes,
    on the unfused engine."""
    b = dec.kv_batcher(n_lanes=n_lanes, token_cap=n_tokens + 16,
                       graphs=graphs, fused=fused)
    if not (b._kernel == fused and b.ring_tokens == 35
            and b._graphs == (graphs and b.dev.type == "cuda")):
        raise AssertionError(f"kv_batcher(n_lanes={n_lanes}, graphs="
                             f"{graphs}, fused={fused}) did not select its "
                             f"engine over a 35-token ring")
    return b


def drive(b, streams, piece: int = 5, max_iters: int = 8,
          on_pump=None) -> dict:
    """Serves ``streams`` [(embedding, tokens (1, n))] through batcher ``b``
    as a speech LM would feed it: stream i is admitted after i pumps (and
    once a lane is free), each admitted stream gets its next ``piece``
    tokens before every ``pump(max_iters)`` and is finished with its last
    piece; pumps until every stream has drained.  ``on_pump(b, n_ticks)``
    runs after each pump.  Returns the wavs, the host walls of each
    stream's admission, first chunk and last chunk from the start, the
    wall, pumps and ticks."""
    n = len(streams)
    lane_of, stream_of = {}, {}
    pushed, chunks = [0] * n, [[] for _ in range(n)]
    t_admit, t_first, t_done = [None] * n, [None] * n, [None] * n
    pumps, ticks0 = 0, b.ticks
    t0 = time.perf_counter()
    while any(t is None for t in t_done):
        nxt = len(lane_of)
        if nxt < n and pumps >= nxt and b.free_lanes:
            emb, toks = streams[nxt]
            lane = b.admit(np.zeros((1, 0), np.int32),
                           np.zeros((1, 0, b.n_mel), np.float32), emb)
            lane_of[nxt], stream_of[lane] = lane, nxt
            t_admit[nxt] = time.perf_counter() - t0
        for i, lane in lane_of.items():
            toks = streams[i][1]
            if t_done[i] is None and pushed[i] < toks.shape[1]:
                b.push(lane, toks[:, pushed[i]:pushed[i] + piece])
                pushed[i] = min(pushed[i] + piece, toks.shape[1])
                if pushed[i] == toks.shape[1]:
                    b.finish(lane)
        before = b.ticks
        out = b.pump(max_iters)
        pumps += 1
        if on_pump is not None:
            on_pump(b, b.ticks - before)
        now = time.perf_counter() - t0
        for lane, wav in out.items():
            i = stream_of[lane]
            chunks[i].append(wav)
            if t_first[i] is None:
                t_first[i] = now
            if not b._lanes[lane].active:
                t_done[i] = now
                del stream_of[lane]
        if pumps > 10_000:
            raise AssertionError("the batcher never drained its streams")
    return dict(wavs=[np.concatenate(c, axis=1) for c in chunks],
                wall_s=time.perf_counter() - t0, admit_s=t_admit,
                first_chunk_s=t_first, done_s=t_done, pumps=pumps,
                ticks=b.ticks - ticks0)


def host_launches(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (``utils.graphs.
    profiled``: markers traced on both sides of it): the host's launch
    calls (``cudaLaunchKernel*``, ``cudaGraphLaunch``), the kernels the
    card ran, device time and its share of the wall (the profiler's own
    host cost lowers that share), the device time of ``fused_tf_group``
    and the ten kernels that took the most device time, and the edges
    proved."""
    from moss_speech_decoder_cosy_torch.utils.graphs import profiled
    prof, wall, edges = profiled(fn)
    if not all(edges):
        raise AssertionError(f"a kernel of the profiled run may lie "
                             f"outside the trace (markers before and "
                             f"after it traced: {edges})")
    return dict(trace_summary(prof, wall, device_s_of=("fused_tf_group",)),
                edges=list(edges))


def batcher_phase(torch, fb) -> dict:
    """The continuous batcher at full width, bf16: four streams of 250
    tokens (no prompt, seeded speaker embeddings) through
    ``kv_batcher(n_lanes=4)`` (kernel engine, CUDA graphs), staggered and
    LM-paced (``drive``): 1 warm-up + median of 3, with exactly 14
    ``fused_tf_group`` launches per tick checked around every run; one
    profiled graphed run (host launch calls, graph launches, device time);
    the same traffic eager (``graphs=False``, one run: it captures nothing,
    so its first run is no slower) and through one lane
    (``n_lanes=1``: the streams one after another, 20-row ticks; 1 warm-up
    + 1 timed run); and each
    stream's wav against the same stream through ``kv_stream_decoder()``
    (reported: the two number the ring slots differently)."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils.config import PipelineConfig

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(flash=False)
    dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                       PipelineConfig(block_size=5, mel_cache_len=8,
                                      max_token_len=40),
                       compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(3)
    streams = [(rng.randn(1, flow_cfg.spk_embed_dim).astype(np.float32),
                rng.randint(0, flow_cfg.vocab_size, (1, KV_TOKENS)))
               for _ in range(4)]
    samples = KV_TOKENS * flow_cfg.token_mel_ratio * hift_cfg.total_upsample
    audio_s = samples / hift_cfg.sampling_rate
    groups = 2 + flow_cfg.estimator.num_mid_blocks
    counter = fb.launch_fused_tf_group

    def run(b):
        counter.launches = 0
        got = drive(b, streams)
        if counter.launches != groups * got["ticks"]:
            raise AssertionError(f"the batcher launched fused_tf_group "
                                 f"{counter.launches} times in "
                                 f"{got['ticks']} ticks, expected "
                                 f"{groups} a tick")
        for wav in got["wavs"]:
            if wav.shape != (1, samples) or not np.isfinite(wav).all() or \
                    np.abs(wav).max() > hift_cfg.audio_limit:
                raise AssertionError(f"bad batcher output {wav.shape}")
        return got

    def timed(b, what, n_runs=3, warm=True):
        if warm:
            run(b)                                        # warm-up
        runs = [run(b) for _ in range(n_runs)]
        mid = sorted(runs, key=lambda r: r["wall_s"])[n_runs // 2]
        rec = dict(
            lanes=b.lanes, graphs=b._graphs, walls_s=[r["wall_s"]
                                                      for r in runs],
            wall_s=mid["wall_s"], ticks=mid["ticks"], pumps=mid["pumps"],
            fused_tf_group_launches=groups * mid["ticks"],
            tick_ms=1e3 * mid["wall_s"] / mid["ticks"],
            aggregate_x_realtime=len(streams) * audio_s / mid["wall_s"],
            completion_rtf=[(d - a) / audio_s for a, d in
                            zip(mid["admit_s"], mid["done_s"])],
            first_chunk_s=[f - a for a, f in zip(mid["admit_s"],
                                                 mid["first_chunk_s"])])
        print(f"batcher_{what}", json.dumps(rec), flush=True)
        return rec, mid

    out = dict(tokens=KV_TOKENS, streams=len(streams), audio_s=audio_s,
               piece_tokens=5, max_iters=8)
    b = batcher(dec, 4, KV_TOKENS)
    out["graphed"], got = timed(b, "graphed")
    prof = host_launches(torch, lambda: run(b))
    out["graphed"]["profiled"] = prof
    out["graphed"]["graph_keys"] = sorted(str(k) for k in b._steps.graphs)
    print("batcher_profile", json.dumps(prof), flush=True)
    # the first chunk of the stream admitted last, into three busy lanes
    out["first_chunk_busy_pool_s"] = out["graphed"]["first_chunk_s"][-1]
    diffs = []
    for (emb, toks), wav in zip(streams, got["wavs"]):
        ref = dec.kv_stream_decoder(embedding=emb, token_cap=KV_TOKENS + 16
                                    ).stream_decode(toks)
        diffs.append(dict(max_abs_diff=float(np.abs(wav - ref).max()),
                          ref_max_abs=float(np.abs(ref).max())))
    out["vs_kv_stream_decoder"] = diffs
    print("batcher_vs_session", json.dumps(diffs), flush=True)
    del b
    eager = batcher(dec, 4, KV_TOKENS, graphs=False)
    out["eager"], _ = timed(eager, "eager", n_runs=1, warm=False)
    del eager
    one = batcher(dec, 1, KV_TOKENS)
    # 1 warm-up + 1 timed run: the smoke's time goes to the v1 phases
    out["one_lane"], _ = timed(one, "one_lane", n_runs=1)
    return out


def cross_batcher_phase(fb, fused: bool = True) -> dict:
    """f32 batcher, two lanes x 40 tokens, staggered and LM-paced
    (``drive``): every valid exit mel of every tick on the card (kernel
    engine, graphed; and eager) against the CPU (plain versions), same
    weights, the card's ``fused_tf_group`` launches exactly 14 a tick.
    ``fused=False``: the concat lanes on the unfused engine (no kernel
    launch).  The wav is not compared: the NSF source's random draws
    differ between devices."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils.config import PipelineConfig

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(
        flash=False, mid_blocks=CROSS_MID_BLOCKS)
    n_tokens = 40
    rng = np.random.RandomState(4)
    streams = [(rng.randn(1, flow_cfg.spk_embed_dim).astype(np.float32),
                rng.randint(0, flow_cfg.vocab_size, (1, n_tokens)))
               for _ in range(2)]
    groups = 2 + flow_cfg.estimator.num_mid_blocks
    mels, session_diff = {}, []
    for dev, graphs in (("cuda", True), ("cuda", False), ("cpu", False)):
        dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                           PipelineConfig(block_size=5, mel_cache_len=8,
                                          max_token_len=40), device=dev)
        b = batcher(dec, 2, n_tokens, graphs=graphs, fused=fused)
        got = []

        def keep(b, n_ticks):
            if n_ticks:
                m, ok = b._burst_out
                ok = ok[:n_ticks].cpu().numpy()
                got.append(m[:n_ticks].float().cpu().numpy()[ok])
        fb.launch_fused_tf_group.launches = 0
        served = drive(b, streams, on_pump=keep)
        ticks = served["ticks"]
        want = groups * ticks if dev == "cuda" and fused else 0
        if fb.launch_fused_tf_group.launches != want:
            raise AssertionError(f"{dev} batcher (graphs={graphs}) launched "
                                 f"fused_tf_group "
                                 f"{fb.launch_fused_tf_group.launches} "
                                 f"times, expected {want}")
        mels[dev, graphs] = np.concatenate(got)
        if dev == "cuda" and graphs:
            # the same streams through the single-stream session, f32
            # (reported: the two number the ring slots differently)
            for (emb, toks), wav in zip(streams, served["wavs"]):
                ref = dec.kv_stream_decoder(
                    embedding=emb, token_cap=n_tokens + 16,
                    fused=fused).stream_decode(toks)
                session_diff.append(dict(
                    max_abs_diff=float(np.abs(wav - ref).max()),
                    ref_max_abs=float(np.abs(ref).max())))
        del b, dec
    card, cpu = mels["cuda", True], mels["cpu", False]
    err = float(np.abs(card - cpu).max())
    graph_err = float(np.abs(card - mels["cuda", False]).max())
    rec = dict(tokens=n_tokens, lanes=2, fused=fused,
               exit_mels=list(card.shape),
               mel_max_abs=float(np.abs(cpu).max()), max_abs_diff=err,
               tol=CROSS_TOL, graphed_vs_eager_max_abs_diff=graph_err,
               graphed_vs_eager_tol=GRAPH_TOL,
               card_wav_vs_kv_stream_decoder=session_diff)
    print("cross_batcher" if fused else "cross_batcher_concat",
          json.dumps(rec), flush=True)
    if card.shape != cpu.shape or card.shape[0] != 2 * ((n_tokens - 3) // 5) \
            or not np.isfinite(card).all() or not err <= CROSS_TOL \
            or not graph_err <= GRAPH_TOL:
        raise AssertionError(f"card (graphed), card (eager) and CPU batcher "
                             f"mels disagree: {rec}")
    return rec


def cross_phase(torch) -> dict:
    """f32 flow mel on the card (kernel) vs on the CPU (plain path):
    offline over 50 tokens (chunk 0) and streaming over one 40-token
    window (chunk 50)."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models()
    rng = np.random.RandomState(1)
    runs = {False: rng.randint(0, flow_cfg.vocab_size, (1, 50)),
            True: rng.randint(0, flow_cfg.vocab_size, (1, 40))}
    mels = {}
    for dev in ("cuda", "cpu"):
        dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                           device=dev)
        none = dec._defaults(None, None, None)
        for streaming, tokens in runs.items():
            mels[dev, streaming] = dec._flow_mel(
                tokens, *none, streaming=streaming, finalize=True)
        del dec
    out = {}
    for streaming, tokens in runs.items():
        got, want = mels["cuda", streaming], mels["cpu", streaming]
        err = float(np.abs(got - want).max())
        rec = dict(tokens=tokens.shape[1], mel_shape=list(want.shape),
                   mel_max_abs=float(np.abs(want).max()), max_abs_diff=err,
                   tol=CROSS_TOL)
        out["streaming" if streaming else "offline"] = rec
        if not np.isfinite(got).all() or not err <= CROSS_TOL:
            raise AssertionError(f"card and CPU mels disagree "
                                 f"(streaming={streaming}): {rec}")
    print("cross", json.dumps(out), flush=True)
    return out


def windowed_first_hop_s(torch, sess, tokens) -> float:
    """First-hop latency as ``bench.py`` times it: the flow step and the
    vocoder step of the first hop from a fresh state; graphed, the second
    of two calls (the first captures the steps' graphs)."""
    buf = sess._token_buf(tokens)
    for _ in range(2 if sess._graphs else 1):
        state = sess.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = sess._flow_step(buf, state, sess.hop + sess.prompt_pad, False)
        seg, _ = sess._voc_step(mel, state, True, False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not torch.isfinite(seg).all():
        raise AssertionError("bad first windowed chunk")
    return wall


def windowed_device_phase(torch, counters) -> dict:
    """``bench.py``'s windowed protocol through the device session at full
    width, bf16: graphed then eager (equal int16 streams), the first hop of
    each, one profiled graphed decode, then 4 streams in lockstep, each row
    held against the batch-1 session; none of ``counters`` (the kernels'
    launch counts) may move."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils.config import PipelineConfig

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(flash=False)
    dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                       PipelineConfig(block_size=5, mel_cache_len=8,
                                      max_token_len=40),
                       compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, flow_cfg.vocab_size, (1, KV_TOKENS))
    samples = KV_TOKENS * flow_cfg.token_mel_ratio * hift_cfg.total_upsample
    audio_s = samples / hift_cfg.sampling_rate
    for c in counters:
        c.launches = 0

    def check(wav, rows, what):
        """The stream's shape, finite, and a float wav within the clamp
        (``audio_limit``) times the cross-fade's largest weight sum."""
        if wav.shape != (rows, samples) or not np.isfinite(wav).all() or (
                wav.dtype == np.float32 and np.abs(wav).max() > 1.1):
            raise AssertionError(f"bad {what} output {wav.shape}")

    out = dict(tokens=KV_TOKENS, audio_s=audio_s, part_s={})
    pcms, single = {}, None
    for name, graphs, runs in (("graphed", True, 5), ("eager", False, 1)):
        t_part = time.perf_counter()
        sess = dec.device_stream_decoder(graphs=graphs)
        if sess._graphs != graphs:
            raise AssertionError(f"device_stream_decoder(graphs={graphs}) "
                                 f"did not take it")
        keys = sess.dispatches(KV_TOKENS)
        rec = dict(steps=len(keys), distinct_steps=len(set(keys)))
        if graphs:                     # the warm-up, which captures
            t0 = time.perf_counter()
            wav = sess.stream_decode(tokens)
            rec["warmup_s"] = time.perf_counter() - t0
            check(wav, 1, "windowed graphed")
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            pcms[name] = sess.stream_decode(tokens, output="int16")
            walls.append(time.perf_counter() - t0)
        check(pcms[name], 1, f"windowed {name} int16")
        rec.update(walls_s=walls, median_s=statistics.median(walls),
                   rtf=statistics.median(walls) / audio_s,
                   graphs=len(sess._steps.graphs),
                   first_hop_s=windowed_first_hop_s(torch, sess, tokens))
        if graphs:
            quant = float(np.abs(pcms[name] / 32767.0
                                 - np.clip(wav, -1, 1)).max())
            if pcms[name].dtype != np.int16 or quant > 1.01 / 32767:
                raise AssertionError(f"int16 output off by {quant}")
            if rec["graphs"] != len(set(keys)):
                raise AssertionError(f"{rec['graphs']} graphs for "
                                     f"{len(set(keys))} distinct steps")
            rec["profiled"] = host_launches(
                torch, lambda: sess.stream_decode(tokens, output="int16"))
            out["wav_max_abs"] = float(np.abs(wav).max())
        print(f"windowed_device_{name}", json.dumps(rec), flush=True)
        out[name] = rec
        out["part_s"][name] = time.perf_counter() - t_part
        if graphs:
            single = sess
        del sess
    diff = int(np.abs(pcms["graphed"].astype(np.int32)
                      - pcms["eager"]).max())
    out["graphed_vs_eager_int16_max_diff"] = diff
    if diff:                  # the same kernels on the same inputs
        raise AssertionError(f"graphed and eager int16 streams differ by "
                             f"{diff}")
    out["dispatches"] = [str(k) for k in single.dispatches(KV_TOKENS)]

    t_part = time.perf_counter()
    sess4 = dec.device_stream_decoder(batch=4)
    tokens4 = rng.randint(0, flow_cfg.vocab_size, (4, KV_TOKENS))
    wav4 = sess4.stream_decode(tokens4)
    check(wav4, 4, "windowed batch 4")
    out["part_s"]["batch4_warmup"] = time.perf_counter() - t_part
    # each lockstep row (flow scans of 8 rows) against the same tokens
    # through the batch-1 session (32-row bucket forwards), both bf16
    errs, peaks = [], []
    for row in range(4):
        want = single.stream_decode(tokens4[row:row + 1])
        errs.append(float(np.abs(wav4[row] - want[0]).max()))
        peaks.append(float(np.abs(want).max()))
    rows = dict(max_abs_diff=errs, wav_max_abs=peaks,
                tol_of_peak=BATCH_ROWS_TOL)
    t0 = time.perf_counter()
    pcm = sess4.stream_decode(tokens4, output="int16")
    walls = [time.perf_counter() - t0]
    check(pcm, 4, "windowed batch 4 int16")
    out["batch4"] = dict(walls_s=walls, median_s=statistics.median(walls),
                         aggregate_x_realtime=4 * audio_s
                         / statistics.median(walls),
                         graphs=len(sess4._steps.graphs),
                         rows_vs_batch1=rows)
    print("windowed_device_batch4", json.dumps(out["batch4"]), flush=True)
    if not all(e <= BATCH_ROWS_TOL * p for e, p in zip(errs, peaks)):
        raise AssertionError(f"batch-4 rows disagree with batch 1: {rows}")
    moved = {c.__name__: c.launches for c in counters if c.launches}
    if moved:
        raise AssertionError(f"the windowed device session launched "
                             f"kernels it does not run: {moved}")
    return out


def windowed_emit_mels(torch, sess, tokens) -> np.ndarray:
    """Every emit mel of ``sess``'s decode of ``tokens`` (B, n), in stream
    order (B, n * ratio, n_mel) f32: each step launched as ``stream_decode``
    launches it, the flow steps' output buffers copied after each (on the
    CPU ``.cpu()`` is the buffer itself, which a later bucket overwrites)."""
    mels, b = [], tokens.shape[0]
    with torch.inference_mode():
        sess._token_buf(tokens)
        sess.init_state()
        for key in sess.dispatches(tokens.shape[1]):
            sess._launch(key)
            if key[0] == "flow":
                mels.append(sess._mels[key[1], key[2]].float().cpu().clone())
            elif key[0] in ("fbatch", "fscan"):
                # (bucket, B, T, D)
                m = sess._mels[key[1]].float().cpu().clone()
                mels.append(m.transpose(0, 1).reshape(b, -1, m.shape[-1]))
    return torch.cat(mels, dim=1).numpy()


def cross_windowed_phase(torch) -> dict:
    """f32 emit mels of the windowed device session over 58 tokens (block
    5, window 40: the first hop, 10 steady windows as batched flow forwards
    in buckets of 4, 4 and 2, the second bucket straddling the point where
    the window fills, the finalize hop) on the card graphed and eager and
    on the CPU, same weights; and on the card a lockstep pair (flow scans)
    whose first row is the same stream."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils.config import PipelineConfig

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(
        flash=False, mid_blocks=CROSS_MID_BLOCKS)
    n_tokens = 58
    tokens = np.random.RandomState(5).randint(0, flow_cfg.vocab_size,
                                              (2, n_tokens))
    mels = {}
    for dev, graphs, batch in (("cuda", True, 1), ("cuda", False, 1),
                               ("cuda", True, 2), ("cpu", True, 1)):
        dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                           PipelineConfig(block_size=5, mel_cache_len=8,
                                          max_token_len=40), device=dev)
        sess = dec.device_stream_decoder(batch=batch, graphs=graphs)
        keys = sess.dispatches(n_tokens)
        kind = "fbatch" if batch == 1 else "fscan"
        if [k for k in keys if k[0] == kind] != [(kind, 4, 5), (kind, 4, 5),
                                                  (kind, 2, 5)]:
            raise AssertionError(f"not the buckets to check: {keys}")
        mels[dev, graphs, batch] = windowed_emit_mels(
            torch, sess, tokens[:batch])
        del sess, dec
    got, want = mels["cuda", True, 1], mels["cpu", True, 1]
    err = float(np.abs(got - want).max())
    graph_err = float(np.abs(got - mels["cuda", False, 1]).max())
    scan_err = float(np.abs(mels["cuda", True, 2][:1] - got).max())
    rec = dict(tokens=n_tokens, mel_shape=list(want.shape),
               mel_max_abs=float(np.abs(want).max()), max_abs_diff=err,
               tol=CROSS_TOL, graphed_vs_eager_max_abs_diff=graph_err,
               graphed_vs_eager_tol=GRAPH_TOL,
               scan_vs_buckets_max_abs_diff=scan_err,
               scan_vs_buckets_tol=CROSS_TOL)
    print("cross_windowed", json.dumps(rec), flush=True)
    if want.shape != (1, n_tokens * flow_cfg.token_mel_ratio,
                      flow_cfg.output_size) or not np.isfinite(got).all() \
            or not np.isfinite(mels["cuda", True, 2]).all() \
            or not err <= CROSS_TOL or not graph_err <= GRAPH_TOL \
            or not scan_err <= CROSS_TOL:
        raise AssertionError(f"card (graphed, eager, lockstep) and CPU "
                             f"windowed mels disagree: {rec}")
    return rec


# --------------------------------------------------------------------------
# lockstep streams, int8 rings, the tokenizer side of the codec
# --------------------------------------------------------------------------

# bench.py --batch's stream count
KV_BATCH = 4
# int8 rings: the mel's rel-L1 against full-precision rings (the bound of
# the JAX package's test_int8_ring_quant_session_and_batcher), and f32 card
# against CPU for the same int8 session (a last-bit difference can move an
# int8 value by one step)
INT8_REL_L1_TOL = 5e-2
INT8_CROSS_REL_L1_TOL = 5e-3
# the tokenizer: token agreement of two paths (streaming and batch; card
# and CPU), and its pooled pre-VQ features card against CPU, relative to
# their peak
TOKEN_AGREEMENT_MIN = 0.99
POOLED_REL_TOL = 1e-4
# the prompt: matcha mel card against CPU, and the CAM++ embedding relative
# to its peak
PROMPT_MEL_TOL = 1e-4
SPK_REL_TOL = 1e-4


def rel_l1(got, want) -> float:
    return float(np.abs(got - want).sum() / np.abs(want).sum())


def seeded_audio(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Speech-like audio from a seed: a harmonic source gliding around
    120 Hz, syllable-rate amplitude, a little noise."""
    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 120.0 + 40.0 * np.sin(2 * np.pi * 0.5 * t + rng.rand())
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * t + rng.rand())
    return (0.1 * env * voiced + 0.01 * rng.randn(n)).astype(np.float32)


def kv_batch_phase(torch, fb) -> dict:
    """``bench.py --batch 4``'s protocol: 4 lockstep streams of 250 seeded
    tokens, block 5, ring 35, bf16, the kernel engine (one
    ``fused_tf_group`` launch a group at 2 * 4 * 10 = 80 rows, shared
    offset), graphed.  ``stream_decode(output="int16")`` 1 warm-up + median
    of 3 with the launches checked (812 a decode), and one eager
    (``graphs=False``) decode; aggregate x-realtime and the per-stream RTF;
    each bf16 row against the batch-1 session on the same tokens within
    ``BATCH_ROWS_TOL`` of the peak; the device memory a stream takes: the
    peak over a decode less what was allocated before the session's first
    decode (its buffers, graph pool and activations; the shared weights
    not), over the streams, beside the batch-1 session's."""
    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(flash=False)
    kv = kv_decoder(flow_cfg, hift_cfg, flow_state, hift_state,
                    KV_TOKENS, compute_dtype=torch.bfloat16)
    b = KV_BATCH
    tokens = np.random.RandomState(4).randint(0, flow_cfg.vocab_size,
                                              (b, KV_TOKENS))
    samples = KV_TOKENS * flow_cfg.token_mel_ratio * hift_cfg.total_upsample
    audio_s = samples / hift_cfg.sampling_rate
    launches = wave_launches(kv, flow_cfg, KV_TOKENS)
    want = {fb.launch_fused_tf_group: launches}
    sessions = {g: kv.dec.kv_stream_decoder(token_cap=KV_TOKENS + 16,
                                            batch=b, graphs=g)
                for g in (True, False)}
    for g, sess in sessions.items():
        if not (sess.b == b and sess._kernel and sess._fused
                and sess._graphs == (g and sess.dev.type == "cuda")
                and sess.ring_tokens == 35):
            raise AssertionError(f"kv_stream_decoder(batch={b}, graphs={g})"
                                 f" did not select the kernel engine")
    def session_bytes(call):
        """(call's result, peak allocation over it less the allocation
        before it, the peak itself)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = call()
        torch.cuda.synchronize()
        top = torch.cuda.max_memory_allocated()
        return got, top - base, top

    (pcm, walls), peak, top = session_bytes(lambda: timed_runs(
        lambda: sessions[True].stream_decode(tokens, output="int16"),
        "kv_batch graphed stream_decode", want))
    fb.launch_fused_tf_group.launches = 0
    t0 = time.perf_counter()
    pcm_eager = sessions[False].stream_decode(tokens, output="int16")
    eager_wall = time.perf_counter() - t0
    got = fb.launch_fused_tf_group.launches
    if got != launches:
        raise AssertionError(f"the eager lockstep decode launched "
                             f"fused_tf_group {got} times, expected "
                             f"{launches}")
    for got in (pcm, pcm_eager):
        if got.shape != (b, samples) or got.dtype != np.int16:
            raise AssertionError(f"bad lockstep int16 output {got.shape}")
    SEEDED["kv_batch"] = (kv.dec, tokens, pcm)     # the spmd and tools
    wav = sessions[True].stream_decode(tokens)
    rows = []
    for i in range(b):
        if i == 0:
            one, peak1, _ = session_bytes(
                lambda: kv.stream_decode(tokens[:1]))
        else:
            one = kv.stream_decode(tokens[i:i + 1])
        peak_abs = float(np.abs(one).max())
        rows.append(dict(max_abs_diff=float(np.abs(wav[i] - one[0]).max()),
                         peak=peak_abs))
        rows[-1]["share_of_peak"] = rows[-1]["max_abs_diff"] / peak_abs
    wall = statistics.median(walls)
    out = dict(streams=b, tokens=KV_TOKENS, audio_s_per_stream=audio_s,
               launches=launches, rows_per_launch=2 * b * kv.s_steps,
               wall_s=walls, median_s=wall, x_realtime=b * audio_s / wall,
               stream_rtf=wall / audio_s, eager_wall_s=eager_wall,
               eager_x_realtime=b * audio_s / eager_wall,
               graphed_vs_eager_equal=bool(np.array_equal(pcm, pcm_eager)),
               rows=rows, rows_tol=BATCH_ROWS_TOL,
               max_memory_allocated_per_stream=top / b,
               session_bytes_per_stream=peak / b,
               session_bytes_batch1=peak1,
               wav_max_abs=float(np.abs(wav).max()))
    print("kv_batch", json.dumps(out), flush=True)
    if not np.isfinite(wav).all() or \
            any(r["share_of_peak"] > BATCH_ROWS_TOL for r in rows):
        raise AssertionError(f"a lockstep row moved from its stream: {out}")
    return out


def kv_quant_phase(torch, fb) -> dict:
    """``kv_stream_decoder(fused=False, ring_quant=True)`` on the KV
    configuration (bf16, block 5, ring 35), 250 tokens, graphed: int8 rings
    on the unfused concat engine, no kernel.  Its RTF (1 warm-up + median
    of 3) beside the same session with full-precision rings; the bytes of
    both rings and conv caches (``est_cache_bytes``); and the rel-L1 of its
    mel against the full-precision session's, which must stay below the
    JAX package's bound."""
    from moss_speech_decoder_cosy_torch.models.flow.kv_stream import (
        est_cache_bytes)
    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(flash=False)
    kv = kv_decoder(flow_cfg, hift_cfg, flow_state, hift_state,
                    KV_TOKENS, compute_dtype=torch.bfloat16)
    tokens = np.random.RandomState(0).randint(0, flow_cfg.vocab_size,
                                              (1, KV_TOKENS))
    samples = KV_TOKENS * flow_cfg.token_mel_ratio * hift_cfg.total_upsample
    audio_s = samples / hift_cfg.sampling_rate
    out = dict(tokens=KV_TOKENS, audio_s=audio_s)
    mels = {}
    for name, kw in (("int8", dict(fused=False, ring_quant=True)),
                     ("bf16", dict(fused=False))):
        sess = kv.dec.kv_stream_decoder(token_cap=KV_TOKENS + 16, **kw)
        if sess._kernel or sess._fused or sess._quant != (name == "int8") \
                or sess._graphs != (sess.dev.type == "cuda"):
            raise AssertionError(f"kv_stream_decoder({kw}) took the wrong "
                                 f"engine")
        wav, walls = timed_runs(lambda: sess.stream_decode(tokens),
                                f"kv_quant {name}",
                                {fb.launch_fused_tf_group: 0})
        cache, _ = sess.init_state()
        mel, _ = sess._flow_mels_wave(sess._token_buf(tokens), cache,
                                      sess.schedule(KV_TOKENS))
        mels[name] = mel.float().cpu().numpy()
        out[name] = dict(wall_s=walls, rtf=statistics.median(walls)
                         / audio_s,
                         est_cache_bytes=est_cache_bytes(sess._ext_g),
                         wav_max_abs=float(np.abs(wav).max()))
        if wav.shape != (1, samples) or not np.isfinite(wav).all():
            raise AssertionError(f"bad {name}-ring output {wav.shape}")
        del sess
    kv.init_state()
    out["default_fused_est_cache_bytes"] = est_cache_bytes(kv._ext_g)
    out["mel_rel_l1"] = rel_l1(mels["int8"], mels["bf16"])
    out["mel_rel_l1_tol"] = INT8_REL_L1_TOL
    out["bytes_ratio"] = (out["int8"]["est_cache_bytes"]
                          / out["bf16"]["est_cache_bytes"])
    print("kv_quant", json.dumps(out), flush=True)
    if not 0 < out["mel_rel_l1"] < INT8_REL_L1_TOL:
        raise AssertionError(f"int8 rings moved the mel: {out}")
    return out


def seeded_codec(torch, device, decoder=None, speaker: bool = False):
    """``SpeechCodec`` at ``glm4_voice_tokenizer_config()`` (full width,
    f32), tokenizer weights from seed 5, and with ``speaker`` a full-width
    CAM++ (BatchNorm running statistics drawn too) from seed 6, on
    ``device``."""
    from moss_speech_decoder_cosy_torch.codec import SpeechCodec
    from moss_speech_decoder_cosy_torch.models.campplus import SpeakerEncoder
    from moss_speech_decoder_cosy_torch.tokenizer import (
        glm4_voice_tokenizer_config)
    cfg = glm4_voice_tokenizer_config()
    states = codec_states(torch)
    spk = (SpeakerEncoder(states[1], device=device) if speaker else None)
    return SpeechCodec(cfg, states[0], decoder, speaker_encoder=spk,
                       device=device)


def codec_states(torch):
    """(tokenizer state, CAM++ state) at full width from seeds 5 and 6,
    drawn once."""
    from moss_speech_decoder_cosy_torch.models.campplus import CAMPPlus
    from moss_speech_decoder_cosy_torch.tokenizer import (
        WhisperVQEncoder, glm4_voice_tokenizer_config)
    from moss_speech_decoder_cosy_torch.weights import seeded_state
    key = ("tok", "spk")
    if key not in SEEDED:
        with torch.device("meta"):
            tok = WhisperVQEncoder(glm4_voice_tokenizer_config())
            cam = CAMPPlus()
        SEEDED[key] = (seeded_state(tok, 5), seeded_state(cam, 6))
    return SEEDED[key]


SEEDED: dict = {}


def expected_tokens(codec, n_samples: int) -> int:
    """Tokens of ``n_samples`` through ``codec.encode``: per segment the
    floor of its mel frames over 8, at least 1."""
    seg, hop = codec.segment_samples, codec.tok_cfg.hop_length
    mel_per_tok = 2 * codec.tok_cfg.pooling_kernel_size
    return sum(max(1, (min(seg, n_samples - s) // hop) // mel_per_tok)
               for s in range(0, n_samples, seg))


def stream_against_batch(torch, codec, wav, seconds: float, batch_runs: int,
                         warm: bool) -> dict:
    """``encode`` (``batch_runs`` timed, the median kept) and
    ``encode_streaming`` in 80 ms chunks (one timed; each after one
    warm-up when ``warm``) on ``wav``: walls, RTFs, each chunk's ms, the
    token count checked, and the share of tokens where the two agree
    (each differing position with the gap between its two nearest
    codes)."""
    if warm:
        codec.encode(wav)
    walls = []
    for _ in range(batch_runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = codec.encode(wav)
        walls.append(time.perf_counter() - t0)
    step = codec.tok_cfg.samples_per_token

    def stream():
        sess = codec.new_encode_session()
        toks, chunk_ms = [], []
        t0 = time.perf_counter()
        for s in range(0, len(wav), step):
            t1 = time.perf_counter()
            toks.extend(sess.push(wav[s: s + step]))
            chunk_ms.append((time.perf_counter() - t1) * 1e3)
        toks.extend(sess.flush())
        return (np.concatenate(toks, axis=1), time.perf_counter() - t0,
                chunk_ms)
    if warm:
        stream()
    streamed, stream_wall, chunk_ms = stream()
    want = expected_tokens(codec, len(wav))
    if streamed.shape != batch.shape or batch.shape != (1, want):
        raise AssertionError(f"token counts differ: batch {batch.shape}, "
                             f"streaming {streamed.shape}, expected {want}")
    differ = np.nonzero(streamed[0] != batch[0])[0]
    gaps = []
    if len(differ):
        pooled = torch.cat([p for _, p in codec.encode_features(wav)], 1)
        with torch.inference_mode():
            x = pooled[0, torch.as_tensor(differ, device=pooled.device)]
            cb = codec.tokenizer.codebook
            d = ((x * x).sum(-1, keepdim=True) + (cb * cb).sum(-1)[None]
                 - 2.0 * x @ cb.t())
            two = torch.topk(d, 2, dim=-1, largest=False).values
        gaps = [dict(position=int(p), batch=int(batch[0, p]),
                     streaming=int(streamed[0, p]),
                     gap=float(g[1] - g[0]))
                for p, g in zip(differ, two.cpu().numpy())]
    return dict(seconds=seconds, tokens=int(batch.shape[1]),
                segments=-(-len(wav) // codec.segment_samples),
                encode_wall_s=walls,
                encode_rtf=statistics.median(walls) / seconds,
                streaming_wall_s=stream_wall,
                streaming_rtf=stream_wall / seconds, chunks=len(chunk_ms),
                chunk_ms_median=statistics.median(chunk_ms),
                chunk_ms_p99=float(np.percentile(chunk_ms, 99)),
                agreement=1.0 - len(differ) / batch.shape[1],
                agreement_min=TOKEN_AGREEMENT_MIN, differing=gaps)


def tokenizer_phase(torch) -> dict:
    """The WhisperVQ tokenizer at full width (16 layers, d 1280, a 16384
    codebook, 1500-slot caches), f32, seeded weights: 20 s of seeded 16 kHz
    audio through ``encode`` (1 warm-up + median of 3) and
    ``encode_streaming`` in 80 ms chunks (1 warm-up, 1 timed), then 35 s
    (a full 30 s segment, whose 3000 mel frames fill the 1500 positions,
    and a 5 s one; each path once): RTFs, each chunk's ms and the share of
    tokens where the two paths agree."""
    codec = seeded_codec(torch, "cuda")
    out = stream_against_batch(torch, codec, seeded_audio(20.0, 16000, 7),
                               20.0, 3, warm=True)
    out["long"] = stream_against_batch(
        torch, codec, seeded_audio(35.0, 16000, 10), 35.0, 1, warm=False)
    out["params"] = sum(p.numel() for p in codec.tokenizer.parameters())
    print("tokenizer", json.dumps(out), flush=True)
    if min(out["agreement"], out["long"]["agreement"]) < TOKEN_AGREEMENT_MIN:
        raise AssertionError(f"streaming and batch tokens disagree: {out}")
    return out


def cross_codec_phase(torch, fa) -> dict:
    """The codec at full width, f32: the card against the port's plain CPU
    path on the same seeded weights.  10 s of audio: the pooled pre-VQ
    features within ``POOLED_REL_TOL`` of their peak and the tokens'
    agreement; a 3 s prompt through ``prepare_prompt``: the matcha mel
    within ``PROMPT_MEL_TOL`` and the CAM++ embedding within
    ``SPK_REL_TOL`` of its peak.  Then one ``convert_voice`` round trip on
    the card (10 s through the tokenizer, then ``token2wav`` of the
    full-width bf16 decoder with flash attention): its wall and RTF, with
    the flash launches checked."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models()
    dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                       compute_dtype=torch.bfloat16)
    codecs = {dev: seeded_codec(torch, dev, dec, speaker=True)
              for dev in ("cuda", "cpu")}
    src = seeded_audio(10.0, 16000, 8)
    feats = {}
    for dev, c in codecs.items():
        segs = c.encode_features(src)
        feats[dev] = [torch.cat([s[j] for s in segs], 1).cpu().numpy()
                      for j in range(2)]
    (ids_g, pooled_g), (ids_c, pooled_c) = feats["cuda"], feats["cpu"]
    pooled_rel = float(np.abs(pooled_g - pooled_c).max()
                       / np.abs(pooled_c).max())
    agree = float((ids_g == ids_c).mean())
    p16 = seeded_audio(3.0, 16000, 9)
    p24 = seeded_audio(3.0, 24000, 9)
    prompts = {dev: c.prepare_prompt(p24, p16) for dev, c in codecs.items()}
    pg, pc = prompts["cuda"], prompts["cpu"]
    mel_err = float(np.abs(pg.feat - pc.feat).max())
    spk_rel = float(np.abs(pg.embedding - pc.embedding).max()
                    / np.abs(pc.embedding).max())
    codec = codecs["cuda"]
    codec.convert_voice(src, pg)                       # warm-up
    tokens = int(ids_g.shape[1])
    per_decode = launches_per_decode(flow_cfg)
    fa.launch_flash_chunk_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav = codec.convert_voice(src, pg)
    wall = time.perf_counter() - t0
    launches = fa.launch_flash_chunk_attention.launches
    audio_s = wav.shape[1] / hift_cfg.sampling_rate
    out = dict(seconds=10.0, tokens=tokens,
               pooled_max_rel_diff=pooled_rel, pooled_tol=POOLED_REL_TOL,
               token_agreement=agree, agreement_min=TOKEN_AGREEMENT_MIN,
               prompt_tokens=int(pg.token.shape[1]),
               prompt_tokens_equal=bool(np.array_equal(pg.token, pc.token)),
               prompt_mel_shape=list(pg.feat.shape),
               prompt_mel_max_abs_diff=mel_err, prompt_mel_tol=PROMPT_MEL_TOL,
               speaker_max_rel_diff=spk_rel, speaker_tol=SPK_REL_TOL,
               convert_voice=dict(wall_s=wall, audio_s=audio_s,
                                  rtf=wall / audio_s,
                                  flash_launches=launches,
                                  wav_max_abs=float(np.abs(wav).max())))
    print("cross_codec", json.dumps(out), flush=True)
    want_shape = (1, tokens * flow_cfg.token_mel_ratio
                  * hift_cfg.total_upsample)
    if not (pooled_rel <= POOLED_REL_TOL and agree >= TOKEN_AGREEMENT_MIN
            and mel_err <= PROMPT_MEL_TOL and spk_rel <= SPK_REL_TOL
            and pg.feat.shape == pc.feat.shape and pg.feat.shape[1] > 0
            and wav.shape == want_shape and np.isfinite(wav).all()
            and launches == per_decode):
        raise AssertionError(f"the codec's card and CPU paths disagree: "
                             f"{out}")
    return out


def cross_kv_batch_phase(fb) -> dict:
    """f32 at full width over 40 tokens: the lockstep pair (``batch=2``,
    per-stream prompt-free streams) on the card graphed against the CPU
    (plain path), mels within ``CROSS_TOL``; each row on the card against
    the batch-1 session on the card, within ``CROSS_TOL``; and the int8
    session (``fused=False, ring_quant=True``) on the card against the CPU,
    mel rel-L1 within ``INT8_CROSS_REL_L1_TOL``."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils.config import PipelineConfig

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(
        flash=False, mid_blocks=CROSS_MID_BLOCKS)
    n_tokens = 40
    tokens = np.random.RandomState(6).randint(0, flow_cfg.vocab_size,
                                              (2, n_tokens))
    mels = {}
    for dev in ("cuda", "cpu"):
        dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                           PipelineConfig(block_size=5, mel_cache_len=8,
                                          max_token_len=40), device=dev)
        runs = [("batch2", dict(batch=2), tokens),
                ("int8", dict(fused=False, ring_quant=True), tokens[:1])]
        if dev == "cuda":
            runs += [(f"row{i}", {}, tokens[i:i + 1]) for i in range(2)]
        for name, kw, toks in runs:
            sess = dec.kv_stream_decoder(token_cap=n_tokens + 16, **kw)
            cache, _ = sess.init_state()
            fb.launch_fused_tf_group.launches = 0
            mel, _ = sess._flow_mels_wave(sess._token_buf(toks), cache,
                                          sess.schedule(n_tokens))
            want = (wave_launches(sess, flow_cfg, n_tokens)
                    if dev == "cuda" and sess._kernel else 0)
            if fb.launch_fused_tf_group.launches != want:
                raise AssertionError(f"{dev} {name} launched fused_tf_group "
                                     f"{fb.launch_fused_tf_group.launches} "
                                     f"times, expected {want}")
            mels[dev, name] = mel.float().cpu().numpy()
            del sess
        del dec
    b2 = mels["cuda", "batch2"]
    out = dict(tokens=n_tokens, mel_shape=list(b2.shape),
               mel_max_abs=float(np.abs(b2).max()),
               batch2_card_vs_cpu=float(np.abs(b2 - mels["cpu", "batch2"])
                                        .max()),
               rows_vs_batch1=[float(np.abs(b2[i] - mels["cuda", f"row{i}"]
                                            [0]).max()) for i in range(2)],
               tol=CROSS_TOL,
               int8_card_vs_cpu_rel_l1=rel_l1(mels["cuda", "int8"],
                                              mels["cpu", "int8"]),
               int8_tol=INT8_CROSS_REL_L1_TOL)
    print("cross_kv_batch", json.dumps(out), flush=True)
    if not (np.isfinite(b2).all() and out["batch2_card_vs_cpu"] <= CROSS_TOL
            and max(out["rows_vs_batch1"]) <= CROSS_TOL
            and out["int8_card_vs_cpu_rel_l1"] <= INT8_CROSS_REL_L1_TOL):
        raise AssertionError(f"lockstep or int8 KV mels disagree: {out}")
    return out


# ------------------------------------------------------------------ serving
SERVE_REQUESTS = 4
# the VC session: a 3 s prompt, 5 s of audio (the smoke's time: a longer
# session measures the same per-frame handler)
VC_PROMPT_S, VC_AUDIO_S = 3.0, 5.0
# the port's plan reshapes, inverted: port layout -> the reference's layout
PLAN_INVERSE = {"g": lambda t: t.reshape(-1, 1, 1),
                "conv1": lambda t: t[..., None]}


def reference_state(kind: str, cfg, state: dict, prefix: str = "") -> dict:
    """A reference-named state dict (what ``flow.pt`` / ``hift.pt`` hold)
    from a port state dict, through the inverse of the port's plan."""
    from moss_speech_decoder_cosy_torch.utils.checkpoint import (
        conversion_plan)
    return {prefix + src: (PLAN_INVERSE[r](state[dst]) if r
                           else state[dst]).contiguous()
            for dst, src, r in conversion_plan(kind, cfg)}


def states_equal(torch, module, want: dict, dtype) -> bool:
    """Every tensor of ``want`` cast to ``dtype`` equals the module's, bit
    for bit (the module holds nothing else)."""
    got = module.state_dict()
    return set(got) == set(want) and all(
        torch.equal(got[k].cpu(), v.to(got[k].dtype)) and
        got[k].dtype == dtype for k, v in want.items())


def graph_ids(b) -> dict:
    return {k: id(g) for k, (g, _) in b._steps.graphs.items()}


class TeeEngine:
    """An ``AudioBatchEngine`` whose streams also keep the float chunks they
    hand to ``decode_stream`` (request i's in ``chunks[i]``)."""

    def __init__(self, engine):
        self.engine, self.decoder, self.chunks = engine, engine.decoder, []

    async def open(self, **kw):
        rec = []
        self.chunks.append(rec)
        stream = await self.engine.open(**kw)

        class Tee:
            push, finish, rid = stream.push, stream.finish, stream.rid

            async def __aiter__(self):
                async for c in stream:
                    rec.append(c)
                    yield c
        return Tee()


async def http_request(engine, params) -> dict:
    """One request through the aiohttp shell (``AudioBatcherHTTPServer``)
    on a localhost socket of a free port and its client: the audio and the
    host wall from the request's start to its end."""
    import socket
    from aiohttp import web
    from moss_speech_decoder_cosy_torch.serving.audio_batcher import (
        AudioBatcherHTTPServer, decode_stream_client)
    runner = web.AppRunner(AudioBatcherHTTPServer(engine).app)
    await runner.setup()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    try:
        await web.SockSite(runner, sock).start()
        url = f"http://127.0.0.1:{sock.getsockname()[1]}/decode_stream"
        t0 = time.perf_counter()
        wav = await decode_stream_client(url, params)
        return dict(wav=wav, done_s=time.perf_counter() - t0)
    finally:
        await runner.cleanup()
        sock.close()


async def timed_request(decode_stream, engine, params) -> dict:
    """One ``decode_stream`` request: status, body, the host walls of its
    first byte and its end from its start, and the seconds its body's
    format encoder took (its ``engine.encode`` spans)."""
    from moss_speech_decoder_cosy_torch.utils.profiling import TELEMETRY
    t0 = time.perf_counter()
    status, headers, body = await decode_stream(engine, params)
    chunks, first = [], None
    async for data in body:
        if first is None:
            first = time.perf_counter() - t0
        chunks.append(data)
    rid = getattr(body, "rid", None)
    encode_s = None if rid is None else sum(
        s.duration_s for s in TELEMETRY.spans("engine.encode")
        if s.rid == rid)
    return dict(status=status, headers=headers, body=b"".join(chunks),
                ttfb_s=first, done_s=time.perf_counter() - t0,
                encode_s=encode_s)


def emitted_samples(dec, n_tokens: int, prompt_tokens: int) -> int:
    """Samples a windowed ``StreamSession`` has given out after
    ``n_tokens`` pushed and no ``finish``: its hops as its ``push`` loop
    takes them, the source cache held back."""
    hop, la = dec.pipe_cfg.block_size, dec.lookahead
    pad = -(-prompt_tokens // hop) * hop - prompt_tokens
    off = 0
    while n_tokens - off >= (hop + pad if off == 0 else hop) + la:
        off += hop + pad if off == 0 else hop
    return (off * dec.ratio * dec.hift_cfg.total_upsample
            - dec.source_cache_len) if off else 0


def serve_phase(torch, fb, device: str = "cuda") -> dict:
    """The serving path at full width through the entry points a server
    calls (``bin/decode_server.py``, ``bin/serve.py``), bf16:

    1. a model directory: ``flow.pt`` and ``hift.pt`` (``generator.``
       prefix) under the reference's key names, written from the seeded
       states through the inverse of the port's plan; ``load_model_dir``
       onto the card in f32 and in bf16, every tensor bit-equal to the
       seeded state (cast), no reference key unused; load seconds, bytes;
    2. ``AudioBatchEngine(md.decoder, n_lanes=4)`` warmed by
       ``boot_warmup_batcher`` (timed), after which the requests capture
       no graph (the same graph objects under the same keys);
    3. ``SERVE_REQUESTS`` concurrent ``decode_stream`` requests of
       ``KV_TOKENS`` tokens, JSON-shaped as the HTTP shell passes them,
       pcm16: each one's time to first byte and to its end, the aggregate
       x-realtime; each body equal, sample for sample, to the
       clip-and-scale of the engine's float chunks for it; 14
       ``fused_tf_group`` launches a tick; with libopus one more request as
       oggopus, read back with ``OggOpusReader`` to the pcm16 length within
       an Opus frame, and its encoding seconds on the event loop; an
       unknown format gives 400;
    4. ``make_vc_handler`` (the full-width codec and the model directory's
       decoder) with a ``VC_PROMPT_S`` s seeded prompt, fed ``VC_AUDIO_S``
       s of seeded audio as pcm16 ``KIND_AUDIO`` frames through a
       ``ChatSession``: each frame's handler ms (median, p99), the handler
       seconds against the audio's, the samples sent back, which must be
       what the tokens the session emitted decode to;
    5. which of libopus, aiohttp, yaml and safetensors the machine has."""
    import asyncio
    import importlib.util
    import tempfile
    from moss_speech_decoder_cosy_torch import native
    from moss_speech_decoder_cosy_torch.eval.audio_io import resample
    from moss_speech_decoder_cosy_torch.model_dir import load_model_dir
    from moss_speech_decoder_cosy_torch.serving import opus, protocol
    from moss_speech_decoder_cosy_torch.serving.audio_batcher import (
        AudioBatchEngine, decode_stream)
    from moss_speech_decoder_cosy_torch.serving.boot import (
        boot_warmup_batcher)
    from moss_speech_decoder_cosy_torch.serving.ogg import OggOpusReader
    from moss_speech_decoder_cosy_torch.serving.web_demo import (
        make_vc_handler)
    from moss_speech_decoder_cosy_torch.serving.ws_server import ChatSession
    from moss_speech_decoder_cosy_torch.utils.device import card_line

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    out = {}
    if not native.available():
        raise AssertionError("the host C++ library (native/) did not build")
    # 1. the model directory
    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(flash=False)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        torch.save(reference_state("flow", flow_cfg, flow_state),
                   f"{tmp}/flow.pt")
        torch.save(reference_state("hift", hift_cfg, hift_state,
                                   "generator."), f"{tmp}/hift.pt")
        write_s = time.perf_counter() - t0
        nbytes = {f: Path(tmp, f).stat().st_size
                  for f in ("flow.pt", "hift.pt")}
        loads = {}
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            sync()
            t0 = time.perf_counter()
            md = load_model_dir(tmp, device=device, verbose=False,
                                compute_dtype=None if name == "f32" else dt)
            sync()
            loads[name] = dict(
                load_s=time.perf_counter() - t0, report=md.report,
                bit_equal=(states_equal(torch, md.decoder.flow, flow_state,
                                        dt)
                           and states_equal(torch, md.decoder.hift,
                                            hift_state, dt)))
            if name == "f32":
                del md
    out["model_dir"] = dict(files_bytes=nbytes, write_s=write_s, **loads)
    print("serve_model_dir", json.dumps(out["model_dir"]), flush=True)
    if not all(v["bit_equal"] and not any(v["report"].values())
               for v in loads.values()):
        raise AssertionError(f"the model directory did not load the "
                             f"seeded weights: {out['model_dir']}")
    dec = md.decoder

    # 2. boot
    engine = AudioBatchEngine(dec, n_lanes=4)
    b = engine.batcher
    if not (b._kernel and b._graphs == (device == "cuda")
            and b.ring_tokens == 35):
        raise AssertionError("the engine's batcher did not take the kernel "
                             "engine and CUDA graphs over a 35-token ring")
    boot_s = boot_warmup_batcher(b, pump_iters=engine.pump_iters,
                                 verbose=False)
    graphs = graph_ids(b)
    out["boot"] = dict(boot_s=boot_s, graph_keys=sorted(map(str, graphs)))
    print("serve_boot", json.dumps(out["boot"]), flush=True)

    # 3. the decode server's core
    rng = np.random.RandomState(21)
    reqs = [json.loads(json.dumps({
        "tokens": rng.randint(0, flow_cfg.vocab_size,
                              (1, KV_TOKENS)).tolist(),
        "embedding": rng.randn(1, flow_cfg.spk_embed_dim).tolist(),
        "format": "pcm16"})) for _ in range(SERVE_REQUESTS)]
    samples = KV_TOKENS * flow_cfg.token_mel_ratio * hift_cfg.total_upsample
    audio_s = samples / hift_cfg.sampling_rate
    groups = 2 + flow_cfg.estimator.num_mid_blocks
    counter = fb.launch_fused_tf_group

    async def serve():
        """Every request of this part on one event loop (the engine's)."""
        tee = TeeEngine(engine)
        counter.launches = 0
        ticks0 = b.ticks
        t0 = time.perf_counter()
        got = await asyncio.gather(*[timed_request(decode_stream, tee, r)
                                     for r in reqs])
        wall = time.perf_counter() - t0
        ticks, launches = b.ticks - ticks0, counter.launches
        og = (await timed_request(decode_stream, engine,
                                  dict(reqs[0], format="oggopus"))
              if opus.available() else None)
        bad = await timed_request(decode_stream, engine,
                                  dict(reqs[0], format="mp3"))
        http = (await http_request(engine, reqs[0])
                if importlib.util.find_spec("aiohttp") else None)
        return got, tee.chunks, wall, ticks, launches, og, bad, http

    got, chunks, wall, ticks, launches, og, bad, http = asyncio.run(serve())
    want_launches = groups * ticks if device == "cuda" else 0
    bodies_equal = []
    for g, rec in zip(got, chunks):
        pcm = np.frombuffer(g["body"], "<i2")
        want = (np.clip(np.concatenate(rec, axis=1)[0], -1.0, 1.0)
                * 32767.0).astype("<i2")
        bodies_equal.append(bool(g["status"] == 200 and
                                 pcm.shape == (samples,) and
                                 np.array_equal(pcm, want)))
    dec_rec = dict(
        requests=SERVE_REQUESTS, tokens=KV_TOKENS, audio_s=audio_s,
        wall_s=wall, aggregate_x_realtime=SERVE_REQUESTS * audio_s / wall,
        ttfb_s=[g["ttfb_s"] for g in got], done_s=[g["done_s"] for g in got],
        pcm16_encode_s=[g["encode_s"] for g in got], ticks=ticks,
        fused_tf_group_launches=launches, expected_launches=want_launches,
        bodies_equal_engine_chunks=bodies_equal,
        no_new_graphs=graph_ids(b) == graphs)
    print("serve_decode_stream", json.dumps(dec_rec), flush=True)
    if not (all(bodies_equal) and launches == want_launches and ticks > 0
            and dec_rec["no_new_graphs"]):
        raise AssertionError(f"the decode server's core failed: {dec_rec}")
    out["decode_stream"] = dec_rec

    if og is not None:
        pcm = OggOpusReader(hift_cfg.sampling_rate).decode(og["body"])
        frame = hift_cfg.sampling_rate * 20 // 1000
        opus_rec = dict(status=og["status"], bytes=len(og["body"]),
                        samples=int(pcm.shape[0]), pcm16_samples=samples,
                        encode_s=og["encode_s"], done_s=og["done_s"],
                        encode_share=og["encode_s"] / og["done_s"])
        print("serve_oggopus", json.dumps(opus_rec), flush=True)
        if not (og["status"] == 200 and abs(pcm.shape[0] - samples) <= frame
                and np.isfinite(pcm).all()):
            raise AssertionError(f"the oggopus body is wrong: {opus_rec}")
        out["oggopus"] = opus_rec
    else:
        print("serve_oggopus skipped: libopus is not installed on this "
              "machine", flush=True)
        out["oggopus"] = None
    if bad["status"] != 400:
        raise AssertionError(f"an unknown format gave {bad['status']}")
    if http is not None:
        # the same request as the first one, alone, over HTTP; the client
        # reads int16 / 32767
        core = np.frombuffer(got[0]["body"], "<i2").astype(np.int32)
        pcm = np.rint(http["wav"][0] * 32767.0).astype(np.int32)
        http_rec = dict(done_s=http["done_s"], samples=int(pcm.shape[0]),
                        max_lsb_diff_vs_core=(int(np.abs(pcm - core).max())
                                              if pcm.shape == core.shape
                                              else None))
        print("serve_http", json.dumps(http_rec), flush=True)
        if pcm.shape != core.shape:
            raise AssertionError(f"the HTTP body is wrong: {http_rec}")
        out["http"] = http_rec
    else:
        print("serve_http skipped: aiohttp is not installed on this "
              "machine", flush=True)
        out["http"] = None
    out["unknown_format_status"] = bad["status"]
    out["no_new_graphs_after_all"] = graph_ids(b) == graphs
    if not out["no_new_graphs_after_all"]:
        raise AssertionError("a request after the boot captured a graph")
    del engine, b

    # 4. the voice-conversion websocket core
    codec = seeded_codec(torch, device, dec, speaker=True)
    p16 = seeded_audio(VC_PROMPT_S, 16000, 22)
    prompt = codec.prepare_prompt(resample(p16, 16000, 24000), p16)
    emitted = []

    class Recording:
        decoder = codec.decoder

        @staticmethod
        def new_encode_session():
            sess = codec.new_encode_session()

            class Session:
                @staticmethod
                def push(wav):
                    toks = sess.push(wav)
                    emitted.extend(toks)
                    return toks
            return Session()

    handler = make_vc_handler(Recording, prompt)
    session = ChatSession(handler, codec="pcm16")
    wav = seeded_audio(VC_AUDIO_S, protocol.SAMPLE_RATE, 23)

    async def feed():
        """Frame by frame; also whether each frame's handler gave audio (a
        decoded hop) or none (the tokenizer's step alone)."""
        replies, hop_frames = [], []
        for i in range(0, len(wav), protocol.FRAME_SAMPLES):
            got = await session.feed(protocol.frame_message(
                protocol.KIND_AUDIO, protocol.pcm16_encode(
                    wav[i:i + protocol.FRAME_SAMPLES])))
            hop_frames.append(bool(got))
            replies += got
        return replies, hop_frames

    replies, hop_frames = asyncio.run(feed())
    sent = sum(len(protocol.pcm16_decode(protocol.parse_message(r)[1]))
               for r in replies)
    n_tok = int(sum(t.shape[-1] for t in emitted))
    want_sent = emitted_samples(dec, n_tok, int(prompt.token.shape[1]))
    ms = session.handler_ms
    vc = dict(frames=len(ms), audio_s=VC_AUDIO_S,
              prompt_tokens=int(prompt.token.shape[1]), tokens=n_tok,
              handler_ms_median=statistics.median(ms),
              handler_ms_p99=float(np.percentile(ms, 99)),
              handler_ms_max=max(ms), handler_s=sum(ms) / 1e3,
              hop_frames=sum(hop_frames),
              hop_frame_ms_median=statistics.median(
                  [m for m, h in zip(ms, hop_frames) if h] or [0.0]),
              other_frame_ms_median=statistics.median(
                  [m for m, h in zip(ms, hop_frames) if not h] or [0.0]),
              handler_rtf=sum(ms) / 1e3 / VC_AUDIO_S,
              samples_sent=sent, samples_expected=want_sent)
    print("serve_vc", json.dumps(vc), flush=True)
    if not (len(ms) == len(wav) // protocol.FRAME_SAMPLES and n_tok > 0
            and sent == want_sent > 0):
        raise AssertionError(f"the voice-conversion session failed: {vc}")
    out["vc"] = vc

    # 5. the machine
    env = {m: importlib.util.find_spec(m) is not None
           for m in ("aiohttp", "yaml", "safetensors")}
    env["libopus"] = opus.available()
    env["native"] = True
    card = card_line() if device == "cuda" else "cpu"
    out["env"] = dict(card=card, **env)
    print(f"serve_env {card}: " + ", ".join(
        f"{k} {'present' if v else 'missing'}" for k, v in env.items()),
        flush=True)
    return out


# ---------------------------------------------------------------- speech LM
LM_TOKENS = 250          # 10 s of speech at 25 Hz
LM_TEXT = 60
LM_SLOTS = 4
LM_RATE = 25.0           # CosyVoice2's speech tokens per second
LM_CROSS_TOL = 1e-3      # card vs CPU f32 logits, share of the peak
LM_CROSS_LAYERS = 4
LM_CROSS_STEPS = 32
# the batcher's two-tier cache: a 64-slot recent ring, flushed every chunk
# of 16 steps that would fill it
LM_RECENT = 64


def seeded_lm(torch, cfg, seed: int, device: str, dtype):
    """``Qwen2SpeechLM(cfg)`` with weights drawn from ``seed`` (the released
    ``llm.pt`` is not in the repo) on ``device`` in ``dtype``; the state is
    drawn once a (config, seed) and copied."""
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        Qwen2SpeechLM, load_lm)
    from moss_speech_decoder_cosy_torch.weights import seeded_state

    key = ("lm", cfg, seed)
    if key not in SEEDED:
        with torch.device("meta"):
            lm = Qwen2SpeechLM(cfg)
        SEEDED[key] = seeded_state(lm, seed)
    return load_lm(Qwen2SpeechLM, cfg, {k: v.clone() for k, v in
                                        SEEDED[key].items()}, device, dtype)


def lm_step_bound_ms(lm, positions: int, elem: int = 2):
    """Least time of one decode step: the bytes it must move (every weight
    of the 24 layers, the final norm and the speech head read once, one
    speech-embedding row, the K/V of the ``positions`` it attends read and
    one K/V row written) over the HBM rate, against 2 flops a weight plus
    the attention's 4 x positions x heads x head_dim a layer over the bf16
    peak."""
    from moss_speech_decoder_cosy_torch.utils.flops import (
        PEAK_BYTES, PEAK_FLOPS)
    c = lm.cfg.backbone
    weights = sum(p.numel() for n, p in lm.named_parameters()
                  if n.startswith(("llm.layers_", "llm.norm",
                                   "llm_decoder")))
    kv_row = c.num_layers * 2 * c.num_kv_heads * c.head_dim
    nbytes = (weights + c.hidden_size + kv_row * (positions + 1)) * elem
    flops = 2 * weights + 4 * positions * c.num_heads * c.head_dim \
        * c.num_layers
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS["bfloat16"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations"), weights


def lm_phase(torch, fa) -> dict:
    """The speech LM at CosyVoice2-0.5B width, bf16, seeded weights:
    ``generate`` graphed and eager, the continuous batcher, the
    synthesizer end to end (flash launches on its ``token2wav``),
    ``tts_stream`` and the chat audio consumer."""
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        SpeechLMConfig)
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.serving.lm_server import (
        ContinuousBatcher)
    from moss_speech_decoder_cosy_torch.serving.token_server import (
        ChatAudioConsumer)
    from moss_speech_decoder_cosy_torch.synthesizer import SpeechSynthesizer
    from moss_speech_decoder_cosy_torch.utils import config as C
    from moss_speech_decoder_cosy_torch.weights import seeded_states

    n = LM_TOKENS
    audio_s = n / LM_RATE
    cfg = SpeechLMConfig()
    t0 = time.perf_counter()
    lm = seeded_lm(torch, cfg, 10, "cuda", torch.bfloat16)
    load_s = time.perf_counter() - t0
    rng = np.random.RandomState(2)
    none = np.zeros((1, 0), np.int64)
    text = rng.randint(0, cfg.backbone.vocab_size, (1, LM_TEXT))
    emb = lm.prompt_embeds(text, none)

    def gen(graphs, seed=3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks, count = lm.generate(emb, seed, n, n, graphs=graphs)
        wall = time.perf_counter() - t
        if count != n:
            raise AssertionError(f"generate gave {count} tokens, not {n}")
        return toks.cpu().numpy(), wall

    first, capture_s = gen(True)
    runner = lm.graphs()
    graph = dict(runner.graphs)
    graphed = [gen(True) for _ in range(3)]
    eager = gen(False)
    if set(graph) != {("gen", 16)} or any(
            runner.graphs[k] is not graph[k] for k in graph):
        raise AssertionError(f"generate's graphs {sorted(runner.graphs)}")
    for toks, _ in graphed + [eager]:
        if not np.array_equal(toks, first):
            raise AssertionError("graphed and eager generate disagree")
    if not ((first >= 0) & (first < cfg.speech_token_size)).all():
        raise AssertionError("generate emitted a special token")
    wall = statistics.median(w for _, w in graphed)
    prof = host_launches(torch, lambda: lm.generate(emb, 3, n, n))
    st = lm.decode_state(1)
    prefill = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            lm.admit(st, 0, emb, 3, n, n)
        torch.cuda.synchronize()
        prefill.append(time.perf_counter() - t)
    prefill_s = statistics.median(prefill)
    bounds = [lm_step_bound_ms(lm, emb.shape[1] + i) for i in range(n - 1)]
    bound_ms = float(np.mean([b[0] for b in bounds]))
    static_ms = lm_step_bound_ms(lm, cfg.backbone.max_seq_len)[0]
    step_ms = (wall - prefill_s) / (n - 1) * 1e3
    gen_rec = dict(
        tokens=n, text=LM_TEXT, params=sum(p.numel() for p in lm.parameters()),
        weights_a_step=bounds[0][2], load_s=load_s, capture_s=capture_s,
        graphed_s=[w for _, w in graphed], median_s=wall, eager_s=eager[1],
        prefill_s=prefill_s, ms_per_token=wall / n * 1e3,
        decode_ms_per_token=step_ms,
        eager_ms_per_token=eager[1] / n * 1e3, tokens_per_s=n / wall,
        eager_tokens_per_s=n / eager[1], rtf=wall / audio_s,
        eager_rtf=eager[1] / audio_s, bound_ms_per_token=bound_ms,
        bound_by=bounds[0][1], bound_static_cache_ms=static_ms,
        graph_keys=[list(k) for k in graph], graphed_equals_eager=True,
        kernels_per_token=prof["kernels_run"] / n,
        device_ms_per_token=prof["device_s"] / n * 1e3,
        profiled=prof)
    print("lm generate", json.dumps(gen_rec), flush=True)

    # the continuous batcher: texts of 125 ids (min_len 250 at ratio 2)
    texts = [rng.randint(0, cfg.backbone.vocab_size, n // 2)
             for _ in range(LM_SLOTS)]
    seeds = [11, 12, 13, 14]
    want = []
    for s, tx in zip(seeds, texts):
        toks, count = lm.generate(lm.prompt_embeds(tx[None], none), s, n, n)
        want.append(toks[:count].cpu().numpy().tolist())

    def serve(b, check=True):
        """Wall of the four requests; with ``check`` each stream must equal
        ``generate``'s, else returns (wall, [stream i equal])."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids = []
        for s, tx in zip(seeds, texts):          # one step apart
            ids.append(b.submit(tx, seed=s, max_len=n))
            b.step()
        b.run_all()
        wall = time.perf_counter() - t
        got = [b.result(q) for q in ids]
        if not check:
            return wall, [g == w for g, w in zip(got, want)]
        if got != want:
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise AssertionError(f"batcher streams {bad} differ from "
                                 f"generate with their seeds")
        return wall

    bat = ContinuousBatcher(lm, slots=LM_SLOTS, step_chunk=16,
                            text_buckets=(n // 2,))
    bat_warm = serve(bat)
    bat_walls = [serve(bat) for _ in range(2)]
    bat_eager = serve(ContinuousBatcher(lm, slots=LM_SLOTS, step_chunk=16,
                                        text_buckets=(n // 2,),
                                        graphs=False))
    bwall = statistics.median(bat_walls)
    # the two-tier ``recent`` cache, the same requests and seeds, graphed:
    # a warm-up, then two runs in turns with the single-tier batcher
    two = ContinuousBatcher(lm, slots=LM_SLOTS, step_chunk=16,
                            text_buckets=(n // 2,), recent=LM_RECENT)
    serve(two, check=False)
    turns = {0: [], LM_RECENT: []}
    for _ in range(2):
        turns[0].append(serve(bat))
        wall2, equal2 = serve(two, check=False)
        turns[LM_RECENT].append(wall2)
    recent_rec = {
        str(r): dict(graphed_s=w, tokens_per_s=LM_SLOTS * n
                     / statistics.median(w),
                     equal_to_generate=([True] * LM_SLOTS if r == 0
                                        else equal2))
        for r, w in turns.items()}
    bat_rec = dict(slots=LM_SLOTS, tokens_each=n, warm_s=bat_warm,
                   graphed_s=bat_walls, eager_s=bat_eager,
                   tokens_per_s=LM_SLOTS * n / bwall,
                   eager_tokens_per_s=LM_SLOTS * n / bat_eager,
                   graph_keys=[list(k) for k in bat.steps.graphs],
                   equal_to_generate=True, recent=recent_rec)
    print("lm batcher", json.dumps(bat_rec), flush=True)

    # text -> tokens -> waveform at CosyVoice2 width, flash on
    flow_cfg = C.cosyvoice2_flow_config()
    flow_cfg = dataclasses.replace(flow_cfg, estimator=dataclasses.replace(
        flow_cfg.estimator, use_flash_attention=True))
    hift_cfg = C.HiFTConfig()
    dec = AudioDecoder(flow_cfg, hift_cfg,
                       *seeded_states(flow_cfg, hift_cfg, 0),
                       compute_dtype=torch.bfloat16)
    # the batcher's first text and seed: 125 ids give min_len 250
    synth = SpeechSynthesizer(lm, dec, max_tokens=n)
    counter = fa.launch_flash_chunk_attention
    samples = n * flow_cfg.token_mel_ratio * hift_cfg.total_upsample
    tts_text = texts[0][None]
    synth.tts(tts_text, seed=seeds[0])              # warm-up
    torch.cuda.synchronize()
    counter.launches = 0
    t = time.perf_counter()
    wav = synth.tts(tts_text, seed=seeds[0])
    tts_s = time.perf_counter() - t
    flash = counter.launches
    t = time.perf_counter()
    tokens = synth.generate_tokens(tts_text, seed=seeds[0])
    lm_s = time.perf_counter() - t
    t = time.perf_counter()
    wav2 = dec.token2wav(tokens)
    dec_s = time.perf_counter() - t
    if flash != launches_per_decode(flow_cfg) or \
            tokens[0].tolist() != want[0]:
        raise AssertionError(f"tts launched flash {flash} times, expected "
                             f"{launches_per_decode(flow_cfg)}, or its "
                             f"tokens are not generate's")
    for w in (wav, wav2):
        if w.shape != (1, samples) or not np.isfinite(w).all():
            raise AssertionError(f"bad tts output {w.shape}")
    # a 25-id text: min_len 50 tokens (the stream's hops, within the
    # smoke's time)
    stream_n = 50
    short = SpeechSynthesizer(lm, dec, max_tokens=stream_n)
    counter.launches = 0
    t = time.perf_counter()
    chunks = list(short.tts_stream(texts[1][None, :stream_n // 2],
                                   seed=seeds[1]))
    stream_s = time.perf_counter() - t
    stream_wav = np.concatenate(chunks, axis=-1)
    stream_samples = (stream_n * flow_cfg.token_mel_ratio
                      * hift_cfg.total_upsample)
    if stream_wav.shape != (1, stream_samples) or \
            not np.isfinite(stream_wav).all() or counter.launches == 0:
        raise AssertionError(f"bad tts_stream {stream_wav.shape}, "
                             f"{counter.launches} flash launches")
    tts_rec = dict(
        tokens=n, audio_s=audio_s, samples=samples, tts_s=tts_s,
        rtf=tts_s / audio_s, lm_s=lm_s, decoder_s=dec_s,
        lm_share=lm_s / (lm_s + dec_s), flash_launches=flash,
        stream_tokens=stream_n, stream_chunks=len(chunks),
        stream_s=stream_s, stream_rtf=stream_s / (stream_n / LM_RATE),
        stream_flash_launches=counter.launches,
        wav_max_abs=float(np.abs(wav).max()))
    print("lm tts", json.dumps(tts_rec), flush=True)

    # the chat consumer over an interleaved stream (13 text : 26 audio)
    offset = cfg.backbone.vocab_size
    ids, audio = [], list(tokens[0])
    while audio:
        ids += list(rng.randint(0, offset, 13))
        ids += [offset + int(a) for a in audio[:26]]
        audio = audio[26:]
    consumer = ChatAudioConsumer(dec, audio_offset=offset)
    t = time.perf_counter()
    for i in ids:
        consumer.push(int(i))
    chat = consumer.finish()
    chat_s = time.perf_counter() - t
    blocks = [c.shape[1] // (flow_cfg.token_mel_ratio
                             * hift_cfg.total_upsample)
              for c in consumer.wav_chunks]
    if chat.shape != (1, samples) or not np.isfinite(chat).all() or \
            blocks != [25, 50, 100, 75]:
        raise AssertionError(f"bad chat audio {chat.shape}, blocks {blocks}")
    chat_rec = dict(ids=len(ids), audio_ids=n, blocks=blocks,
                    samples=chat.shape[1],
                    seconds=chat.shape[1] / hift_cfg.sampling_rate,
                    wall_s=chat_s)
    print("lm chat", json.dumps(chat_rec), flush=True)
    return dict(generate=gen_rec, batcher=bat_rec, tts=tts_rec,
                chat=chat_rec)


def cross_lm_phase(torch) -> dict:
    """f32 teacher-forced logits of the full-width LM cut to 4 layers,
    through the slot path ``generate`` and the batcher run (prefill, then
    32 decode steps on seeded speech tokens), card against CPU."""
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        SpeechLMConfig)
    from moss_speech_decoder_cosy_torch.models.llm.qwen2 import Qwen2Config

    cfg = SpeechLMConfig(backbone=dataclasses.replace(
        Qwen2Config(), num_layers=LM_CROSS_LAYERS))
    rng = np.random.RandomState(4)
    text = rng.randint(0, cfg.backbone.vocab_size, (1, LM_TEXT))
    teacher = rng.randint(0, cfg.speech_token_size, LM_CROSS_STEPS)
    logits = {}
    for dev in ("cuda", "cpu"):
        lm = seeded_lm(torch, cfg, 11, dev, torch.float32)
        with torch.inference_mode():
            emb = lm.prompt_embeds(text, np.zeros((1, 0), np.int64))
            cache = lm.llm.init_slot_cache(1)
            h, _ = lm.llm.prefill_slot(cache, 0, emb, emb.shape[1])
            rows = [lm.head(h)]
            for tok in teacher:
                e = lm.speech_embedding(torch.tensor([[int(tok)]],
                                                     device=lm.device))
                h, _ = lm.llm.decode_step_slots(e, cache)
                rows.append(lm.head(h))
            logits[dev] = torch.cat(rows).float().cpu().numpy()
        del lm
    got, want = logits["cuda"], logits["cpu"]
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    rec = dict(layers=LM_CROSS_LAYERS, steps=LM_CROSS_STEPS,
               shape=list(want.shape), peak=peak, max_abs_diff=err,
               rel=err / peak, tol=LM_CROSS_TOL,
               argmax_equal=float((got.argmax(-1) == want.argmax(-1)).mean()))
    print("cross_lm", json.dumps(rec), flush=True)
    if not np.isfinite(got).all() or not err <= LM_CROSS_TOL * peak:
        raise AssertionError(f"card and CPU LM logits disagree: {rec}")
    return rec


def seeded_v1(flash: bool = True):
    """(flow_cfg, hift_cfg, flow_state, hift_state): the CosyVoice-v1
    presets (``cosyvoice1_flow_config()``, with the flash kernel, and
    ``cosyvoice1_hift_config()``), weights from seeds 20 and 21."""
    from moss_speech_decoder_cosy_torch.utils import config as C
    from moss_speech_decoder_cosy_torch.weights import seeded_states

    flow_cfg = C.cosyvoice1_flow_config()
    flow_cfg = dataclasses.replace(flow_cfg, estimator=dataclasses.replace(
        flow_cfg.estimator, use_flash_attention=flash))
    hift_cfg = C.cosyvoice1_hift_config()
    return (flow_cfg, hift_cfg) + seeded_states(flow_cfg, hift_cfg, seed=20,
                                                v1=True)


def v1_inputs(flow_cfg, n_tokens: int, n_prompt: int, n_frames: int,
              seed: int):
    """Seeded target tokens (1, n_tokens) and a prompt: tokens, a mel of
    ``n_frames`` frames and an x-vector."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, flow_cfg.vocab_size, (1, n_tokens)),
            (rng.randint(0, flow_cfg.vocab_size, (1, n_prompt)),
             (rng.randn(1, n_frames, flow_cfg.output_size) * 0.5
              ).astype(np.float32),
             rng.randn(1, flow_cfg.spk_embed_dim).astype(np.float32)))


def v1_phase(torch, fa) -> dict:
    """The CosyVoice-v1 / stock GLM-4-Voice 22.05 kHz decoder at full width
    through the port's entry points, f32 (the JAX v1 stack's only dtype),
    seeded weights, 500 tokens (10 s) behind a 3 s prompt:

    1. ``V1Decoder.token2wav``: 1 warm-up + median of 3, exactly 640 flash
       launches a call (64 attention blocks x 10 Euler steps), a wav of 256
       x 861 samples; the same in bf16 (the flow cast, HiFT f32) beside it;
       one profiled f32 call (device time, busy share, top kernels);
    2. ``stream_inference``: 1 warm-up + median of 3, exactly 5 flow calls
       (windows of 120 tokens at the 100-token hop, the last 100) and 3,200
       launches; a new session fed one token at a time: the wall from the
       120th token to the first chunk;
    3. a model directory (``flow.pt``, ``hift.pt`` under the reference's v1
       key names) through ``load_model_dir(flow_version="v1")``, bit-equal
       to the seeded states, no reference key unused;
    4. ``bin/inference.py --flow_version v1 --mode decode`` on it, once."""
    import tempfile
    from moss_speech_decoder_cosy_torch.bin import inference as cli
    from moss_speech_decoder_cosy_torch.eval.audio_io import read_wav
    from moss_speech_decoder_cosy_torch.model_dir import (V1Decoder,
                                                          load_model_dir)

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_v1()
    tokens, prompt = v1_inputs(flow_cfg, V1_TOKENS, V1_PROMPT_TOKENS,
                               V1_PROMPT_FRAMES, 23)
    audio_s = V1_TOKENS / V1_RATE
    counter = fa.launch_flash_chunk_attention
    per_call = launches_per_decode(flow_cfg)
    if per_call != 640:
        raise AssertionError(f"the v1 U-Net has {per_call} attention calls "
                             f"a flow call, not 640")
    out = dict(tokens=V1_TOKENS, prompt_tokens=V1_PROMPT_TOKENS,
               prompt_frames=V1_PROMPT_FRAMES, audio_s=audio_s,
               launches_per_flow_call=per_call)
    for name, dt in (("f32", None), ("bf16", torch.bfloat16)):
        dec = V1Decoder(flow_cfg, hift_cfg, flow_state, hift_state,
                        compute_dtype=dt)
        n_mel = dec.mel_len(V1_TOKENS)           # 861 for 500 tokens
        wav, walls = timed_runs(lambda: dec.token2wav(tokens, *prompt),
                                f"v1 token2wav {name}", {counter: per_call})
        if n_mel != int(V1_TOKENS / flow_cfg.input_frame_rate * 22050
                        / 256) or \
                wav.shape != (1, 256 * n_mel) or \
                not np.isfinite(wav).all() or \
                np.abs(wav).max() > hift_cfg.audio_limit:
            raise AssertionError(f"bad v1 token2wav {name}: {wav.shape}, "
                                 f"{n_mel} frames")
        out[name] = dict(wall_s=walls, median_s=statistics.median(walls),
                         rtf=statistics.median(walls) / audio_s,
                         launches=per_call, samples=wav.shape[1],
                         mel_frames=n_mel,
                         wav_max_abs=float(np.abs(wav).max()))
        if name == "f32":
            prof = host_launches(
                torch, lambda: dec.token2wav(tokens, *prompt))
            out["profiled"] = {k: v for k, v in prof.items()
                               if k != "fused_tf_group_device_s"}
            f32_dec = dec
        else:
            del dec
    dec = f32_dec

    # streaming: windows of a 100-token hop + 20 of overlap, then the rest
    # (500 tokens: 120, 120, 120, 120, 100)
    want_windows, left = [], V1_TOKENS
    while left >= 120:
        want_windows.append(120)
        left -= 100
    want_windows.append(left)
    stream_launches = per_call * len(want_windows)
    # each window's mel less the 34-frame overlap it hands to the next one
    # (860 frames for 500 tokens, one fewer than the offline decode's 861)
    stream_frames = sum(dec.mel_len(w) for w in want_windows) - \
        int(20 / flow_cfg.input_frame_rate * 22050 / 256) * (
            len(want_windows) - 1)
    swav, swalls = timed_runs(
        lambda: dec.stream_inference(tokens, *prompt), "v1 stream_inference",
        {counter: stream_launches})
    sess = dec.new_session(*prompt)
    first_s, first_at, chunks = None, None, []
    for i, tok in enumerate(tokens[0]):
        t0 = time.perf_counter()
        got = sess.push_tokens([tok])
        if got and first_s is None:
            first_s = time.perf_counter() - t0
            first_at = i + 1
        chunks += got
    chunks.append(sess.finalize())
    # the same windows and steps: bit for bit
    fed_equal = np.array_equal(np.concatenate(chunks)[None], swav)
    if sess.windows != want_windows or first_at != 120 or \
            swav.shape != (1, 256 * stream_frames) or \
            not np.isfinite(swav).all() or not fed_equal:
        raise AssertionError(f"bad v1 stream: windows {sess.windows}, first "
                             f"chunk at token {first_at}, {swav.shape}, the "
                             f"token-at-a-time feed equal: {fed_equal}")
    out["stream"] = dict(
        windows=sess.windows, flow_calls=len(sess.windows),
        launches=stream_launches, wall_s=swalls,
        median_s=statistics.median(swalls),
        rtf=statistics.median(swalls) / audio_s,
        first_chunk_token=first_at, first_chunk_s=first_s,
        fed_one_token_at_a_time_equal=True,
        samples=int(swav.shape[1]), mel_frames=stream_frames,
        first_chunk_samples=int(chunks[0].shape[0]))
    if not out["stream"]["rtf"] < 1:
        raise AssertionError(f"v1 streaming slower than real time: "
                             f"{out['stream']}")

    # the model directory and the CLI
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(reference_state("flow_v1", flow_cfg, flow_state),
                   f"{tmp}/flow.pt")
        torch.save(reference_state("hift", hift_cfg, hift_state,
                                   "generator."), f"{tmp}/hift.pt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        md = load_model_dir(tmp, flow_version="v1", verbose=False)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        equal = (states_equal(torch, md.decoder.flow, flow_state,
                              torch.float32)
                 and states_equal(torch, md.decoder.hift, hift_state,
                                  torch.float32))
        if not equal or md.report != {"flow_unused": 0, "hift_unused": 0} \
                or md.flow_version != "v1" or \
                not isinstance(md.decoder, V1Decoder):
            raise AssertionError(f"v1 model directory: bit_equal={equal}, "
                                 f"report {md.report}")
        del md
        np.save(f"{tmp}/tokens.npy", tokens[0, :100])
        t0 = time.perf_counter()
        cli.main(["--mode", "decode", "--flow_version", "v1", "--model_dir",
                  tmp, "--input", f"{tmp}/tokens.npy", "--output",
                  f"{tmp}/out.wav"])
        cli_s = time.perf_counter() - t0
        cwav, sr = read_wav(f"{tmp}/out.wav")
        if sr != 22050 or cwav.shape[-1] != 256 * dec.mel_len(100):
            raise AssertionError(f"bad v1 CLI wav: {cwav.shape} at {sr}")
    out["model_dir"] = dict(load_s=load_s, bit_equal=True, report={
        "flow_unused": 0, "hift_unused": 0})
    out["cli"] = dict(tokens=100, wall_s=cli_s, samples=int(cwav.shape[-1]),
                      sample_rate=sr)
    print("v1", json.dumps(out), flush=True)
    return out


def cross_v1_phase(torch, card: str = "cuda") -> dict:
    """The v1 stack in f32, card (flash kernel) against CPU (its plain
    version), the same seeded weights:

    - the flow mel over 60 tokens behind a 20-token prompt (within
      ``CROSS_TOL``, max abs);
    - every chunk mel of one ``StreamSessionV1`` over 150 tokens behind
      the same prompt (windows of 120 and 50 tokens; ``CROSS_TOL``);
    - the 22.05 kHz NSF source over 1 s of a seeded f0 track, the same
      draws (``V1_SOURCE_TOL``), and its phase scan's drift from a float64
      sum (reported): f32 ``cumsum`` over the strided time axis and over a
      contiguous one on the card, and on the CPU;
    - one ``DiTConditionalCFM`` solve at ``DiTConfig()`` over 200 frames,
      weights from seed 24 (``CROSS_TOL`` x max(1, peak))."""
    from moss_speech_decoder_cosy_torch.model_dir import V1Decoder
    from moss_speech_decoder_cosy_torch.models.flow.dit import (
        DiTConditionalCFM, DiTConfig)
    from moss_speech_decoder_cosy_torch.models.hift.generator import (
        seeded_phase_draws)
    from moss_speech_decoder_cosy_torch.utils.config import CFMConfig
    from moss_speech_decoder_cosy_torch.weights import seeded_state

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_v1()
    tokens, prompt = v1_inputs(flow_cfg, 150, 20, 34, 25)
    rng = np.random.RandomState(26)
    f0 = np.repeat(rng.choice([0.0, 0.0, 90.0, 150.0, 220.0, 310.0, 420.0],
                              87), 256)[:22050]
    f0 = f0[None, :, None].astype(np.float32)
    draws = seeded_phase_draws(hift_cfg.nb_harmonics + 1, 22050, "cpu")
    dit_cfg = DiTConfig()
    with torch.device("meta"):
        dit = DiTConditionalCFM(CFMConfig(), dit_cfg)
    dit_state = seeded_state(dit, 24)
    mu = (rng.randn(1, 200, dit_cfg.io_channels) * 0.5).astype(np.float32)
    spks = rng.randn(1, dit_cfg.spk_embed_dim).astype(np.float32)
    res = {}
    for key, dev in (("cuda", card), ("cpu", "cpu")):
        dec = V1Decoder(flow_cfg, hift_cfg, flow_state, hift_state,
                        device=dev)
        offline = dec.flow_mel(tokens[:, :60], *prompt).cpu().numpy()
        sess = dec.new_session(*prompt)
        mels, flow = [], sess._flow
        sess._flow = lambda t: mels.append(flow(t)) or mels[-1]
        sess.push_tokens(tokens[0])
        sess.finalize()
        with torch.inference_mode():
            src = dec.hift.m_source(
                torch.from_numpy(f0).to(dev),
                *(d.to(dev) for d in draws)).cpu().numpy()
            cfm = DiTConditionalCFM(CFMConfig(), dit_cfg)
            cfm.load_state_dict(dit_state, strict=True)
            cfm = cfm.to(dev).eval()
            t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            dmel = cfm(t(mu), torch.ones(1, 200, dtype=torch.bool,
                                         device=dev), t(spks),
                       torch.zeros_like(t(mu))).cpu().numpy()
        res[key] = dict(offline=offline, stream=mels, source=src, dit=dmel,
                        windows=sess.windows)
        del dec, cfm
    c, p = res["cuda"], res["cpu"]
    if c["windows"] != p["windows"] or c["windows"] != [120, 50]:
        raise AssertionError(f"v1 session windows {c['windows']}, "
                             f"{p['windows']}")

    def diff(a, b):
        return float(np.abs(a - b).max())

    # the phase scan alone, in cycles against a float64 sum: f32 cumsum
    # over the strided time axis (stride 9) and over a contiguous one on
    # the card (the source uses the contiguous one), and on the CPU
    h = torch.arange(1, hift_cfg.nb_harmonics + 2, dtype=torch.float32)
    rad = torch.remainder(torch.from_numpy(f0) * h / 22050, 1.0)
    exact = torch.cumsum(rad.double(), dim=1)
    rad_card = rad.to(card)
    scans = dict(
        card_strided=torch.cumsum(rad_card, dim=1),
        card_contiguous=torch.cumsum(rad_card.transpose(1, 2).contiguous(),
                                     dim=-1).transpose(1, 2),
        cpu=torch.cumsum(rad, dim=1))
    scan_drift = {k: float((v.cpu().double() - exact).abs().max())
                  for k, v in scans.items()}
    dit_peak = float(np.abs(p["dit"]).max())
    out = dict(
        offline=dict(tokens=60, prompt_tokens=20, mel_shape=list(
            p["offline"].shape), mel_max_abs=float(np.abs(p["offline"]).max()),
            max_abs_diff=diff(c["offline"], p["offline"]), tol=CROSS_TOL),
        stream=dict(tokens=150, windows=c["windows"],
                    max_abs_diff=max(diff(a, b) for a, b in
                                     zip(c["stream"], p["stream"])),
                    tol=CROSS_TOL),
        source=dict(samples=22050, max_abs=float(np.abs(p["source"]).max()),
                    max_abs_diff=diff(c["source"], p["source"]),
                    tol=V1_SOURCE_TOL, scan_drift_cycles=scan_drift),
        dit=dict(frames=200, mel_max_abs=dit_peak,
                 max_abs_diff=diff(c["dit"], p["dit"]),
                 tol=CROSS_TOL * max(1.0, dit_peak)))
    print("cross_v1", json.dumps(out), flush=True)
    for name, rec in out.items():
        if not rec["max_abs_diff"] <= rec["tol"]:
            raise AssertionError(f"card and CPU v1 {name} disagree: {rec}")
    for got in (c["offline"], c["source"], c["dit"], *c["stream"]):
        if not np.isfinite(got).all():
            raise AssertionError("non-finite v1 output on the card")
    return out


# ------------------------------------------------------------ A14a-c, C3
# the ASR head at the GLM-4-Voice tokenizer's full width with the post-VQ
# layers: 60 s of seeded speech tokens, two of the codec's 375-token
# segments
ASR_TOKENS = 750
# card against CPU, f32: the decoder's logits over a 32-token prefix and
# the post-VQ states, max diff as a share of the peak
ASR_CROSS_TOL = 1e-4
ASR_PREFIX = 32
# the greedy tokens card against CPU: a decode of this many positions
ASR_CROSS_MAX_LEN = 32
# encode_train card against CPU, f32: the pooled hidden states as a share
# of their peak (the pre-VQ tokenizer, as POOLED_REL_TOL)
TRAIN_REL_TOL = 1e-4
# the eval run: 2 seeded utterances of 3-4 s, each behind a 3 s prompt
# (two keep the smoke's time; the harness runs any number alike)
EVAL_SECONDS = (3.0, 4.0)
# the data run: 32 seeded 24 kHz utterances of 2-4 s; the matcha fbank
# card against CPU
DATA_UTTS = 32
FBANK_TOL = 1e-4
# the 24 kHz NSF source (MOSS HiFT) card against CPU, f32, the same
# draws: its phase is an f32 cumsum over frames (50 a second) multiplied
# by 480.  The card's contiguous scan drifts ~7e-6 cycles from float64
# over 20-30 s, the CPU's 2e-6-4e-6 (x480: 3.6e-3 cycles of phase), and
# the sources differ by 3.6e-3 (20 s) and 4.4e-3 (30 s) of a 0.22 peak on
# an H100; the strided scan's 0.015 and 0.018 fail this bound
HIFT_SOURCE_TOL = 1e-2


def trace_summary(prof, wall: float, top: int = 10,
                  device_s_of=()) -> dict:
    """Device time, kernels run, busy share of ``wall``, the host's launch
    calls and the ``top`` kernels by device time of a ``utils.graphs.
    profiled`` trace (its marker kernels left out; read from the raw events,
    ``utils.graphs.trace_tables``), and the device time of the kernels
    whose names hold each of ``device_s_of``."""
    from moss_speech_decoder_cosy_torch.utils.graphs import trace_tables
    kernels, launches = trace_tables(prof)
    device_s = sum(t for _, t in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return dict(
        {f"{n}_device_s": sum(t for k, (_, t) in kernels.items() if n in k)
         for n in device_s_of},
        wall_s=wall, device_s=device_s, busy_share=device_s / wall,
        kernels_run=sum(c for c, _ in kernels.values()),
        host_launch_calls=launches,
        top=[dict(name=k[:80], calls=c, device_ms=1e3 * t)
             for k, (c, t) in ranked[:top]])


def asr_config():
    from moss_speech_decoder_cosy_torch.tokenizer import (
        glm4_voice_tokenizer_config)
    return glm4_voice_tokenizer_config()


def seeded_asr(torch, device: str, dtype=None, graphs: bool = True):
    """``WhisperASR`` at ``asr_config()``: 16 post-VQ layers (seed 12) and
    the 4-layer decoder (seed 13) over the seeded tokenizer's codebook
    (seed 5, ``seeded_codec``'s)."""
    from moss_speech_decoder_cosy_torch.tokenizer import WhisperVQEncoder
    from moss_speech_decoder_cosy_torch.tokenizer.asr_decoder import (
        PostVQEncoder, WhisperASR, WhisperVQDecoder)
    from moss_speech_decoder_cosy_torch.weights import seeded_state
    cfg = asr_config()
    if "asr" not in SEEDED:
        with torch.device("meta"):
            post, dec, tok = (PostVQEncoder(cfg), WhisperVQDecoder(cfg),
                              WhisperVQEncoder(cfg))
        tok_state = SEEDED[("tok", "spk")][0] if ("tok", "spk") in SEEDED \
            else seeded_state(tok, 5)
        SEEDED["asr"] = (seeded_state(post, 12), seeded_state(dec, 13),
                         tok_state["codebook"].numpy())
    post_state, dec_state, codebook = SEEDED["asr"]
    return WhisperASR(cfg, post_state, dec_state, codebook, device=device,
                      dtype=dtype, graphs=graphs)


def counted(obj, name: str):
    """Wraps ``obj.name`` to count its calls: returns the count list."""
    calls = []
    orig = getattr(obj, name)

    def wrapper(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    setattr(obj, name, wrapper)
    return calls


def asr_phase(torch) -> dict:
    """The Whisper ASR head at full width (``asr_config()``: 16 post-VQ
    layers of d 1280, a 4-layer decoder with 20 heads and FF 5120, vocab
    51866, 448 target positions; weights from seeds 12, 13 and 5), over 60 s
    of seeded tokens (two 375-token segments), max_len 64, in f32 and bf16:
    one segment's greedy, beam 5 and timestamp decodes graphed (each of
    their 63 steps one CUDA graph replay; the first call captures) against
    eager (``graphs=False``), tokens equal; then ``transcribe`` greedy with
    the fallback ladder (the rungs run counted), beam 5,
    ``return_timestamps`` and ``word_timestamps``, each timed once (wall a
    segment); one segment's greedy decode graphed and eager, median of 3,
    ms a step; one profiled graphed greedy decode (kernels, device time,
    busy share)."""
    from moss_speech_decoder_cosy_torch.tokenizer.asr_decoder import (
        DecodeSteps)
    from moss_speech_decoder_cosy_torch.utils.graphs import profiled

    rng = np.random.RandomState(14)
    cfg = asr_config()
    ids = rng.randint(0, cfg.quantize_vocab_size, (1, ASR_TOKENS))
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        asr = seeded_asr(torch, "cuda", dt)
        n_seg = -(-ASR_TOKENS // asr.segment_tokens)
        steps = asr.max_len - 1
        rec = dict(segments=n_seg, max_len=asr.max_len)

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0

        # one segment's decodes, graphed (the first call of each kind
        # captures its step) against eager
        enc, valid = asr.encode_segments(ids)
        e, v = enc[:1], valid[:1]
        eager = DecodeSteps(asr.dec, asr.max_len, graphs=False)
        kinds = dict(
            greedy=lambda s: s.sample(e, v, asr.bos_id, asr.eos_id)[:2],
            beam5=lambda s: s.beam(e, v, asr.bos_id, asr.eos_id, 5)[:2],
            timestamp=lambda s: s.timestamp(e, v, asr.bos_id, asr.eos_id,
                                            asr.timestamp_begin))
        equal = {}
        for kind, call in kinds.items():
            g, _ = timed(lambda: call(asr.steps))
            x, _ = timed(lambda: call(eager))
            equal[kind] = all(bool(torch.equal(a, b)) for a, b in zip(g, x))
        # transcribe over both segments, every step a replay
        rungs = counted(asr.steps, "sample")
        segs, wall = timed(lambda: asr.transcribe(ids))
        rec["greedy_ladder"] = dict(
            wall_s=wall, s_per_segment=wall / n_seg, rungs=len(rungs),
            transcript_tokens=[len(s) for s in segs])
        for mode, kw in (("beam5", dict(beam_size=5)),
                         ("timestamps", dict(return_timestamps=True)),
                         ("word_timestamps", dict(word_timestamps=True))):
            res, wall = timed(lambda: asr.transcribe(ids, **kw))
            rec[mode] = dict(wall_s=wall, s_per_segment=wall / n_seg,
                             items=len(res))
        replays0 = sum(asr.steps.steps.replays.values())
        walls = {}
        for mode, s in (("graphed", asr.steps), ("eager", eager)):
            runs = [timed(lambda: kinds["greedy"](s))[1] for _ in range(3)]
            walls[mode] = statistics.median(runs)
        rec["step_ms"] = {k: 1e3 * w / steps for k, w in walls.items()}
        rec["decode_wall_s"] = walls
        rec["graph_replays"] = (sum(asr.steps.steps.replays.values())
                                - replays0)
        rec["graphs"] = len(asr.steps.steps.graphs)
        rec["graphed_equals_eager"] = equal
        prof, wall, edges = profiled(lambda: kinds["greedy"](asr.steps))
        rec["profile"] = dict(trace_summary(prof, wall), edges=edges,
                              per_step_ms=1e3 * wall / steps)
        out[name] = rec
        want_replays = 3 * steps if asr.steps.steps.enabled else 0
        if rec["graph_replays"] != want_replays or not all(equal.values()) \
                or not all(edges):
            raise AssertionError(f"asr {name}: {rec}")
        del asr, eager
    print("asr", json.dumps(out), flush=True)
    return out


def cross_asr_phase(torch, card: str = "cuda") -> dict:
    """The ASR head and the tokenizer's training forward at full width, f32,
    card against CPU, the same seeded weights: the post-VQ states of one
    375-token segment and the decoder's logits over a 32-token prefix (max
    diff over peak, ``ASR_CROSS_TOL``); one segment's greedy tokens over
    ``ASR_CROSS_MAX_LEN`` positions (equal; where one differs, its step
    and the CPU's top-2 logit gap); ``encode_train`` over 10 s of seeded
    audio against the codebook: the pooled hidden states (over peak,
    ``TRAIN_REL_TOL``), the straight-through output and the ids."""
    from moss_speech_decoder_cosy_torch.tokenizer.asr_decoder import (
        DecodeSteps)

    rng = np.random.RandomState(15)
    cfg = asr_config()
    ids = rng.randint(0, cfg.quantize_vocab_size, (1, 375))
    prefix = rng.randint(0, cfg.vocab_size, (1, ASR_PREFIX))
    wav = seeded_audio(10.0, 16000, 16)
    res = {}
    for key, dev in (("cuda", card), ("cpu", "cpu")):
        asr = seeded_asr(torch, dev, graphs=key == "cuda")
        codec = seeded_codec(torch, dev)
        with torch.no_grad():
            enc, valid = (x[:1] for x in asr.encode_segments(ids))
            pt = torch.as_tensor(prefix, device=dev)
            logits = asr.dec(pt, torch.ones_like(pt, dtype=torch.bool), enc,
                             valid)
            toks, n, _ = DecodeSteps(asr.dec, ASR_CROSS_MAX_LEN,
                                     graphs=key == "cuda").sample(
                enc, valid, asr.bos_id, asr.eos_id)
            feats, _ = codec.features(codec._wav(wav))
            t = min(feats.shape[1], 2 * cfg.max_source_positions) // 8 * 8
            train = codec.tokenizer.encode_train(
                feats[:, :t], torch.ones(1, t, dtype=torch.bool, device=dev),
                asr.codebook)
        res[key] = dict(enc=enc.cpu().numpy(), logits=logits.cpu().numpy(),
                        toks=toks.cpu().numpy(), n=n.cpu().numpy(),
                        train=[x.cpu().numpy() for x in train[1:4]],
                        hidden=train[0].cpu().numpy(), asr=asr)
        del codec
    c, p = res["cuda"], res["cpu"]

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    first_diff = None
    if not np.array_equal(c["toks"], p["toks"]):
        j = int(np.nonzero(c["toks"][0] != p["toks"][0])[0][0])
        asr = p["asr"]
        with torch.no_grad():
            enc, valid = (x[:1] for x in asr.encode_segments(ids))
            t = torch.as_tensor(p["toks"][:, :j])
            lg = asr.dec(t, torch.ones_like(t, dtype=torch.bool), enc,
                         valid)[0, -1]
        top2 = torch.topk(lg, 2).values
        first_diff = dict(step=j, top2_gap=float(top2[0] - top2[1]))
    st_c, ids_c, _ = c["train"]
    st_p, ids_p, _ = p["train"]
    hid_c, hid_p = c["hidden"], p["hidden"]
    out = dict(
        post_vq=dict(tokens=375, max_rel_diff=rel(c["enc"], p["enc"]),
                     tol=ASR_CROSS_TOL),
        logits=dict(prefix=ASR_PREFIX, peak=float(np.abs(p["logits"]).max()),
                    max_rel_diff=rel(c["logits"], p["logits"]),
                    tol=ASR_CROSS_TOL),
        greedy=dict(max_len=ASR_CROSS_MAX_LEN, n_card=c["n"].tolist(),
                    n_cpu=p["n"].tolist(),
                    equal=bool(np.array_equal(c["toks"], p["toks"])),
                    first_diff=first_diff),
        encode_train=dict(tokens=int(ids_p.shape[1]),
                          hidden_max_rel_diff=rel(hid_c, hid_p),
                          quantized_st_max_rel_diff=rel(st_c, st_p),
                          id_agreement=float((ids_c == ids_p).mean()),
                          tol=TRAIN_REL_TOL))
    print("cross_asr", json.dumps(out), flush=True)
    if not (out["post_vq"]["max_rel_diff"] <= ASR_CROSS_TOL
            and out["logits"]["max_rel_diff"] <= ASR_CROSS_TOL
            and out["encode_train"]["hidden_max_rel_diff"] <= TRAIN_REL_TOL
            and out["encode_train"]["id_agreement"] >= TOKEN_AGREEMENT_MIN
            and np.isfinite(c["logits"]).all()):
        raise AssertionError(f"the ASR's card and CPU paths disagree: {out}")
    return out


def seedtts_layout(root: Path, seconds, prompt_s: float = 3.0) -> None:
    """A Seed-TTS layout ``root/en/<sample>/{prompt,label}.{wav,txt}`` of
    seeded speech-like 16 kHz utterances."""
    from moss_speech_decoder_cosy_torch.eval.audio_io import write_wav
    for i, s in enumerate(seconds):
        d = root / "en" / f"utt{i}"
        d.mkdir(parents=True)
        write_wav(str(d / "prompt.wav"),
                  seeded_audio(prompt_s, 16000, 40 + i), 16000)
        write_wav(str(d / "label.wav"), seeded_audio(s, 16000, 50 + i), 16000)
        (d / "prompt.txt").write_text(f"prompt {i}\n")
        (d / "label.txt").write_text(f"label {i}\n")


def eval_phase(torch, fa) -> dict:
    """``run_seed_tts_benchmark(..., score=True)`` over 2 seeded utterances
    of 3-4 s behind 3 s prompts: the full-width codec (``seeded_codec``,
    with CAM++) over the MOSS decoder with flash attention in bf16 (decoding
    through ``decode_streaming``), the f32 ASR of the ``asr`` phase as the
    WER transcriber; ``failed == 0``, ``result.json`` holds WER and SIM;
    each sample's RTF (its wall, encode to wav written, over its audio; no
    warm-up run, the earlier phases have used every kernel) and the flash
    launches of the run."""
    import tempfile
    from moss_speech_decoder_cosy_torch.eval import run_seed_tts_benchmark
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models()
    dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                       compute_dtype=torch.bfloat16)
    codec = seeded_codec(torch, "cuda", dec, speaker=True)
    asr = seeded_asr(torch, "cuda")
    per_decode = launches_per_decode(flow_cfg)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        seedtts_layout(root / "bench", EVAL_SECONDS)
        fa.launch_flash_chunk_attention.launches = 0
        t0 = time.perf_counter()
        stats = run_seed_tts_benchmark(codec, str(root / "bench"),
                                       str(root / "out"), score=True,
                                       asr=asr)
        wall = time.perf_counter() - t0
        launches = fa.launch_flash_chunk_attention.launches
        if stats["failed"] or stats["ok"] != len(EVAL_SECONDS):
            raise AssertionError(f"the eval run failed samples: {stats}")
        samples = {}
        for d in sorted((root / "out" / "en").iterdir()):
            meta = json.loads((d / "metadata.json").read_text())
            samples[d.name] = dict(tokens=meta["num_tokens"],
                                   audio_s=meta["audio_s"],
                                   wall_s=meta["wall_s"],
                                   rtf=meta["wall_s"] / meta["audio_s"])
        result = json.loads((root / "out" / "result.json").read_text())
    scores = stats.pop("scores")
    out = dict(stats, wall_s=wall, samples=samples, result_json=result,
               wer=scores["wer"], sim=scores["sim"],
               per_sample=scores["per_sample"], flash_launches=launches,
               launches_per_decode=per_decode)
    print("eval", json.dumps(out), flush=True)
    if not (stats["failed"] == 0 and stats["ok"] == len(EVAL_SECONDS)
            and result.get("en", {}).get("wer") is not None
            and result["en"].get("sim") is not None
            and launches > 0 and launches % per_decode == 0):
        raise AssertionError(f"the eval run failed: {out}")
    return out


def data_shards(root: Path, sr: int = 24000):
    """``DATA_UTTS`` seeded speech-like utterances of 2-4 s at ``sr``: two
    parquet shards (16 rows each: ``utt``, ``speech``, ``sample_rate``,
    ``speech_token``, ``utt_embedding``) and one indexed tar of their wavs
    with a jsonl of tokens.  Returns (parquet paths, jsonl path)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import tarfile
    from moss_speech_decoder_cosy_torch.eval.audio_io import write_wav
    rng = np.random.RandomState(60)
    rows = []
    for i in range(DATA_UTTS):
        s = 2.0 + 2.0 * rng.rand()
        wav = seeded_audio(s, sr, 70 + i)
        rows.append(dict(utt=f"u{i:02d}", speech=wav.tolist(),
                         sample_rate=sr,
                         speech_token=rng.randint(0, 16384,
                                                  int(s * 12.5)).tolist(),
                         utt_embedding=rng.randn(192).astype(
                             np.float32).tolist()))
    paths = []
    for k in range(2):
        p = str(root / f"shard_{k}.parquet")
        pq.write_table(pa.Table.from_pylist(rows[16 * k: 16 * (k + 1)]), p)
        paths.append(p)
    with tarfile.open(root / "wavs.tar", "w") as tf, \
            open(root / "wavs.jsonl", "w") as jl:
        for r in rows:
            name = f"{r['utt']}.wav"
            write_wav(str(root / name), np.asarray(r["speech"], np.float32),
                      sr)
            tf.add(str(root / name), arcname=name)
            jl.write(json.dumps({"filename": name,
                                 "cosy_token": r["speech_token"]}) + "\n")
    return paths, str(root / "wavs.jsonl")


def data_phase(torch) -> dict:
    """The data chain over ``DATA_UTTS`` seeded 24 kHz utterances, from
    parquet shards and from an indexed tar with a jsonl: opener, filter,
    resample, ``compute_fbank`` on the card, ``compute_f0``, shuffle,
    sort, ``dynamic_batch``, ``padding`` (GAN fields); samples a second of
    each (1 warm pass, then 1 timed), the batches' shapes, and the fbank
    card against CPU (``FBANK_TOL``)."""
    import functools
    import random
    import tempfile
    from moss_speech_decoder_cosy_torch.data import (
        DataList, build_pipeline, processor as P)

    def chain(opener, srcs, device="cuda"):
        dl = DataList(srcs, shuffle=False)
        dl.set_epoch(0)
        random.seed(0)
        return list(build_pipeline(dl, [
            opener, functools.partial(P.filter_samples, max_length=3000),
            functools.partial(P.resample, resample_rate=24000),
            functools.partial(P.compute_fbank, device=device),
            P.compute_f0, functools.partial(P.shuffle, shuffle_size=16),
            functools.partial(P.sort, sort_size=16),
            functools.partial(P.dynamic_batch, max_frames_in_batch=2400),
            functools.partial(P.padding, gan=True)]))

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        parquet, jsonl = data_shards(Path(tmp))
        for name, opener, srcs in (
                ("parquet", P.parquet_opener, parquet),
                ("indexed_tar", functools.partial(
                    P.cosy_jsonl_opener, jsonl_suffix=".jsonl"), [jsonl])):
            chain(opener, srcs)                             # warm-up
            t0 = time.perf_counter()
            batches = chain(opener, srcs)
            wall = time.perf_counter() - t0
            n = sum(b["speech_feat"].shape[0] for b in batches)
            out[name] = dict(samples=n, batches=len(batches), wall_s=wall,
                             samples_per_s=n / wall,
                             batch_shapes=[list(b["speech_feat"].shape)
                                           for b in batches])
            if n != DATA_UTTS or not all(
                    np.isfinite(b["speech_feat"]).all() for b in batches):
                raise AssertionError(f"data {name}: {out[name]}")
        rows = list(P.parquet_opener(iter([{"src": p} for p in parquet])))
        feats = {dev: [r["speech_feat"] for r in P.compute_fbank(
            iter([dict(r) for r in rows]), device=dev)]
                 for dev in ("cuda", "cpu")}
    err = max(float(np.abs(a - b).max())
              for a, b in zip(feats["cuda"], feats["cpu"]))
    out["fbank"] = dict(utterances=len(rows), max_abs_diff=err,
                        tol=FBANK_TOL)
    print("data", json.dumps(out), flush=True)
    if not err <= FBANK_TOL:
        raise AssertionError(f"the fbank's card and CPU paths disagree: "
                             f"{out['fbank']}")
    return out


def voiced_f0(seconds: float, seed: int, sr: int = 24000,
              frame: int = 480) -> np.ndarray:
    """A seeded voiced f0 contour at the audio rate, (1, L, 1): 140 Hz
    with a slow 50 Hz swing and jitter, a tenth of the frames unvoiced."""
    frames = int(seconds * sr) // frame
    rng = np.random.RandomState(seed)
    t = np.arange(frames) / (sr / frame)
    f0 = 140 + 50 * np.sin(2 * np.pi * 0.3 * t) + rng.randn(frames) * 3
    f0[rng.rand(frames) < 0.1] = 0.0
    return np.repeat(f0, frame)[None, :, None].astype(np.float32)


def cross_hift_phase(torch, card: str = "cuda") -> dict:
    """C3: the 24 kHz NSF source (``SourceModuleHnNSF2`` at
    ``moss_hift_config()``, weights from seed 30) over 20 s and 30 s of a
    seeded voiced f0 contour, f32, card against CPU with the same draws
    (``HIFT_SOURCE_TOL``), and its frame-rate phase scan's drift in cycles
    from a float64 sum: f32 ``cumsum`` over the strided frame axis and over
    a contiguous one on the card, and on the CPU (the source scans the
    contiguous one).  Then one whole HiFT wav from a 250-token MOSS decode
    (the f32 flow's mel on the card, then ``HiFTGenerator`` at full width
    on the card and on the CPU, the same mel and draws), reported."""
    from moss_speech_decoder_cosy_torch.models.hift.generator import (
        HiFTGenerator, SourceModuleHnNSF2, linear_interpolate, seeded_draws)
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.weights import seeded_state

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(flash=False)
    up, h = hift_cfg.total_upsample, hift_cfg.nb_harmonics + 1
    with torch.device("meta"):
        src_state = seeded_state(SourceModuleHnNSF2(hift_cfg), 30)
    out = {}
    for secs in (20, 30):
        f0 = voiced_f0(secs, 31 + secs)
        draws = seeded_draws(h, f0.shape[1], "cpu")
        got = {}
        for key, dev in (("cuda", card), ("cpu", "cpu")):
            m = SourceModuleHnNSF2(hift_cfg)
            m.load_state_dict(src_state)
            m = m.to(dev)
            with torch.inference_mode():
                got[key] = m(torch.from_numpy(f0).to(dev),
                             *(d.to(dev) for d in draws)).cpu().numpy()
        fn = torch.from_numpy(f0) * torch.arange(1, h + 1,
                                                 dtype=torch.float32)
        rad = torch.remainder(fn / hift_cfg.sampling_rate, 1.0)
        ini = draws[0].clone()
        ini[:, 0] = 0.0
        rad = torch.cat([rad[:, :1] + ini[:, None, :], rad[:, 1:]], dim=1)
        rad_low = linear_interpolate(rad, rad.shape[1] // up)
        exact = torch.cumsum(rad_low.double(), dim=1)
        rc = rad_low.to(card)
        scans = dict(card_strided=torch.cumsum(rc, dim=1),
                     card_contiguous=torch.cumsum(
                         rc.transpose(1, 2).contiguous(), -1).transpose(1, 2),
                     cpu=torch.cumsum(rad_low, dim=1))
        drift = {k: float((v.cpu().double() - exact).abs().max())
                 for k, v in scans.items()}
        out[f"source_{secs}s"] = dict(
            frames=int(rad_low.shape[1]),
            max_abs_diff=float(np.abs(got["cuda"] - got["cpu"]).max()),
            max_abs=float(np.abs(got["cpu"]).max()), tol=HIFT_SOURCE_TOL,
            scan_drift_cycles=drift,
            phase_drift_cycles={k: v * up for k, v in drift.items()})
    dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                       device=card)
    tokens = np.random.RandomState(32).randint(0, flow_cfg.vocab_size,
                                               (1, 250))
    p = dec._defaults(None, None, None)
    mel = dec._flow_mel(tokens, *p, streaming=False, finalize=True)
    del dec
    draws = seeded_draws(h, mel.shape[1] * up, "cpu")
    wavs = {}
    for key, dev in (("cuda", card), ("cpu", "cpu")):
        m = HiFTGenerator(hift_cfg)
        m.load_state_dict(hift_state)
        m = m.to(dev).eval()
        with torch.inference_mode():
            wav, _ = m(torch.from_numpy(mel).to(dev),
                       draws=tuple(d.to(dev) for d in draws))
        wavs[key] = wav.cpu().numpy()
        del m
    out["wav"] = dict(tokens=250, frames=int(mel.shape[1]),
                      samples=int(wavs["cpu"].shape[1]),
                      max_abs=float(np.abs(wavs["cpu"]).max()),
                      max_abs_diff=float(np.abs(wavs["cuda"]
                                                - wavs["cpu"]).max()),
                      rel_l1=rel_l1(wavs["cuda"], wavs["cpu"]))
    print("cross_hift", json.dumps(out), flush=True)
    for secs in (20, 30):
        rec = out[f"source_{secs}s"]
        if not rec["max_abs_diff"] <= HIFT_SOURCE_TOL:
            raise AssertionError(f"the 24 kHz source's card and CPU paths "
                                 f"disagree: {rec}")
    if not np.isfinite(wavs["cuda"]).all():
        raise AssertionError("non-finite HiFT wav on the card")
    return out


# --------------------------------------------------------------------------
# training (one process): the flow, the HiFT GAN, the speech LM, the VQ
# --------------------------------------------------------------------------

# the flow's batch: 4 utterances of 10 s (125 tokens, 500 mel frames)
TRAIN_FLOW = (4, 125)
# the GAN's batch: 4 utterances of 1 s of seeded speech-like 24 kHz audio
TRAIN_GAN = (4, 1.0)
# the LM's batch: 2 rows of 60 text ids and 250 speech ids (10 s)
TRAIN_LM = (2, 60, 250)
# the VQ's batch: 2 x 10 s of 16 kHz mel (1000 frames)
TRAIN_VQ = (2, 1000)
TRAIN_RUNS = 5
# card against CPU, f32: the loss relative, each gradient as a share of its
# peak (plus GRAD_NOISE of the largest one, for gradients zero in exact
# arithmetic: the key projections' biases)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
GRAD_NOISE = 1e-7
CROSS_TRAIN_TOKENS = 40
CROSS_TRAIN_AUDIO_S = 0.2


def train_timed(torch, step, runs: int = TRAIN_RUNS):
    """1 warm-up, then the median of ``runs`` host walls of ``step()``,
    each ending in ``torch.cuda.synchronize()``; the peak of device memory
    allocated over all of them.  Returns (last output, median s, peak
    bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, statistics.median(walls), torch.cuda.max_memory_allocated()


def step_trace(torch, step, wall_s: float, profile: bool = True) -> dict:
    """The FLOPs of one more ``step()`` (products and convolutions, the
    backward's included; ``utils.flops.count_flops``) over the timed
    median wall ``wall_s``; with ``profile``, one more step traced
    (``trace_summary``: device time, busy share, kernels, the top 5)."""
    from moss_speech_decoder_cosy_torch.utils.flops import count_flops
    from moss_speech_decoder_cosy_torch.utils.graphs import profiled
    _, flops = count_flops(step)
    out = dict(tflop=flops / 1e12, tflop_per_s=flops / wall_s / 1e12)
    if profile:
        prof, wall, edges = profiled(step)
        out.update(trace_summary(prof, wall, top=5), edges=list(edges))
    return out


def finite_positive(torch, *values) -> bool:
    return all(bool(torch.isfinite(v).all()) and float(v) > 0
               for v in values)


def guard_raises(torch, counters, dev: str = "cuda") -> dict:
    """Each CUDA entry under autograd on the card raises ``RuntimeError``
    naming its switch, and launches nothing."""
    from moss_speech_decoder_cosy_torch.ops import flash_attention as fa
    from moss_speech_decoder_cosy_torch.ops import fused_block as fb
    from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
    q, k, v = (torch.randn((1, 2, 8, 64), device=dev) for _ in range(3))
    p, rp_, mt, cc1, cc2, x, rings = fb.make_group_inputs(
        6, 6, 16, 8, 2, 4, 2, 24, torch.float32, dev, seed=5)
    scal = fb.group_scalars([6] * 6, [0] * 6, [1] * 6, dev)
    cp, cx, pe, kv, pk = fc.make_conformer_inputs(
        2, 3, 16, 2, 32, 6, torch.float32, dev, seed=3)
    calls = {
        "flash_chunk_attention": ("use_flash_attention", lambda: (
            fa.flash_chunk_attention(q.requires_grad_(True), k, v))),
        "flash_chunk_attention_fl": ("use_flash_attention", lambda: (
            fa.flash_chunk_attention_fl(
                q.detach().transpose(1, 2).reshape(1, 8, 128)
                .requires_grad_(True), k.transpose(1, 2).reshape(1, 8, 128),
                v.transpose(1, 2).reshape(1, 8, 128), heads=2))),
        "fused_tf_group": ("kernel", lambda: fb.fused_tf_group(
            p, rp_, mt, cc1, cc2, x.requires_grad_(True), rings, scal, 0,
            heads=2, head_dim=4)),
        "fused_conformer_group": ("enc_kernel", lambda: (
            fc.fused_conformer_group(cp, cx.requires_grad_(True), pe, kv, pk,
                                     0, heads=2, head_dim=8))),
    }
    for c in counters:
        c.launches = 0
    out = {}
    for name, (switch, call) in calls.items():
        try:
            call()
        except RuntimeError as e:
            if switch not in str(e):
                raise AssertionError(f"{name}'s guard does not name "
                                     f"{switch}: {e}") from e
            out[name] = str(e).split(":")[0]
        else:
            raise AssertionError(f"{name} ran under autograd on the card")
    if any(c.launches for c in counters):
        raise AssertionError("a guarded entry launched its kernel")
    return out


def train_phase(torch, counters, dev: str = "cuda") -> dict:
    """Each model's train step at full width on the card, f32 (TF32 off),
    with the launch counts of every CUDA kernel read around it (0: a train
    step runs the plain paths), and the three entries' autograd guard."""
    from moss_speech_decoder_cosy_torch.models.hift import HiFTGenerator
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        SpeechLMConfig)
    from moss_speech_decoder_cosy_torch.ops.melspec import (
        matcha_mel_spectrogram)
    from moss_speech_decoder_cosy_torch.data import processor
    from moss_speech_decoder_cosy_torch.tokenizer.config import (
        glm4_voice_tokenizer_config)
    from moss_speech_decoder_cosy_torch.tokenizer.model import (
        WhisperVQEncoder)
    from moss_speech_decoder_cosy_torch.models.flow import (
        CausalMaskedDiffWithXvec)
    from moss_speech_decoder_cosy_torch.training import (
        gan, lm as lm_mod, make_flow_train_step, make_optimizer, vq)
    from moss_speech_decoder_cosy_torch.training.train_step import (
        AdamW, TrainState, constant_lr)
    from moss_speech_decoder_cosy_torch.weights import seeded_module
    import copy

    out = {"guard": guard_raises(torch, counters, dev)}
    for c in counters:
        c.launches = 0

    # the flow: the MOSS preset (encoder dropout 0.1; the KV session's
    # configuration: no flash) from seed 0, 4 x 10 s
    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(flash=False)
    b, n_tok = TRAIN_FLOW
    n_mel = n_tok * flow_cfg.token_mel_ratio
    rng = np.random.RandomState(0)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in dict(
        speech_token=rng.randint(0, flow_cfg.vocab_size, (b, n_tok)),
        token_valid=np.ones((b, n_tok), bool),
        speech_feat=rng.randn(b, n_mel, flow_cfg.output_size).astype(
            np.float32),
        feat_valid=np.ones((b, n_mel), bool),
        embedding=rng.randn(b, flow_cfg.spk_embed_dim).astype(
            np.float32)).items()}
    flow = {"batch": b, "tokens": n_tok, "mel_frames": n_mel,
            "dropout": flow_cfg.encoder.dropout_rate}
    model = CausalMaskedDiffWithXvec(flow_cfg)
    model.load_state_dict(flow_state, strict=True)
    model.to(dev).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for accum in (1, 2):
        model.load_state_dict(before)
        state = TrainState(0, model, make_optimizer()(model.parameters()))
        step = make_flow_train_step(state.model, accum_steps=accum)
        g = torch.Generator(device=dev).manual_seed(1)
        (_, m), s, peak = train_timed(torch, lambda: step(state, batch,
                                                          generator=g))
        moved = sum(not torch.equal(before[k], v)
                    for k, v in state.model.state_dict().items())
        trace = step_trace(torch, lambda: step(state, batch, generator=g),
                           s, profile=accum == 1)
        flow[f"accum_{accum}"] = dict(
            ms=s * 1e3, mel_frames_per_s=b * n_mel / s,
            peak_mem_gb=peak / 1e9, loss=float(m["loss"]),
            grad_norm=float(m["grad_norm"]), steps=state.step,
            params_moved=moved, params=len(before),
            n_params=sum(p.numel() for p in state.model.parameters()),
            **trace)
        if not (finite_positive(torch, m["loss"], m["grad_norm"])
                and moved == len(before)):
            raise AssertionError(f"flow train step: {flow}")
    del state, step, before, model
    out["flow"] = flow
    print("train flow", json.dumps(flow), flush=True)

    # the GAN: the MOSS HiFT (seed 1) + MPD ++ MRD (seed 2), 4 x 1 s
    b, seconds = TRAIN_GAN
    sr = hift_cfg.sampling_rate
    audio = np.stack([seeded_audio(seconds, sr, 80 + i) for i in range(b)])
    speech = torch.as_tensor(audio).to(dev)
    with torch.no_grad():
        mel = matcha_mel_spectrogram(speech, num_mels=hift_cfg.in_channels,
                                     sampling_rate=sr)
    rows = list(processor.compute_f0(
        [{"speech": a, "speech_feat": np.zeros((mel.shape[1], 1))}
         for a in audio], sample_rate=sr))
    gbatch = {"speech": speech[:, :mel.shape[1] * hift_cfg.total_upsample],
              "speech_feat": mel, "pitch_feat": torch.as_tensor(
                  np.stack([r["pitch_feat"] for r in rows])).to(dev)}
    gen = HiFTGenerator(hift_cfg)
    gen.load_state_dict(hift_state, strict=True)
    gen.to(dev).train()
    disc = seeded_module(gan.MultipleDiscriminator, 2, dev)

    def adam(m):
        return AdamW(m.parameters(), constant_lr(2e-4), b1=0.8, b2=0.99,
                     weight_decay=0.0)
    gstate = gan.GanTrainState(0, gen, disc, adam(gen), adam(disc))
    disc_step, gen_step = gan.make_gan_train_step([lambda w: (
        matcha_mel_spectrogram(w, sampling_rate=sr))])
    (_, dm), ds, dpeak = train_timed(torch, lambda: disc_step(gstate,
                                                              gbatch))
    (_, gm), gs, gpeak = train_timed(torch, lambda: gen_step(gstate,
                                                             gbatch))
    gtrace = step_trace(torch, lambda: gen_step(gstate, gbatch), gs,
                        profile=False)
    dtrace = step_trace(torch, lambda: disc_step(gstate, gbatch), ds,
                        profile=False)
    ganr = dict(batch=b, seconds=seconds, mel_frames=int(mel.shape[1]),
                gen_tflop=gtrace["tflop"],
                gen_tflop_per_s=gtrace["tflop_per_s"],
                disc_tflop=dtrace["tflop"],
                disc_tflop_per_s=dtrace["tflop_per_s"],
                disc_ms=ds * 1e3, gen_ms=gs * 1e3,
                disc_peak_mem_gb=dpeak / 1e9, gen_peak_mem_gb=gpeak / 1e9,
                audio_s_per_s=b * seconds / (ds + gs),
                **{k: float(v) for k, v in {**dm, **gm}.items()},
                gen_params=sum(p.numel() for p in gen.parameters()),
                disc_params=sum(p.numel() for p in disc.parameters()))
    if not all(np.isfinite(ganr[k]) for k in ("loss_disc", "loss",
                                              "loss_gen", "loss_fm",
                                              "loss_mel", "loss_f0")):
        raise AssertionError(f"GAN train step: {ganr}")
    out["gan"] = ganr
    print("train gan", json.dumps(ganr), flush=True)
    del gstate, gen, disc, gbatch

    # the LM: CosyVoice2-0.5B width, f32, 2 x (60 text + 250 speech)
    cfg = SpeechLMConfig()
    b, n_text, n_speech = TRAIN_LM
    rng = np.random.RandomState(10)

    def ids(hi, n):
        return torch.as_tensor(rng.randint(0, hi, (b, n))).to(dev)
    lens = {k: torch.full((b,), n, device=dev) for k, n in (
        ("text_token_len", n_text), ("speech_token_len", n_speech),
        ("chosen_token_len", n_speech), ("rejected_token_len", n_speech))}
    lbatch = {"text_token": ids(cfg.backbone.vocab_size, n_text),
              "speech_token": ids(cfg.speech_token_size, n_speech),
              "chosen_token": ids(cfg.speech_token_size, n_speech),
              "rejected_token": ids(cfg.speech_token_size, n_speech), **lens}
    model = seeded_lm(torch, cfg, 10, dev, torch.float32).train()
    ref = copy.deepcopy(model).eval().requires_grad_(False)
    lstate = TrainState(0, model, make_optimizer()(model.parameters()))
    ce = lm_mod.make_lm_train_step()
    dpo = lm_mod.make_dpo_train_step(ref, beta=0.01)
    (_, cm), cs, cpeak = train_timed(torch, lambda: ce(lstate, lbatch))
    (_, pm), ps, ppeak = train_timed(torch, lambda: dpo(lstate, lbatch))
    n_params = sum(p.numel() for p in model.parameters())
    ctrace = step_trace(torch, lambda: ce(lstate, lbatch), cs)
    lmr = dict(batch=b, text=n_text, speech=n_speech, n_params=n_params,
               ce_trace=ctrace,
               adamw_state_gb=2 * 4 * n_params / 1e9,
               ce_ms=cs * 1e3, dpo_ms=ps * 1e3,
               ce_speech_tokens_per_s=b * n_speech / cs,
               dpo_speech_tokens_per_s=2 * b * n_speech / ps,
               ce_peak_mem_gb=cpeak / 1e9, dpo_peak_mem_gb=ppeak / 1e9,
               ce_loss=float(cm["loss"]), acc=float(cm["acc"]),
               dpo_loss=float(pm["loss"]),
               reward_margin=float(pm["reward_margin"]), steps=lstate.step)
    if not (np.isfinite(lmr["ce_loss"]) and np.isfinite(lmr["dpo_loss"])):
        raise AssertionError(f"LM train step: {lmr}")
    out["lm"] = lmr
    print("train lm", json.dumps(lmr), flush=True)
    del lstate, model, ref, lbatch

    # the VQ: the GLM-4-Voice tokenizer, 2 x 10 s, the restart at the last
    # timed step
    vcfg = dataclasses.replace(glm4_voice_tokenizer_config(),
                               quantize_restart_interval=1 + TRAIN_RUNS)
    b, frames = TRAIN_VQ
    enc = WhisperVQEncoder(vcfg)
    enc.load_state_dict(codec_states(torch)[0], strict=True)
    enc.to(dev).train()
    rng = np.random.RandomState(5)
    vmel = torch.as_tensor(rng.randn(b, frames, vcfg.num_mel_bins).astype(
        np.float32)).to(dev)
    vvalid = torch.ones((b, frames), dtype=torch.bool, device=dev)
    # the EMA counts of a long run: they sum to the tokens of a step and
    # spread over the codes log-normally (seed 5), so codes are dead by the
    # restart as they become in training (a fresh state's counts are all 1)
    n_tokens = b * frames // 8
    share = torch.softmax(torch.as_tensor(2.0 * rng.randn(
        vcfg.quantize_vocab_size).astype(np.float32)), 0)
    vstate = [dataclasses.replace(vq.init_vq_state(enc.codebook),
                                  ema_count=(n_tokens * share).to(dev))]
    g = torch.Generator(device=dev).manual_seed(5)

    def vq_step():
        enc.zero_grad(set_to_none=True)
        st = vstate[0]
        hidden, q_st, tids, tv = enc.encode_train(vmel, vvalid, st.codebook)
        loss = torch.mean(q_st ** 2) + vq.commit_loss(
            hidden, st.codebook[tids], tv, vcfg)
        loss.backward()
        vstate[0] = vq.ema_update(st, hidden, tids, tv, vcfg, generator=g)
        return loss.detach()
    vloss, vs, vpeak = train_timed(torch, vq_step)
    after = vstate[0]

    def vq_fwd_bwd():
        enc.zero_grad(set_to_none=True)
        hidden, q_st, tids, tv = enc.encode_train(vmel, vvalid,
                                                  after.codebook)
        (torch.mean(q_st ** 2) + vq.commit_loss(
            hidden, after.codebook[tids], tv, vcfg)).backward()
    vtrace = step_trace(torch, vq_fwd_bwd, vs, profile=False)
    restarted = float((after.ema_count == 1.0).float().mean())
    vqr = dict(batch=b, mel_frames=frames, tokens=n_tokens,
               ms=vs * 1e3, peak_mem_gb=vpeak / 1e9, loss=float(vloss),
               tflop=vtrace["tflop"], tflop_per_s=vtrace["tflop_per_s"],
               steps=after.steps,
               restart_interval=vcfg.quantize_restart_interval,
               restarted_share=restarted,
               grad_norm=float(torch.sqrt(sum(
                   (p.grad.float() ** 2).sum() for p in enc.parameters()
                   if p.grad is not None))))
    if not (np.isfinite(vqr["loss"]) and vqr["grad_norm"] > 0
            and after.steps == 1 + TRAIN_RUNS):
        raise AssertionError(f"VQ train step: {vqr}")
    out["vq"] = vqr
    print("train vq", json.dumps(vqr), flush=True)

    launched = {c.__name__: c.launches for c in counters}
    out["kernel_launches"] = launched
    if any(launched.values()):
        raise AssertionError(f"a train step launched a kernel: {launched}")
    return out


def grads_close(got: dict, want: dict) -> dict:
    """Each gradient within ``TRAIN_GRAD_TOL`` of its own peak (plus
    ``GRAD_NOISE`` of the largest peak); returns the worst ratio."""
    top = max(float(np.abs(w).max()) for w in want.values())
    worst = ("", 0.0)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        ratio = err / (TRAIN_GRAD_TOL * float(np.abs(w).max())
                       + GRAD_NOISE * top)
        if ratio > worst[1]:
            worst = (k, ratio)
    return dict(worst_param=worst[0], worst_share_of_tol=worst[1],
                ok=worst[1] <= 1.0)


def cross_train_phase(torch, card: str = "cuda") -> dict:
    """f32, the card against the CPU with the same draws: one flow loss
    and its gradient (the estimator at ``CROSS_MID_BLOCKS``, 2 x 40
    tokens, the encoder's dropout at 0.1 with masks drawn on the host),
    and one HiFT generator loss and its gradient over 0.2 s."""
    from moss_speech_decoder_cosy_torch.models.flow import (
        CausalMaskedDiffWithXvec)
    from moss_speech_decoder_cosy_torch.models.flow.flow import (
        FlowLossDraws)
    from moss_speech_decoder_cosy_torch.models.hift import HiFTGenerator
    from moss_speech_decoder_cosy_torch.ops.dropout import Dropout
    from moss_speech_decoder_cosy_torch.ops.melspec import (
        matcha_mel_spectrogram)
    from moss_speech_decoder_cosy_torch.training import gan
    from moss_speech_decoder_cosy_torch.weights import seeded_module

    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(
        flash=False, mid_blocks=CROSS_MID_BLOCKS)
    b, n_tok = 2, CROSS_TRAIN_TOKENS
    n_mel = n_tok * flow_cfg.token_mel_ratio
    rng = np.random.RandomState(7)
    valid = np.ones((b, n_tok), bool)
    valid[1, n_tok - 6:] = False
    arrays = dict(
        speech_token=rng.randint(0, flow_cfg.vocab_size, (b, n_tok)),
        token_valid=valid,
        speech_feat=rng.randn(b, n_mel, flow_cfg.output_size).astype(
            np.float32),
        feat_valid=np.repeat(valid, flow_cfg.token_mel_ratio, axis=1),
        embedding=rng.randn(b, flow_cfg.spk_embed_dim).astype(np.float32))
    draws = FlowLossDraws.draw((b, n_mel, flow_cfg.output_size),
                               torch.Generator().manual_seed(8), "cpu")
    res = {}
    for dev in (card, "cpu"):
        m = CausalMaskedDiffWithXvec(flow_cfg)
        m.load_state_dict(flow_state, strict=True)
        m.to(dev).train()
        t = {k: torch.as_tensor(v).to(dev) for k, v in arrays.items()}
        d = FlowLossDraws(draws.prompt.to(dev), draws.keep.to(dev),
                          type(draws.cfm)(*(x.to(dev) for x in (
                              draws.cfm.t, draws.cfm.z, draws.cfm.cfg))))
        loss = m.loss(t["speech_token"], t["token_valid"], t["speech_feat"],
                      t["feat_valid"], t["embedding"], d,
                      drop=Dropout(flow_cfg.encoder.dropout_rate,
                                   torch.Generator().manual_seed(9)))
        loss.backward()
        res[dev] = (float(loss.detach()), {k: p.grad.cpu().numpy()
                                  for k, p in m.named_parameters()})
        del m
    flow = dict(tokens=n_tok, mid_blocks=CROSS_MID_BLOCKS,
                loss=res["cpu"][0], loss_card=res[card][0],
                loss_rel_diff=abs(res[card][0] - res["cpu"][0])
                / abs(res["cpu"][0]), loss_rtol=TRAIN_LOSS_RTOL,
                grad_tol=TRAIN_GRAD_TOL,
                **grads_close(res[card][1], res["cpu"][1]))
    print("cross_train flow", json.dumps(flow), flush=True)

    # HiFT: the generator's loss over 0.2 s, the NSF draws from the host
    sr, up = hift_cfg.sampling_rate, hift_cfg.total_upsample
    wav = torch.as_tensor(seeded_audio(CROSS_TRAIN_AUDIO_S, sr, 90)[None])
    # the mel of the host's audio is the input on both devices
    mel = matcha_mel_spectrogram(wav, num_mels=hift_cfg.in_channels,
                                 sampling_rate=sr)
    n_frames = min(mel.shape[1], wav.shape[1] // up)
    mel, wav = mel[:, :n_frames], wav[:, :n_frames * up]
    f0 = np.full((1, n_frames), 140.0, np.float32)
    h = hift_cfg.nb_harmonics + 1
    g = torch.Generator().manual_seed(11)
    nsf = (torch.rand((1, h), generator=g),
           torch.randn((1, n_frames * up, h), generator=g))
    res = {}
    for dev in (card, "cpu"):
        gen = HiFTGenerator(hift_cfg)
        gen.load_state_dict(hift_state, strict=True)
        gen.to(dev).train()
        disc = seeded_module(gan.MultipleDiscriminator, 12, dev)
        batch = {"speech": wav.to(dev), "speech_feat": mel.to(dev),
                 "pitch_feat": torch.as_tensor(f0).to(dev)}
        loss, _ = gan.generator_objective(
            gen, disc, batch, [lambda w: matcha_mel_spectrogram(
                w, sampling_rate=sr)], tuple(x.to(dev) for x in nsf))
        loss.backward()
        res[dev] = (float(loss.detach()), {k: p.grad.cpu().numpy()
                                  for k, p in gen.named_parameters()})
        del gen, disc
    hift = dict(seconds=CROSS_TRAIN_AUDIO_S, mel_frames=n_frames,
                loss=res["cpu"][0], loss_card=res[card][0],
                loss_rel_diff=abs(res[card][0] - res["cpu"][0])
                / abs(res["cpu"][0]), loss_rtol=TRAIN_LOSS_RTOL,
                grad_tol=TRAIN_GRAD_TOL,
                **grads_close(res[card][1], res["cpu"][1]))
    print("cross_train hift", json.dumps(hift), flush=True)
    for name, r in (("flow", flow), ("HiFT generator", hift)):
        if not (r["loss_rel_diff"] <= TRAIN_LOSS_RTOL and r["ok"]):
            raise AssertionError(f"card and CPU {name} training losses or "
                                 f"gradients disagree: {r}")
    return {"flow": flow, "hift": hift}


SPMD_LSB = 1                # int16 SPMD against the lockstep session
DIST_LOSS_RTOL = 1e-5       # DP / ZeRO step against one process
TP_REL_TOL = 1e-4           # TP logits against the unsharded LM, of peak
AOT_REL_TOL = 1e-6          # graph replay / export against eager, of peak
TP_DECODE_STEPS = 8


def spmd_phase(torch, fb, dev: str = "cuda") -> dict:
    """The lane-sharded decoder on the card (see the module doc); ``dev``
    "cpu" rehearses it at the tiny configs."""
    card = "cuda:0" if dev == "cuda" else "cpu"
    dec, tokens, lockstep_pcm = SEEDED["kv_batch"]
    b, n = tokens.shape
    cfg = dec.flow_cfg
    audio_s = n * cfg.token_mel_ratio * dec.hift_cfg.total_upsample / \
        dec.hift_cfg.sampling_rate
    spmd = dec.spmd_decoder([card], batch=b, token_cap=n + 16)
    rep = spmd.replicas[0]
    launches = wave_launches(rep, cfg, n)
    pcm, walls = timed_runs(lambda: spmd.decode(tokens, output="int16"),
                            "spmd decode", {fb.launch_fused_tf_group:
                                            launches}, runs=1)
    lsb = int(np.abs(pcm.astype(np.int32)
                     - lockstep_pcm.astype(np.int32)).max())
    out = dict(streams=b, tokens=n, replicas=1, launches=launches,
               wall_s=walls[0], x_realtime=b * audio_s / walls[0],
               int16_max_lsb=lsb, replica_kernel=rep._kernel)

    # two replicas on one card, f32 at CROSS_MID_BLOCKS, against batch 4
    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models(
        flash=False, mid_blocks=CROSS_MID_BLOCKS)
    kv = kv_decoder(flow_cfg, hift_cfg, flow_state, hift_state, 40)
    toks = np.random.RandomState(9).randint(0, flow_cfg.vocab_size, (4, 40))
    want = kv.dec.kv_stream_decoder(token_cap=56, batch=4).stream_decode(
        toks)
    two = kv.dec.spmd_decoder([card, card], batch=4, token_cap=56)
    got = two.decode(toks)
    err = float(np.abs(got - want).max())
    devices = two.replica_devices()
    out["f32_two_replicas"] = dict(
        tokens=40, mid_blocks=CROSS_MID_BLOCKS, max_abs_diff=err,
        tol=CROSS_TOL, peak=float(np.abs(want).max()),
        replica_devices=[sorted(d) for d in devices])
    print("spmd", json.dumps(out), flush=True)
    if lsb > SPMD_LSB or not rep._kernel:
        raise AssertionError(f"the SPMD int16 stream left the lockstep "
                             f"session's: {out}")
    if not (np.isfinite(got).all() and err <= CROSS_TOL) or \
            devices != [{card}, {card}]:
        raise AssertionError(f"two SPMD replicas disagree with the batch-4 "
                             f"session: {out}")
    return out


def nccl_events(torch, fn) -> dict:
    """{name: count} of the events of one profiled ``fn`` whose name holds
    "nccl": the process group's record of each collective it issued
    ("nccl:all_reduce", ...) and the device work NCCL ran for it (at world
    size 1 an in-place all-reduce moves nothing and runs no kernel)."""
    from moss_speech_decoder_cosy_torch.utils.graphs import (
        _raw_events, profiled)
    prof, _, edges = profiled(fn)
    if not all(edges):
        raise RuntimeError("a kernel of the profiled call may lie outside "
                           "the trace")
    out = {}
    for e in _raw_events(prof):
        if "nccl" in e.name().lower():
            key = f"{e.name()[:60]} ({str(e.device_type()).split('.')[-1]})"
            out[key] = out.get(key, 0) + 1
    return out


def issued(events: dict, op: str) -> int:
    """How many times ``nccl_events`` saw the group issue ``op``."""
    return sum(n for k, n in events.items() if k.startswith(f"nccl:{op} "))


def dist_phase(torch, dev: str = "cuda") -> dict:
    """One NCCL group of world size 1: data parallelism with ZeRO and
    tensor parallelism on the card (see the module doc)."""
    import copy
    import socket
    from moss_speech_decoder_cosy_torch.models.flow import (
        CausalMaskedDiffWithXvec)
    from moss_speech_decoder_cosy_torch.models.flow.flow import (
        FlowLossDraws)
    from moss_speech_decoder_cosy_torch.models.llm.qwen2 import Qwen2Config
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        SpeechLMConfig)
    from moss_speech_decoder_cosy_torch.parallel import distributed as D
    from moss_speech_decoder_cosy_torch.parallel.mesh import data_group
    from moss_speech_decoder_cosy_torch.parallel.tp import tensor_parallel
    from moss_speech_decoder_cosy_torch.training import (
        make_flow_train_step, make_optimizer)
    from moss_speech_decoder_cosy_torch.training.train_step import TrainState

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    D.initialize(f"127.0.0.1:{port}", 1, 0, device=dev)
    try:
        dg = data_group()
        out = dict(backend=torch.distributed.get_backend(), world=dg.world)
        flow_cfg, _, flow_state, _ = seeded_models(flash=False)
        b, n_tok = TRAIN_FLOW
        n_mel = n_tok * flow_cfg.token_mel_ratio
        rng = np.random.RandomState(0)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in dict(
            speech_token=rng.randint(0, flow_cfg.vocab_size, (b, n_tok)),
            token_valid=np.ones((b, n_tok), bool),
            speech_feat=rng.randn(b, n_mel, flow_cfg.output_size).astype(
                np.float32),
            feat_valid=np.ones((b, n_mel), bool),
            embedding=rng.randn(b, flow_cfg.spk_embed_dim).astype(
                np.float32)).items()}
        draws = FlowLossDraws.draw((b, n_mel, flow_cfg.output_size),
                                   torch.Generator(dev).manual_seed(3),
                                   dev)

        def state(zero):
            model = CausalMaskedDiffWithXvec(flow_cfg)
            model.load_state_dict(flow_state, strict=True)
            model.to(dev).train()
            opt = make_optimizer(zero=dg if zero else None)
            return TrainState(0, model, opt(model.parameters()))

        def draws_fn(i, mb):
            return draws, None

        one = state(False)
        step1 = make_flow_train_step(one.model, dp=None)
        _, m1 = step1(one, batch, draws=draws_fn)
        loss1 = float(m1["loss"])
        _, s1, _ = train_timed(torch, lambda: step1(one, batch,
                                                    draws=draws_fn), runs=3)
        del one, step1
        dp = state(True)
        step = make_flow_train_step(dp.model, dp=dg)
        _, m2 = step(dp, batch, draws=draws_fn)    # from the same weights
        loss_dp = float(m2["loss"])
        _, s, peak = train_timed(
            torch, lambda: step(dp, batch, draws=draws_fn), runs=3)
        out["flow"] = dict(batch=b, tokens=n_tok, loss_single=loss1,
                           loss_dp=loss_dp, rel=abs(loss_dp - loss1)
                           / abs(loss1), tol=DIST_LOSS_RTOL, ms=s * 1e3,
                           single_ms=s1 * 1e3,
                           peak_mem_gb=peak / 1e9,
                           moment_bytes=dp.optimizer.moment_bytes(),
                           nccl=nccl_events(torch, lambda: step(
                               dp, batch, draws=draws_fn)))
        del dp, step

        cfg = SpeechLMConfig(backbone=dataclasses.replace(
            Qwen2Config(), num_layers=LM_CROSS_LAYERS))
        ref = seeded_lm(torch, cfg, 11, dev, torch.float32)
        tp = tensor_parallel(copy.deepcopy(ref))
        rng = np.random.RandomState(6)
        text = rng.randint(0, ref.cfg.backbone.vocab_size, (1, LM_TEXT))
        forced = rng.randint(0, ref.cfg.speech_token_size, TP_DECODE_STEPS)

        @torch.inference_mode()
        def decode(lm):
            h, cache = lm.prefill(lm.prompt_embeds(
                text, np.zeros((1, 0), np.int64)))
            rows = [lm.llm_decoder(h[:, -1])]
            for tok in forced:
                e = lm.speech_embedding(torch.tensor([[int(tok)]],
                                                     device=dev))
                h, cache = lm.llm.forward_embeds(e, cache)
                rows.append(lm.llm_decoder(h[:, -1]))
            return torch.cat(rows).float().cpu().numpy()

        want, got = decode(ref), decode(tp)
        peak = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        out["tp"] = dict(layers=LM_CROSS_LAYERS, steps=TP_DECODE_STEPS,
                         peak=peak, max_abs_diff=err, rel=err / peak,
                         tol=TP_REL_TOL,
                         nccl=nccl_events(torch, lambda: decode(tp)))
        SEEDED["tools_lm"] = ref
    finally:
        D.shutdown()
    print("dist", json.dumps(out), flush=True)
    if not (out["flow"]["rel"] <= DIST_LOSS_RTOL and np.isfinite(loss_dp)):
        raise AssertionError(f"the data-parallel flow step left the "
                             f"single-process step: {out}")
    if not out["tp"]["rel"] <= TP_REL_TOL:
        raise AssertionError(f"the tensor-parallel LM left the unsharded "
                             f"one: {out}")
    # a DP step: the gradients' all-reduce, the ZeRO all-gather and the
    # batch's row / length all-reduce; TP: two all-reduces a layer a step
    tp_want = 2 * LM_CROSS_LAYERS * (TP_DECODE_STEPS + 1)
    if not (issued(out["flow"]["nccl"], "all_reduce") >= 2
            and issued(out["flow"]["nccl"], "all_gather") >= 1
            and issued(out["tp"]["nccl"], "all_reduce") >= tp_want):
        raise AssertionError(f"the process group did not issue the "
                             f"collectives: {out}")
    return out


def tools_phase(torch, fb, dev: str = "cuda", tool_args=()) -> dict:
    """The A14e tools on the card (see the module doc); ``tool_args``
    (``--config tiny``) and ``dev`` "cpu" rehearse it."""
    import copy
    import tempfile
    from moss_speech_decoder_cosy_torch.bin import (
        ablate_block, ablate_dtype, analyze_wave_copies, profile_tail,
        profile_wave)
    from moss_speech_decoder_cosy_torch.utils import export, profiling

    dec, tokens, _ = SEEDED["kv_batch"]
    stream = tokens[:1]
    seconds = stream.shape[1] / 12.5
    t0 = time.perf_counter()
    out = {"profile_wave": [profile_wave.profile_spec(
        dec, spec, stream, seconds, 3, True)
        for spec in ("kernel:5:35", "kernel:10:30")]}
    for row in out["profile_wave"]:
        print("profile_wave", json.dumps(row), flush=True)
    t1 = time.perf_counter()
    kv = dec.kv_stream_decoder(token_cap=stream.shape[1] + 16)
    out["profile_tail"] = dict(graphed=profile_tail.profile(kv, stream, 3))
    print("profile_tail", json.dumps(out["profile_tail"]), flush=True)
    t2 = time.perf_counter()
    # a steady iteration is the same in any stream past the ODE's depth
    eager = dec.kv_stream_decoder(token_cap=96, graphs=False)
    with torch.inference_mode():
        out["copies"] = analyze_wave_copies.audit(eager, tokens[:1, :80])
    print("copies", json.dumps(out["copies"]), flush=True)
    out["part_s"] = dict(profile_wave=t1 - t0, profile_tail=t2 - t1,
                         copies=time.perf_counter() - t2)
    part_s = out["part_s"]
    t0 = time.perf_counter()
    states = seeded_models(flash=False)[2:]
    out["ablate_dtype"] = ablate_dtype.main(["--device", dev, *tool_args],
                                            states)
    part_s["ablate_dtype"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["ablate_block"] = ablate_block.main(["--random-init", "5", "10",
                                             "--device", dev, *tool_args],
                                            states)
    part_s["ablate_block"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # a trace of a 20-token decode holds its kernels
    short = tokens[:1, :20]
    kv20 = dec.kv_stream_decoder(token_cap=36)
    kv20.stream_decode(short)
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d) as t:
            with profiling.annotate("kv_decode_20"):
                kv20.stream_decode(short)
        text = Path(t.path).read_text()
        out["trace"] = dict(bytes=len(text), wall_s=t.wall_s,
                            fused_tf_group=text.count("fused_tf_group"),
                            annotated="kv_decode_20" in text)
    part_s["trace"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # aot_compile and export of the causal forward of the 4-layer LM's
    # first layer (the export holds its weights)
    lm = SEEDED.pop("tools_lm")
    one = copy.deepcopy(lm.llm)
    one.layers = one.layers[:1]
    g = torch.Generator(dev).manual_seed(7)
    d_model = one.cfg.hidden_size
    x, x2 = (torch.randn(2, 64, d_model, device=dev, generator=g)
             for _ in range(2))
    with torch.inference_mode():
        call = export.aot_compile(one.forward_causal, x)
        want = one.forward_causal(x2)
        got = call(x2)
        peak = float(want.abs().max())
    with torch.no_grad():
        blob = export.export_serialized(one.forward_causal, x)
        back = export.load_serialized(blob)(x2)
    part_s["aot_export"] = time.perf_counter() - t0
    out["aot"] = dict(graphs=len(call.graphs.graphs),
                      replays=sum(call.graphs.replays.values()),
                      rel=float((got - want).abs().max()) / peak,
                      export_bytes=len(blob),
                      export_rel=float((back - want).abs().max()) / peak,
                      tol=AOT_REL_TOL)
    print("tools", json.dumps({k: out[k] for k in ("trace", "aot")}),
          flush=True)
    wave = out["profile_wave"]
    if "scan_s" not in wave[0] or "kernel_limit" not in wave[1] or \
            "scan_s" in wave[1]:
        raise AssertionError(f"profile_wave rows: {wave}")
    if wave[0]["launches"] != wave_launches(kv, dec.flow_cfg,
                                            stream.shape[1]):
        raise AssertionError(f"profile_wave's kernel row launched "
                             f"{wave[0]['launches']} groups")
    if not (out["trace"]["fused_tf_group"] and out["trace"]["annotated"]):
        raise AssertionError(f"the trace misses its kernels: {out['trace']}")
    if not (out["aot"]["rel"] <= AOT_REL_TOL
            and out["aot"]["export_rel"] <= AOT_REL_TOL
            and out["aot"]["graphs"] == 1 and out["aot"]["replays"] >= 1):
        raise AssertionError(f"aot_compile / export: {out['aot']}")
    if not out["copies"]["copies"] or \
            len(out["ablate_block"]["blocks"]) != 2:
        raise AssertionError("the copy audit or ablate_block came back "
                             "empty")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (ROOT / PACKAGE).is_dir():
        print(f"chip_smoke: {PACKAGE}/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from moss_speech_decoder_cosy_torch.ops import cuda_build
    from moss_speech_decoder_cosy_torch.ops import flash_attention as fa
    from moss_speech_decoder_cosy_torch.ops import fused_block as fb
    from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
    from moss_speech_decoder_cosy_torch.utils.device import card_line

    # 1. card
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in cuda_build.BUILD_LOGS.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)
    print(f"built {sorted(libs)} in {build_s:.1f} s", flush=True)

    phase_s = {}

    def phase(name, fn, *a):
        t = time.perf_counter()
        got = fn(*a)
        phase_s[name] = time.perf_counter() - t
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return got

    # 3. kernels
    records = phase("flash", kernel_phase, torch, fa)
    group_records = phase("fused_group", fused_group_phase, torch, fb)
    conf_records = phase("conformer", conformer_phase, torch, fc)

    # 4. offline and windowed slice
    sl = phase("slice", slice_phase, torch, fa)

    # 5. KV slice, and the continuous batcher
    kv_sl = phase("kv", kv_slice_phase, torch, fb, fc)
    api = phase("kv_api", kv_api_phase, torch, fb)
    kvb = phase("kv_batch", kv_batch_phase, torch, fb)
    kvq = phase("kv_quant", kv_quant_phase, torch, fb)
    bat = phase("batcher", batcher_phase, torch, fb)
    win = phase("windowed_device", windowed_device_phase, torch,
                (fa.launch_flash_chunk_attention, fb.launch_fused_tf_group,
                 fc.launch_fused_conformer_group))
    tok = phase("tokenizer", tokenizer_phase, torch)
    srv = phase("serve", serve_phase, torch, fb)
    lmr = phase("lm", lm_phase, torch, fa)
    v1 = phase("v1", v1_phase, torch, fa)
    asr = phase("asr", asr_phase, torch)
    ev = phase("eval", eval_phase, torch, fa)
    data = phase("data", data_phase, torch)
    train = phase("train", train_phase, torch,
                  (fa.launch_flash_chunk_attention, fb.launch_fused_tf_group,
                   fc.launch_fused_conformer_group))

    # 6. cross-device
    cross = phase("cross", cross_phase, torch)
    cross["kv"] = phase("cross_kv", cross_kv_phase, fb, fc)
    cross["kv_options"] = phase("cross_kv_options", cross_kv_options_phase,
                                fb)
    cross["batcher"] = phase("cross_batcher", cross_batcher_phase, fb)
    cross["batcher_concat"] = phase("cross_batcher_concat",
                                    cross_batcher_phase, fb, False)
    cross["windowed_device"] = phase("cross_windowed", cross_windowed_phase,
                                     torch)
    cross["kv_batch"] = phase("cross_kv_batch", cross_kv_batch_phase, fb)
    cross["codec"] = phase("cross_codec", cross_codec_phase, torch, fa)
    cross["lm"] = phase("cross_lm", cross_lm_phase, torch)
    cross["v1"] = phase("cross_v1", cross_v1_phase, torch)
    cross["asr"] = phase("cross_asr", cross_asr_phase, torch)
    cross["hift"] = phase("cross_hift", cross_hift_phase, torch)
    cross["train"] = phase("cross_train", cross_train_phase, torch)

    # 6b. multi-device modules and tools
    spmd = phase("spmd", spmd_phase, torch, fb)
    dist = phase("dist", dist_phase, torch)
    tools = phase("tools", tools_phase, torch, fb)

    # 7. result
    main_rec = next(r for r in records if r["layout"] == "fl"
                    and r["dtype"] == "bfloat16" and r["chunk"] == 0
                    and r["valid_len"] == r["shape"][2]
                    and r["qk_scale"] == 0.3)
    group_rec = next(r for r in group_records if r["group"] == "mid"
                     and r["mode"] == "steady" and r["dtype"] == "bfloat16")
    # the batcher's per-row launches, one lane (20 rows) to four (80 rows)
    per_row = [dict(rows=r["shape"]["rows"], dtype=r["dtype"], ms=r["ms"],
                    ms_warm_l2=r["ms_warm_l2"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    max_abs_err=max(r["max_abs_err"].values()))
               for r in group_records if r["mode"].startswith("lanes_")]
    # the lockstep session's launch: 80 rows at one shared offset
    lockstep = [dict(rows=r["shape"]["rows"], dtype=r["dtype"], ms=r["ms"],
                     ms_warm_l2=r["ms_warm_l2"], plain_ms=r["plain_ms"],
                     bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                     max_abs_err=max(r["max_abs_err"].values()))
                for r in group_records if r["mode"].startswith("lockstep_")]
    kernels = [dict(
        name="flash_chunk_attention", route="cuda",
        source=f"{PACKAGE}/csrc/flash_chunk_attention.cu",
        replaces="moss_speech_decoder_cosy_tpu/ops/pallas_attention.py:30",
        launches=sl["launches"], synth_launches=lmr["tts"]["flash_launches"],
        train_launches=train["kernel_launches"][
            "launch_flash_chunk_attention"],
        v1_launches=v1["f32"]["launches"],
        v1_stream_launches=v1["stream"]["launches"],
        eval_launches=ev["flash_launches"], v1_shapes=[
            dict(shape=r["shape"], dtype=r["dtype"], layout=r["layout"],
                 ms=r["ms"], ms_cold_l2=r["ms_cold_l2"],
                 plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                 bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                 max_abs_err=r["max_abs_err"], tol=r["tol"])
            for r in records if r.get("v1")],
        max_abs_err=main_rec["max_abs_err"],
        ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
        bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
        library_ms=main_rec["library_ms"]), dict(
        name="fused_tf_group", route="cuda",
        source=f"{PACKAGE}/csrc/fused_tf_group.cu",
        replaces="moss_speech_decoder_cosy_tpu/ops/pallas_block.py:158",
        launches=kv_sl["launches"],
        train_launches=train["kernel_launches"]["launch_fused_tf_group"],
        max_abs_err=max(group_rec["max_abs_err"].values()),
        ms=group_rec["ms"], ms_warm_l2=group_rec["ms_warm_l2"],
        plain_ms=group_rec["plain_ms"],
        bound_ms=group_rec["bound_ms"], bound_by=group_rec["bound_by"],
        library_ms=None, library_note=FUSED_NOTE,
        batcher_launches=bat["graphed"]["fused_tf_group_launches"],
        serve_launches=srv["decode_stream"]["fused_tf_group_launches"],
        segmented_launches=api["segmented_launches"], per_row=per_row,
        lockstep_launches=kvb["launches"], lockstep=lockstep,
        spmd_launches=spmd["launches"])]
    # the blocks group (the larger read) with a full ring, as the steady
    # stream runs it, timed with L2 flushed: each hop streams the
    # estimator's rings between two encoder launches
    conf_rec = next(r for r in conf_records if r["group"] == "blocks"
                    and r["mode"] == "full" and r["dtype"] == "bfloat16")
    kernels.append(dict(
        name="fused_conformer_group", route="cuda",
        source=f"{PACKAGE}/csrc/fused_conformer_group.cu",
        replaces="moss_speech_decoder_cosy_tpu/ops/pallas_conformer.py:57",
        launches=kv_sl["enc_kernel"]["launches"],
        train_launches=train["kernel_launches"][
            "launch_fused_conformer_group"],
        max_abs_err=max(conf_rec["max_abs_err"].values()),
        ms=conf_rec["ms"], ms_warm_l2=conf_rec["ms_warm_l2"],
        plain_ms=conf_rec["plain_ms"], bound_ms=conf_rec["bound_ms"],
        bound_by=conf_rec["bound_by"], library_ms=None,
        library_note=CONFORMER_NOTE))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                 build_s=build_s, phase_s=phase_s, kernels=kernels,
                 cases=dict(flash_chunk_attention=records,
                            fused_tf_group=group_records,
                            fused_conformer_group=conf_records),
                 slice=sl, kv_slice=kv_sl, kv_api=api, kv_batch=kvb,
                 kv_quant=kvq, batcher=bat, windowed_device=win,
                 tokenizer=tok, serve=srv, lm=lmr, v1=v1, asr=asr,
                 eval=ev, data=data, train=train, cross=cross,
                 spmd=spmd, dist=dist, tools=tools),
            indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
