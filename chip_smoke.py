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
   time of one PyTorch library call computing the same function (a
   yardstick only; the port never calls it) and the card's bound.
4. Slice at full width: ``moss_flow_config()`` with flash attention and
   ``moss_hift_config()``, weights drawn from seed 0, bf16 compute.
   ``token2wav`` of 250 tokens and ``stream_inference`` of 100 tokens, each
   1 warm-up + median of 3 with the launch counts read around every timed
   call, and the first chunk's latency of a new streaming session.
5. Cross-device: the flow mel in f32 on the card (kernel) and on the CPU
   (plain path), same weights: offline over 50 tokens and streaming over
   one 40-token window.
6. One ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when CUDA is unavailable or the port's
package is not beside this script.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "moss_speech_decoder_cosy_torch"

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# flow mel, f32 on the card (kernel, cuBLAS/cuDNN without TF32) vs the CPU
CROSS_TOL = 1e-4


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
                print("kernel", json.dumps(rec), flush=True)
                if not err <= tol:
                    raise AssertionError(f"kernel disagrees with its plain "
                                         f"version: {rec}")
                records.append(rec)
    return records


def seeded_models():
    """(flow_cfg, hift_cfg, flow_state, hift_state): the MOSS presets with
    flash attention on, weights from seeds 0 and 1."""
    from moss_speech_decoder_cosy_torch.utils import config as C
    from moss_speech_decoder_cosy_torch.weights import seeded_states

    flow_cfg = C.moss_flow_config()
    hift_cfg = C.moss_hift_config()
    flow_cfg = dataclasses.replace(flow_cfg, estimator=dataclasses.replace(
        flow_cfg.estimator, use_flash_attention=True))
    return (flow_cfg, hift_cfg) + seeded_states(flow_cfg, hift_cfg)


def launches_per_decode(flow_cfg) -> int:
    """Attention calls of one decode: every transformer block of the U-Net
    at every Euler step (CFG runs as one batch of 2)."""
    e = flow_cfg.estimator
    blocks = (2 * len(e.channels) + e.num_mid_blocks) * e.n_blocks
    return blocks * flow_cfg.cfm.n_timesteps


def timed_runs(fa, call, want_launches: int, what: str):
    """One warm-up call, then 3 timed calls with the launch count set to 0
    just before each and checked just after.  Returns (last output, walls,
    launches of one call)."""
    call()
    walls = []
    for _ in range(3):
        fa.launch_flash_chunk_attention.launches = 0
        t0 = time.perf_counter()
        out = call()
        walls.append(time.perf_counter() - t0)
        launches = fa.launch_flash_chunk_attention.launches
        if launches != want_launches:
            raise AssertionError(f"{what} launched the kernel {launches} "
                                 f"times, expected {want_launches}")
    return out, walls, launches


def slice_phase(torch, fa) -> dict:
    """Full-width token2wav and stream_inference through the port's entry
    points; returns the measurements."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    import numpy as np

    n_tokens, n_stream = 250, 100
    flow_cfg, hift_cfg, flow_state, hift_state = seeded_models()
    dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                       compute_dtype=torch.bfloat16)
    per_decode = launches_per_decode(flow_cfg)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, flow_cfg.vocab_size, (1, n_tokens))
    samples = n_tokens * flow_cfg.token_mel_ratio * hift_cfg.total_upsample
    audio_s = samples / hift_cfg.sampling_rate

    wav, walls, launches = timed_runs(fa, lambda: dec.token2wav(tokens),
                                      per_decode, "token2wav")
    if wav.shape != (1, samples) or not np.isfinite(wav).all() or \
            np.abs(wav).max() > hift_cfg.audio_limit:
        raise AssertionError(f"bad token2wav output {wav.shape} "
                             f"max|x| {np.abs(wav).max()}")
    wall = statistics.median(walls)

    stream_tokens = rng.randint(0, flow_cfg.vocab_size, (1, n_stream))
    # one window per complete hop (hop + lookahead tokens), one to finish
    hop, ahead = dec.pipe_cfg.block_size, flow_cfg.pre_lookahead_len
    windows = max(0, (n_stream - ahead) // hop) + 1
    swav, stream_walls, stream_launches = timed_runs(
        fa, lambda: dec.stream_inference(stream_tokens), per_decode * windows,
        "stream_inference")
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


def cross_phase(torch) -> dict:
    """f32 flow mel on the card (kernel) vs on the CPU (plain path):
    offline over 50 tokens (chunk 0) and streaming over one 40-token
    window (chunk 50)."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    import numpy as np

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

    # 3. kernels
    records = kernel_phase(torch, fa)

    # 4. slice
    sl = slice_phase(torch, fa)

    # 5. cross-device
    cross = cross_phase(torch)

    # 6. result
    main_rec = next(r for r in records if r["layout"] == "fl"
                    and r["dtype"] == "bfloat16" and r["chunk"] == 0
                    and r["valid_len"] == r["shape"][2]
                    and r["qk_scale"] == 0.3)
    kernel = dict(
        name="flash_chunk_attention", route="cuda",
        source=f"{PACKAGE}/csrc/flash_chunk_attention.cu",
        replaces="moss_speech_decoder_cosy_tpu/ops/pallas_attention.py:30",
        launches=sl["launches"], max_abs_err=main_rec["max_abs_err"],
        ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
        bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
        library_ms=main_rec["library_ms"], cases=records)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                 build_s=build_s, kernels=[kernel], slice=sl, cross=cross),
            indent=1))
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
