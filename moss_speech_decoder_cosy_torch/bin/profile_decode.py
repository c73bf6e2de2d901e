"""Where the time of a full-width decode goes, on one CUDA card.

    python -m moss_speech_decoder_cosy_torch.bin.profile_decode \
        [--tokens 250] [--stream-tokens 40] \
        [--kv [--enc-kernel] [--seg [N]] [--no-fused] [--onehot] \
         | --windowed-device] [--no-graphs] [--out prof.json]

Builds the MOSS presets with seeded weights in bf16 and warms up.  Without
``--kv``, with flash attention, for ``token2wav`` and for one windowed
``stream_inference``; with ``--kv``, for the KV session's
``stream_decode`` of ``--tokens`` tokens (the configuration ``bench.py``
runs: ring attention, block 5, mel cache 8, max_token_len 40, the kernel
engine, each wavefront iteration and each per-hop step replayed as a CUDA
graph; ``--enc-kernel`` runs its encoder hop through the conformer group
kernel, ``--no-graphs`` runs the same steps eagerly; as ``bench.py``'s
flags, ``--seg [N]`` decodes the wavefront in segments of N iterations,
default 32 (``stream_decode(segmented=True, seg_iters=N)``), ``--no-fused``
runs the concat dataflow (``fused=False``) and ``--onehot`` the one-hot
write (``write_mode="onehot"``), both on the unfused engine); with
``--windowed-device``, for the windowed device session's
``stream_decode(output="int16")`` of ``--tokens`` tokens in the same
configuration (the reference's windowed re-decode on the card, no flash,
each step a CUDA graph; ``--no-graphs`` eager):

- stage wall times with a synchronize after each stage (flow mel, HiFT;
  for the KV session the wavefront with its finalize tail, median of 3,
  then the bulk vocoder, and apart from them the encoder of the stream's
  steady hops, with its own trace; for the windowed device session the
  flow steps (hops and batched buckets) and the vocoder steps, each step
  timed alone, by step kind, median of 3 decodes);
- a ``torch.profiler`` trace: device time by kernel (top 12), kernels run
  on the device, the host's launch calls (``cudaLaunchKernel*``,
  ``cudaGraphLaunch``), total device time, host wall, and the device's
  busy share of the wall (the profiler's own host cost lowers that
  share).

Prints one JSON object per measurement and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..pipeline import AudioDecoder
from ..utils import config as C
from ..utils.device import card_line
from ..weights import seeded_states


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _trace(fn, top: int = 12) -> dict:
    """Device time by kernel over one call of ``fn``: kernels are the
    profiler's device-side events (the host-side ops that launch them are
    not counted again)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    host_launches = {e.key: int(e.count) for e in prof.key_averages()
                     if e.key.startswith("cuda") and "Launch" in e.key}
    return dict(
        wall_s=wall, device_s=device_s, busy_share=device_s / wall,
        kernel_launches=int(sum(e.count for e in kernels)),
        host_launch_calls=host_launches,
        top=[dict(name=e.key[:80], calls=e.count,
                  device_ms=e.self_device_time_total / 1e3)
             for e in kernels[:top]])


def _kv_profile(tokens: np.ndarray, results: dict, enc_kernel: bool,
                graphs: bool, seg_iters=None, fused: bool = True,
                onehot: bool = False) -> None:
    """Stages and traces of the KV session's ``stream_decode`` and of the
    encoder of its steady hops (eager, host-int positions); with
    ``seg_iters``, the segmented decode's wall (median of 3) and trace as
    well."""
    dec = _bench_decoder()
    kv = dec.kv_stream_decoder(token_cap=tokens.shape[1] + 16,
                               enc_kernel=enc_kernel, graphs=graphs,
                               fused=fused,
                               write_mode="onehot" if onehot else "auto")
    kv.stream_decode(tokens)                    # warm-up, captures the graphs
    plan = kv.schedule(tokens.shape[1])
    k = sum(1 for _, fin in plan if not fin)
    buf = kv._token_buf(tokens)
    flow_walls = []
    for _ in range(3):
        cache, _ = kv.init_state()
        flow_s, (mel, _) = _wall(lambda: kv._flow_mels_wave(buf, cache,
                                                            plan))
        flow_walls.append(flow_s)
    voc_s, _ = _wall(lambda: kv._bulk.vocode(
        mel, [e * kv.ratio for e, _ in plan]))
    enc = kv.init_state()[0]["enc"]

    def encoder_hops():
        """The encoder of the k steady hops, as the wavefront runs it."""
        nonlocal enc
        for i in range(k):
            _, enc = kv._encode_hop(buf, enc, kv.p + i * kv.hop)

    encoder_hops()                                         # warm-up
    enc_s, _ = _wall(encoder_hops)
    results["kv_stages_s"] = dict(
        enc_kernel=enc_kernel, graphs=kv._graphs, kernel=kv._kernel,
        dataflow=kv._dataflow, write=kv._write,
        wavefront_iterations=k + kv.s_steps - 1,
        flow=statistics.median(flow_walls), flow_walls=flow_walls,
        bulk_vocoder=voc_s, steady_hops=k, encoder_of_steady_hops=enc_s)
    results["kv_trace"] = _trace(lambda: kv.stream_decode(tokens))
    results["kv_encoder_trace"] = _trace(encoder_hops)
    keys = ["kv_stages_s", "kv_trace", "kv_encoder_trace"]
    if seg_iters:
        seg = functools.partial(kv.stream_decode, tokens, output="int16",
                                segmented=True, seg_iters=seg_iters)
        seg()                                              # warm-up
        walls = [_wall(seg)[0] for _ in range(3)]
        results["kv_segmented_s"] = dict(
            seg_iters=seg_iters, wall=statistics.median(walls), walls=walls,
            segments=len(kv._seg_sizes(k + kv.s_steps - 1, seg_iters)))
        results["kv_segmented_trace"] = _trace(seg)
        keys += ["kv_segmented_s", "kv_segmented_trace"]
    for key in keys:
        print(json.dumps({key: results[key]}))


def _bench_decoder() -> AudioDecoder:
    """The configuration ``bench.py`` runs, bf16, seeded weights."""
    flow_cfg = C.moss_flow_config()
    flow_cfg = dataclasses.replace(flow_cfg, cfm=dataclasses.replace(
        flow_cfg.cfm, max_noise_len=4096))
    hift_cfg = C.moss_hift_config()
    return AudioDecoder(flow_cfg, hift_cfg,
                        *seeded_states(flow_cfg, hift_cfg),
                        C.PipelineConfig(block_size=5, mel_cache_len=8,
                                         max_token_len=40),
                        compute_dtype=torch.bfloat16)


# the windowed device session's step kinds by stage
_FLOW_STEPS = ("flow", "fbatch", "fscan", "fused")


def _windowed_profile(tokens: np.ndarray, results: dict,
                      graphs: bool) -> None:
    """Stages and trace of the windowed device session's decode: each step
    timed alone (a synchronize after it), summed by kind and by stage."""
    sess = _bench_decoder().device_stream_decoder(graphs=graphs)
    sess.stream_decode(tokens)                  # warm-up, captures the graphs
    keys = sess.dispatches(tokens.shape[1])
    passes = []
    for _ in range(3):
        by_kind = dict.fromkeys(sorted({k[0] for k in keys}), 0.0)
        with torch.inference_mode():
            sess._token_buf(tokens)
            sess.init_state()
            for key in keys:
                wall, _ = _wall(functools.partial(sess._launch, key))
                by_kind[key[0]] += wall
        passes.append(by_kind)
    med = {k: statistics.median(p[k] for p in passes) for k in passes[0]}
    results["windowed_stages_s"] = dict(
        graphs=sess._graphs, steps=len(keys), distinct_steps=len(set(keys)),
        dispatches=[str(k) for k in keys], by_kind=med, passes=passes,
        flow=sum(v for k, v in med.items() if k in _FLOW_STEPS),
        vocoder=sum(v for k, v in med.items() if k not in _FLOW_STEPS))
    results["windowed_trace"] = _trace(
        lambda: sess.stream_decode(tokens, output="int16"))
    for key in ("windowed_stages_s", "windowed_trace"):
        print(json.dumps({key: results[key]}))


def _offline_profile(args, results: dict) -> None:
    """Stages and traces of ``token2wav`` and ``stream_inference``."""
    flow_cfg = C.moss_flow_config()
    flow_cfg = dataclasses.replace(flow_cfg, estimator=dataclasses.replace(
        flow_cfg.estimator, use_flash_attention=True))
    hift_cfg = C.moss_hift_config()
    dec = AudioDecoder(flow_cfg, hift_cfg,
                       *seeded_states(flow_cfg, hift_cfg),
                       compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, flow_cfg.vocab_size, (1, args.tokens))
    none = dec._defaults(None, None, None)

    dec.token2wav(tokens)                                  # warm-up
    flow_s, mel = _wall(lambda: dec._flow_mel(tokens, *none, False, True))
    hift_s, _ = _wall(lambda: dec._hift(mel, np.zeros((1, 0, 1),
                                                      np.float32)))
    results["token2wav_stages_s"] = dict(flow=flow_s, hift=hift_s)
    results["token2wav_trace"] = _trace(lambda: dec.token2wav(tokens))
    print(json.dumps({"token2wav_stages_s": results["token2wav_stages_s"]}))
    print(json.dumps({"token2wav_trace": results["token2wav_trace"]}))

    stream = rng.randint(0, flow_cfg.vocab_size, (1, args.stream_tokens))
    dec.stream_inference(stream)                           # warm-up
    window = stream[:, -dec.pipe_cfg.max_token_len:]
    flow_s, mel = _wall(lambda: dec._flow_mel(window, *none, True, False))
    hift_s, _ = _wall(lambda: dec._hift(mel, np.zeros((1, 0, 1),
                                                      np.float32)))
    results["window_stages_s"] = dict(window_tokens=window.shape[1],
                                      flow=flow_s, hift=hift_s)
    results["stream_trace"] = _trace(lambda: dec.stream_inference(stream))
    print(json.dumps({"window_stages_s": results["window_stages_s"]}))
    print(json.dumps({"stream_trace": results["stream_trace"]}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=250)
    ap.add_argument("--stream-tokens", type=int, default=40)
    ap.add_argument("--kv", action="store_true",
                    help="profile the KV session's stream_decode instead")
    ap.add_argument("--enc-kernel", action="store_true",
                    help="with --kv: the encoder hop on the conformer group "
                         "kernel (kv_stream_decoder(enc_kernel=True))")
    ap.add_argument("--seg", type=int, nargs="?", const=32,
                    help="with --kv: also the segmented wavefront, N "
                         "iterations a segment (default 32)")
    ap.add_argument("--no-fused", action="store_true",
                    help="with --kv: the concat dataflow (fused=False)")
    ap.add_argument("--onehot", action="store_true",
                    help="with --kv: the one-hot write "
                         "(write_mode='onehot')")
    ap.add_argument("--windowed-device", action="store_true",
                    help="profile the windowed device session's "
                         "stream_decode instead (device_stream_decoder())")
    ap.add_argument("--no-graphs", action="store_true",
                    help="with --kv or --windowed-device: run the session's "
                         "steps eagerly (graphs=False)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = dict(card=card_line(), torch=torch.__version__,
                   cuda=torch.version.cuda, tokens=args.tokens)
    tokens = np.random.RandomState(0).randint(
        0, C.moss_flow_config().vocab_size, (1, args.tokens))
    if args.kv:
        _kv_profile(tokens, results, args.enc_kernel, not args.no_graphs,
                    args.seg, not args.no_fused, args.onehot)
    elif args.windowed_device:
        _windowed_profile(tokens, results, not args.no_graphs)
    else:
        _offline_profile(args, results)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
