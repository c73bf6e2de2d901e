"""Phase breakdown of the KV session's ``stream_decode``, after the JAX
package's ``bin/profile_tail.py``.

    python -m moss_speech_decoder_cosy_torch.bin.profile_tail \
        [--seconds 20] [--runs 3] [--config moss|tiny] [--device cuda|cpu]

Runs the body of ``KVStreamDecoder.stream_decode(output="int16")`` (the
wavefront path) with a device fence between phases, to attribute the time
outside the wavefront: host prep, token upload, state init, (prompt
prefill,) speaker embed, wave init (the x / mu waves and the rings into
the wavefront's layout), the wavefront (its live iterations and the rings
back), finalize hop, bulk vocoder, pcm16, fetch.  Keep it in step with
``pipeline/kv_session.py``.  The session's default engine (the kernel,
bf16), graphed and ``graphs=False``: one warm-up, then the median of
``--runs`` of each phase, in ms, and the unfenced ``stream_decode`` wall
(median of ``--runs``) beside them.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from .tool_setup import common_args, seeded_decoder, sync

PHASES = ("host_prep", "upload", "init_state", "prefill", "spk",
          "wave_init", "wavefront", "finalize_hop", "vocode", "pcm16",
          "fetch")


def parse_args(argv=None):
    p = common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--runs", type=int, default=3)
    return p.parse_args(argv)


def phased(kv, tokens: np.ndarray) -> dict:
    """One fenced decode: {phase: seconds}."""
    from ..models.flow.kv_stream import spk_embedding
    from ..pipeline.bulk_voc import BulkVocoder
    from ..pipeline.kv_session import _pcm16
    dev = kv.dev
    t = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        sync(dev)
        t1 = time.perf_counter()
        t[name] = t1 - t0
        t0 = t1

    toks = np.ascontiguousarray(np.asarray(tokens))
    n = toks.shape[1]
    plan = kv.schedule(n)
    k = sum(1 for _, fin in plan if not fin)
    lap("host_prep")
    token_buf = kv._token_buf(toks)
    lap("upload")
    cache, _ = kv.init_state()
    lap("init_state")
    if kv.p:
        cache = kv._prefill(token_buf, cache)
    lap("prefill")
    kv._spks = spk_embedding(kv.dec.flow, kv._emb)
    lap("spk")
    kv._wave_enter(cache, k)
    lap("wave_init")
    s = kv.s_steps
    kv._wave_iters(k, 0, k + s - 1)
    kv._wave_exit(cache, k)
    lap("wavefront")
    mels = [kv._exit_mels(s - 1, s - 1 + k)]
    if plan[-1][1]:
        mel, cache = kv._hop(token_buf, cache, plan[-1][0], True)
        mels.append(mel)
    mel = torch.cat(mels, dim=1)
    lap("finalize_hop")
    if kv._bulk is None:
        kv._bulk = BulkVocoder(kv.dec, kv.cf)
    wav = kv._bulk.vocode(mel, [e * kv.ratio for e, _ in plan])
    lap("vocode")
    pcm = _pcm16(wav)
    lap("pcm16")
    pcm.cpu().numpy()
    lap("fetch")
    t["total"] = sum(t.values())
    return t


@torch.inference_mode()
def profile(kv, tokens: np.ndarray, runs: int) -> dict:
    """The median ms of each phase over ``runs`` fenced decodes after one
    warm-up, and the unfenced ``stream_decode`` wall."""
    kv.stream_decode(tokens, output="int16")          # captures the graphs
    phased(kv, tokens)
    laps = [phased(kv, tokens) for _ in range(runs)]
    out = {name: 1e3 * statistics.median(r[name] for r in laps)
           for name in laps[0]}
    walls = []
    for _ in range(runs):
        sync(kv.dev)
        t0 = time.perf_counter()
        kv.stream_decode(tokens, output="int16")
        walls.append(time.perf_counter() - t0)
    out["unfenced_wall_ms"] = 1e3 * statistics.median(walls)
    return out


def main(argv=None):
    args = parse_args(argv)
    from ..utils.device import resolve_device
    dev = resolve_device(args.device)
    dec = seeded_decoder(args.config, dev)
    n = int(args.seconds * 12.5)
    tokens = np.random.RandomState(0).randint(0, dec.flow_cfg.vocab_size,
                                              (1, n))
    out = dict(tokens=n, seconds=args.seconds, runs=args.runs)
    for graphs in (True, False):
        kv = dec.kv_stream_decoder(token_cap=n + 16, graphs=graphs)
        out["graphed" if graphs else "eager"] = profile(kv, tokens,
                                                        args.runs)
        out["engine"] = "kernel" if kv._kernel else "unfused"
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
