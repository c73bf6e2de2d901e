"""The KV session's wavefront alone, per engine and geometry, after the JAX
package's ``bin/profile_wave.py``.

    python -m moss_speech_decoder_cosy_torch.bin.profile_wave \
        [--seconds 20] [--configs kernel:5:35,concat:10:30,...] \
        [--runs 5] [--dtype bf16|f32] [--no-graphs] \
        [--config moss|tiny] [--device cuda|cpu]

Times only ``stream_decode``'s wavefront and its finalize tail
(``KVStreamDecoder._flow_mels_wave``: the rings brought into the
wavefront's layout, the k + S - 1 live iterations, the rings back, the
finalize hop), isolating the per-iteration cost from the bulk vocoder and
the copy back that every geometry shares.  A spec is
``engine:block:ring`` (ring in tokens):

- ``kernel``: ``kernel=True``, each resnet + transformer group one
  ``fused_tf_group`` launch (the session's default engine);
- ``enc_kernel``: the same plus the encoder hop through
  ``fused_conformer_group``;
- ``fused``: the write-then-attend dataflow on the unfused engine;
- ``concat``: ``fused=False`` (the JAX package's ``dus``: attention over
  [ring ++ chunk], shared-offset writes);
- ``onehot``: ``fused=False, write_mode="onehot"`` (per-row writes).

The default sweep is the JAX package's ``DEFAULT_CONFIGS`` with its
``dus`` engine as the port's ``concat``.  A geometry the kernel cannot run
(in bf16 a chunk over 32 frames, so block 10's 40 frames) is reported
with ``kernel_limit``'s reason and no time: the tool never times another
engine under the kernel's name.

One JSON line per spec: ``engine``, ``block``, ``ring``, ``graphs``,
``iters`` (live iterations), ``scan_s`` (median wall), ``ms_per_iter``,
``scan_rtf`` (wall / audio seconds), ``runs`` (every wall), ``launches``
(``fused_tf_group`` a run), or ``kernel_limit``.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from .tool_setup import DTYPES, common_args, seeded_decoder, sync, wall

DEFAULT_CONFIGS = ("concat:5:35", "onehot:5:35", "concat:10:30",
                   "concat:5:70", "concat:10:70")
ENGINES = {
    "kernel": dict(kernel=True),
    "enc_kernel": dict(kernel=True, enc_kernel=True),
    "fused": dict(fused=True, kernel=False),
    "concat": dict(fused=False),
    "onehot": dict(fused=False, write_mode="onehot"),
}


def parse_args(argv=None):
    p = common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--configs", default=",".join(DEFAULT_CONFIGS))
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--no-graphs", dest="graphs", action="store_false")
    return p.parse_args(argv)


def profile_spec(dec, spec: str, tokens: np.ndarray, seconds: float,
                 runs: int, graphs: bool) -> dict:
    """One spec's row (see the module doc)."""
    from ..ops.fused_block import launch_fused_tf_group
    from ..pipeline.kv_session import estimator_kernel_limit
    engine, block, ring = spec.split(":")
    block, ring = int(block), int(ring)
    row = dict(engine=engine, block=block, ring=ring, graphs=graphs)
    kw = ENGINES[engine]
    if kw.get("kernel"):
        cf = block * dec.ratio
        why = estimator_kernel_limit(dec.flow_cfg.estimator, cf,
                                     ring * dec.ratio + cf,
                                     dec.estimator_dtype or dec._dt())
        if why:
            row["kernel_limit"] = why
            return row
    n = tokens.shape[1]
    kv = dec.kv_stream_decoder(token_cap=n + 16, block_size=block,
                               ring_tokens=ring, graphs=graphs, **kw)
    kv.stream_decode(tokens)              # warm-up: captures the graphs
    buf = kv._token_buf(tokens)
    plan = kv.schedule(n)
    k = sum(1 for _, fin in plan if not fin)
    walls, launches = [], 0
    for _ in range(runs):
        cache, _ = kv.init_state()
        sync(kv.dev)
        launch_fused_tf_group.launches = 0
        t, _ = wall(kv.dev, lambda: kv._flow_mels_wave(buf, cache, plan))
        launches = launch_fused_tf_group.launches
        walls.append(t)
    med = statistics.median(walls)
    iters = k + kv.s_steps - 1
    row.update(iters=iters, scan_s=med, ms_per_iter=med / iters * 1e3,
               scan_rtf=med / seconds, runs=walls, launches=launches)
    return row


@torch.inference_mode()
def main(argv=None):
    args = parse_args(argv)
    from ..utils.device import resolve_device
    dev = resolve_device(args.device)
    dec = seeded_decoder(args.config, dev, DTYPES[args.dtype])
    n = int(args.seconds * 12.5)
    tokens = np.random.RandomState(0).randint(
        0, dec.flow_cfg.vocab_size, (1, n))
    rows = []
    for spec in args.configs.split(","):
        row = profile_spec(dec, spec, tokens, args.seconds, args.runs,
                           args.graphs)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
