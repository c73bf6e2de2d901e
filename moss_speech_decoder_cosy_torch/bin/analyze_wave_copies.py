"""Copy audit of one wavefront iteration, the counterpart of the JAX
package's ``bin/analyze_wave_hlo.py``.

    python -m moss_speech_decoder_cosy_torch.bin.analyze_wave_copies \
        [--block 5] [--ring 35] [--seconds 20] [--engine kernel|fused|
        concat|onehot] [--config moss|tiny] [--device cuda|cpu]

JAX's tool reads the optimized HLO of the wavefront scan and attributes
every ``copy`` in the loop body by shape and bytes (XLA double-buffering
the scan-carried rings).  PyTorch has no HLO, but the question stands on
the card: how many bytes of copies one wavefront iteration makes, and of
which shapes.  The tool runs one eager steady iteration of the KV session
(``_wave_step_impl`` with the encoder hop, the session's engine, after a
warm-up decode) under ``torch.profiler`` with ``record_shapes`` and a
dispatch mode that sees each op's tensors (the profiler does not size a
``cat``'s list of inputs), and attributes each ``copy_`` / ``clone`` /
``_to_copy`` (a cast) / ``cat`` / ``index_copy_`` / ``index_put_`` /
``scatter_`` by shape, dtype and the bytes it writes; it counts the
profiler's copy events and the device memcpys beside them.  A fused
kernel's in-place ring writes are no copy and are not counted.

Prints one JSON line: ``copies`` (ops), ``bytes_per_iter``, ``by_shape``
(the 12 largest, bytes), ``by_op`` ({op: [count, bytes]}),
``profiler_copy_events``, ``memcpy`` (device memcpys, on a card), and the
geometry.
"""

from __future__ import annotations

import argparse
import collections
import json

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .profile_wave import ENGINES
from .tool_setup import common_args, seeded_decoder, sync

# the copy ops (aten names), each with the argument that holds the data
# it moves (None: its output)
COPY_OPS = {"copy_": 1, "clone": None, "_to_copy": None, "cat": None,
            "index_copy_": 3, "index_put_": 2, "scatter_": 3}


class _Copies(TorchDispatchMode):
    """Records each copy op that runs under it: (op, dtype, shape,
    bytes)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in COPY_OPS:
            i = COPY_OPS[name]
            t = out if i is None else args[i]
            if isinstance(t, torch.Tensor):
                self.seen.append((name, str(t.dtype).split(".")[-1],
                                  tuple(t.shape),
                                  t.numel() * t.element_size()))
        return out


def parse_args(argv=None):
    p = common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--block", type=int, default=5)
    p.add_argument("--ring", type=int, default=35)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--engine", choices=sorted(ENGINES), default="kernel")
    return p.parse_args(argv)


def summarize(seen) -> dict:
    """``_Copies.seen`` by shape / dtype and by op."""
    by_shape, by_op = collections.Counter(), {}
    for name, dtype, shape, size in seen:
        by_shape[f"{dtype}{list(shape)}"] += size
        c = by_op.setdefault(name, [0, 0])
        c[0] += 1
        c[1] += size
    return dict(copies=len(seen), bytes_per_iter=int(sum(by_shape.values())),
                by_shape={k: int(v) for k, v in by_shape.most_common(12)},
                by_op=by_op)


def audit(kv, tokens: np.ndarray) -> dict:
    """One steady wavefront iteration of ``kv`` (a session of
    ``graphs=False``) profiled: its copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kv.stream_decode(tokens)                          # warm-up
    buf = kv._token_buf(tokens)
    cache, _ = kv.init_state()
    plan = kv.schedule(tokens.shape[1])
    k = sum(1 for _, fin in plan if not fin)
    kv._wave_enter(cache, k)
    kv._wave_iters(k, 0, kv.s_steps)       # the ODE's ramp-up, untraced
    acts = [ProfilerActivity.CPU]
    if kv.dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(kv.dev)
    copies = _Copies()
    with profile(activities=acts, record_shapes=True) as prof:
        with copies:
            kv._wave_step_impl(True)
        sync(kv.dev)
    kv._wave_iters(k, kv.s_steps + 1, k + kv.s_steps - 1)
    kv._wave_exit(cache, k)
    out = summarize(copies.seen)
    events = prof.events()
    out["profiler_copy_events"] = sum(
        1 for e in events if e.name.startswith("aten::")
        and e.name[6:] in COPY_OPS)
    out["memcpy"] = sum(1 for e in events if e.device_type ==
                        DeviceType.CUDA and "memcpy" in e.name.lower())
    return out


@torch.inference_mode()
def main(argv=None):
    args = parse_args(argv)
    from ..utils.device import resolve_device
    dev = resolve_device(args.device)
    dec = seeded_decoder(args.config, dev)
    n = int(args.seconds * 12.5)
    tokens = np.random.RandomState(0).randint(0, dec.flow_cfg.vocab_size,
                                              (1, n))
    kv = dec.kv_stream_decoder(token_cap=n + 16, block_size=args.block,
                               ring_tokens=args.ring, graphs=False,
                               **ENGINES[args.engine])
    out = dict(block=args.block, ring=args.ring, engine=args.engine,
               dtype=str(kv.est_dt).split(".")[-1], **audit(kv, tokens))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
