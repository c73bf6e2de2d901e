"""Tracing and latency accounting, after the JAX package's
``utils/profiling.py`` (the reference has only manual latency prints,
server.py:81, cal_RTF cuda events).

- ``trace(log_dir)``: ``torch.profiler`` over the block (CPU activities,
  plus CUDA's when a card is present), written into ``log_dir`` as a Chrome
  trace (Perfetto / chrome://tracing).  On a card the block runs inside
  ``utils.graphs.profiled_window``, between marker kernels (ROADMAP C4: a
  trace misses its first 1-40 ms on the H100), and ``trace`` raises if the
  trace does not hold every kernel of the block.
- ``annotate(name)``: a named region in the trace (``record_function``),
  and an NVTX range on a card.
- ``LatencyStats``: rolling per-name latency samples with p50 / p95.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np
import torch


class Trace:
    """What ``trace`` yields; after the block: ``path`` (the Chrome trace
    written), ``profile`` (the ``torch.profiler`` profile) and ``wall_s``
    (the block's wall)."""

    def __init__(self, path: str):
        self.path = path
        self.profile = None
        self.wall_s = 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiles the block into ``log_dir/trace_<pid>_<ns>.json``."""
    os.makedirs(log_dir, exist_ok=True)
    out = Trace(os.path.join(log_dir, f"trace_{os.getpid()}_"
                                      f"{time.time_ns()}.json"))
    if torch.cuda.is_available():
        from .graphs import profiled_window
        with profiled_window() as rec:
            yield out
        if not all(rec["edges"]):
            raise RuntimeError("a kernel of the traced block may lie "
                               "outside the trace")
        out.profile, out.wall_s = rec["profile"], rec["wall_s"]
    else:
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            yield out
        out.wall_s = time.perf_counter() - t0
        out.profile = prof
    out.profile.export_chrome_trace(out.path)


@contextlib.contextmanager
def annotate(name: str):
    """A named region of the trace; an NVTX range too on a card."""
    from torch.profiler import record_function
    with contextlib.ExitStack() as stack:
        stack.enter_context(record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class LatencyStats:
    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            buf = self.samples.setdefault(name, [])
            buf.append(dt)
            if len(buf) > self.capacity:
                del buf[: len(buf) - self.capacity]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, buf in self.samples.items():
            a = np.asarray(buf)
            out[name] = {"n": len(a), "mean_ms": float(a.mean()),
                         "p50_ms": float(np.percentile(a, 50)),
                         "p95_ms": float(np.percentile(a, 95)),
                         "max_ms": float(a.max())}
        return out
