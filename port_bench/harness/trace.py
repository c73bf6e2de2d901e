"""Spans on the host clock and a device trace of a slice of the window.

``Spans`` records named intervals around the calls the drivers make into the
program's layers (the benchmark's own spans: the program has none yet).

``DeviceTrace`` runs ``torch.profiler`` (CPU and CUDA activity) over a slice
of the window, between marker kernels: a trace misses the kernels near the
edges of its window (on an H100 the first 1-40 ms), so markers, each behind
a synchronize and a 2 ms host wait, run for ``EDGE_S`` before the slice and
after it, and only what lies between the last leading marker and the first
trailing one is read.  It reads the raw events (building the event tree of
some 10^5 events takes minutes).  Copied from the port's
``utils/graphs.profiled_window`` and ``trace_tables``, so a change there
does not change the benchmark.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

MARKER = "spin_kernel"          # the kernel ``torch.cuda._sleep`` launches
EDGE_S = 0.25
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")
# the profiler's own host events, never what the program was doing
PROFILER_EVENTS = ("Activity Buffer Request", "Buffer Flush")


class Spans:
    """Named host-clock intervals: ``with spans.span(name): ...``."""

    def __init__(self):
        self.items: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.items[name].append((t, time.perf_counter()))


def _markers(torch) -> None:
    t = time.perf_counter()
    while time.perf_counter() - t < EDGE_S:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.002)


class DeviceTrace:
    """``start()`` and ``stop()`` bracket the traced slice; both block on
    the device.  After ``stop()``, ``result()`` reads the trace."""

    def __init__(self):
        import torch
        self.torch = torch
        self.prof = None
        self.t_start = self.t_stop = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        _markers(torch)
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        _markers(torch)
        self.prof.__exit__(None, None, None)

    def result(self) -> Dict:
        """The slice's device intervals and host calls: ``busy_s``,
        ``window_s``, ``kernels`` {name: [count, seconds]}, ``launches``
        {call: count}, ``breakdown`` and ``edges`` (whether markers were
        traced on both sides of the slice's work)."""
        from torch.autograd import DeviceType
        dev, host, marks = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                s, d = e.start_ns(), e.duration_ns()
                if MARKER in name:
                    marks.append((s, s + d))
                elif d > 0:
                    dev.append((s, s + d, name))
            elif name not in PROFILER_EVENTS:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                             name))
        return analyse(dev, host, marks)


def analyse(dev: List[Tuple[int, int, str]], host: List[Tuple[int, int, str]],
            marks: List[Tuple[int, int]]) -> Dict:
    """Reduces raw device events (start ns, end ns, name), host events and
    marker intervals to the slice's numbers.  The slice is the time between
    the last marker that ends before the first work and the first marker
    that starts after the last work."""
    out: Dict = {"edges": (False, False)}
    if not dev:
        out.update(busy_s=0.0, window_s=0.0, kernels={}, launches={},
                   breakdown={"device_ops": [], "idle_gaps": []})
        return out
    first = min(s for s, _, _ in dev)
    last = max(e for _, e, _ in dev)
    before = [e for s, e in marks if e <= first]
    after = [s for s, e in marks if s >= last]
    lo = max(before) if before else first
    hi = min(after) if after else last
    out["edges"] = (bool(before), bool(after))
    kernels: Dict[str, List] = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
    # the union of the device intervals, and the gaps between them
    busy, gaps = 0, []
    cur_s, cur_e = lo, lo
    for s, e, _ in sorted(dev):
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    launches: Dict[str, int] = {}
    for s, e, name in host:
        if name in LAUNCH_CALLS and lo <= s <= hi:
            launches[name] = launches.get(name, 0) + 1
    out.update(busy_s=busy * 1e-9, window_s=(hi - lo) * 1e-9,
               kernels=kernels, launches=launches,
               breakdown=breakdown(kernels, gaps, host))
    return out


def _doing(starts, ends, names, t: int) -> str:
    """The innermost host event that spans ``t``, else "host idle"."""
    hit = np.nonzero((starts <= t) & (ends >= t))[0]
    if hit.size == 0:
        return "host idle"
    return names[int(hit[np.argmin(ends[hit] - starts[hit])])]


def breakdown(kernels: Dict[str, List], gaps: List[Tuple[int, int]],
              host: List[Tuple[int, int, str]], n: int = 10) -> Dict:
    """The ``n`` device operations with the most time, and the device's idle
    time by what the host was doing at the middle of each gap (the ``4 n``
    longest gaps looked up, summed by that name, the ``n`` largest kept)."""
    ops = sorted(((k, v[1]) for k, v in kernels.items()), key=lambda x: -x[1])
    starts = np.array([h[0] for h in host], dtype=np.int64)
    ends = np.array([h[1] for h in host], dtype=np.int64)
    names = [h[2] for h in host]
    by_name: Dict[str, float] = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:4 * n]:
        by_name[_doing(starts, ends, names, (s + e) // 2)] += (e - s) * 1e-9
    idle = sorted(by_name.items(), key=lambda x: -x[1])
    return {"device_ops": [[k, v] for k, v in ops[:n]],
            "idle_gaps": [[k, v] for k, v in idle[:n]]}
