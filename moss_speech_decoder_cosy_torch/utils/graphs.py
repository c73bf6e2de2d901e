"""Steps on persistent state replayed as CUDA graphs (``StepGraphs``): the
runner of the flow sessions (``pipeline/kv_session.py``,
``pipeline/device_session.py``, ``pipeline/kv_batcher.py``), the speech
LM's ``generate``, the LM batcher (``serving/lm_server.py``) and the ASR
decodes (``tokenizer/asr_decoder.py``); and ``profiled``, a trace that
shows it holds every kernel of the work it traced."""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops.fused_block import launch_fused_tf_group
from ..ops.fused_conformer import launch_fused_conformer_group
from .flops import DispatchMeter
from .profiling import TELEMETRY

# the wrappers whose launch counts a replayed graph adds to
_COUNTERS = (launch_fused_tf_group, launch_fused_conformer_group)
# the kernel ``torch.cuda._sleep`` launches: ``profiled``'s window markers
MARKER = "spin_kernel"
# how long ``profiled`` runs markers before and after the work: on an H100
# recording started up to ~40 ms after the window opened (a process that
# had just traced 648k events), and once lost the last kernel before it
# closed
EDGE_S = 0.25


def _raw_events(prof):
    """The profile's raw events, read without building its event tree
    (``prof.events()`` takes ~1 min over the batcher's 650k events)."""
    return prof.profiler.kineto_results.events()


def _device_work(e) -> bool:
    """A device-side event that is work: not the device-side copy of a
    ``record_function`` region (the telemetry store's spans open one while
    a profiler records), which spans the kernels it encloses."""
    from torch.autograd import DeviceType
    return e.device_type() == DeviceType.CUDA and not (
        hasattr(e, "is_user_annotation") and e.is_user_annotation())


def trace_tables(prof) -> Tuple[Dict[str, list], Dict[str, int]]:
    """({name: [count, device seconds]} of the device-side events with a
    duration (kernels, copies, fills; the markers left out), {name: count}
    of the host's launch calls (``cudaLaunchKernel*``,
    ``cudaGraphLaunch``)), from the raw events."""
    from torch.autograd import DeviceType
    kernels: Dict[str, list] = {}
    launches: Dict[str, int] = {}
    for e in _raw_events(prof):
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if _device_work(e) and MARKER not in name and e.duration_ns() > 0:
                k = kernels.setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += e.duration_ns() * 1e-9
        elif name.startswith("cuda") and "Launch" in name:
            launches[name] = launches.get(name, 0) + 1
    return kernels, launches


@contextlib.contextmanager
def profiled_window():
    """The block under ``torch.profiler`` (CPU and CUDA), its device work
    between marker kernels (``MARKER``).  A trace misses the kernels near
    the edges of its window (on an H100 the first 1-40 ms, and once the
    last kernel), so markers, each behind a synchronize and a 2 ms host
    wait, run for ``EDGE_S`` before the block and after it.  Yields a dict
    that holds, after the block, ``profile``, ``wall_s`` (the block's wall
    to its last kernel) and ``edges`` (whether a marker was traced before
    the block's first kernel, and one after its last; with both, every
    kernel the block ran is in the trace)."""
    from torch.profiler import ProfilerActivity, profile

    def markers():
        t = time.perf_counter()
        while time.perf_counter() - t < EDGE_S:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.002)

    rec = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        markers()
        t0 = time.perf_counter()
        yield rec
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        markers()
    work, marks = [], []
    for e in _raw_events(prof):
        if _device_work(e):
            (marks if MARKER in e.name() else work).append(e.start_ns())
    rec["profile"] = prof
    if not work:
        rec["edges"] = (bool(marks), bool(marks))
    else:
        rec["edges"] = (bool(marks) and min(marks) < min(work),
                        bool(marks) and max(marks) > max(work))


def profiled(fn: Callable[[], None]) -> Tuple[object, float, Tuple[bool,
                                                                   bool]]:
    """One call of ``fn`` in a ``profiled_window``: (the profile, the wall
    of ``fn`` to its last kernel, the window's edges proved)."""
    with profiled_window() as rec:
        fn()
    return rec["profile"], rec["wall_s"], rec["edges"]


class StepGraphs:
    """Steps on persistent state, replayed as CUDA graphs.  ``run(key, fn)``
    runs ``fn`` eagerly when graphs are off (or the device is not CUDA);
    else the first call of each ``key`` runs it eagerly on the capture
    stream and captures it, and later calls replay the graph.  Each graph's
    fused-kernel launches are counted at capture and added to the kernels'
    counters at every replay.  A failed capture raises.  With a ``meter``
    enabled (``utils/flops.py``), each key's first call runs eagerly inside
    a FLOP tally and every call is counted.  Every graph is
    captured into one memory pool, so their temporaries share memory: a step
    writes its results into persistent buffers (``fn`` returns nothing) and
    the graphs replay one at a time on one stream.

    ``captures`` and ``replays`` count each key's captures and replays
    (without graphs ``captures`` counts each key's first call, the call
    that would capture); each replay is a span ``graphs.<key[0]>`` of the
    telemetry store (``utils/profiling.TELEMETRY``), the host's side of the
    launch."""

    def __init__(self, device: torch.device, enabled: bool,
                 meter: Optional[DispatchMeter] = None):
        self.device = device
        self.enabled = bool(enabled) and device.type == "cuda"
        self.meter = meter
        self.graphs: Dict[tuple, tuple] = {}   # key -> (graph, launches)
        self.captures: Dict[tuple, int] = collections.Counter()
        self.replays: Dict[tuple, int] = collections.Counter()
        self._stream = None
        self._pool = None

    def run(self, key: tuple, fn: Callable[[], None]) -> None:
        if self.meter is not None and self.meter.enabled:
            ran, _ = self.meter.note(key, fn)
            if ran:                    # the key's first metered call: eager
                return
        if not self.enabled:
            if key not in self.captures:
                self.captures[key] = 1
            fn()
            return
        got = self.graphs.get(key)
        if got is None:
            self.graphs[key] = self._capture(fn)
            self.captures[key] += 1
            return
        graph, launched = got
        TELEMETRY.call(f"graphs.{key[0]}", graph.replay)
        self.replays[key] += 1
        for counter, n in launched:
            counter.launches += n

    def _capture(self, fn: Callable[[], None]):
        """One eager call of ``fn`` on a side stream (this call's work, and
        the warm-up that builds the kernels and sets up cuBLAS and cuDNN
        before capture), then ``fn`` captured; returns (graph, [(counter,
        launches per replay)]).  Capture records and does not run, so the
        state stays as the eager call left it; the counters are restored."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream, main = self._stream, torch.cuda.current_stream(self.device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            fn()
        main.wait_stream(stream)
        before = [c.launches for c in _COUNTERS]
        graph = torch.cuda.CUDAGraph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with torch.cuda.graph(graph, pool=self._pool, stream=stream):
            fn()
        launched = [(c, c.launches - b) for c, b in zip(_COUNTERS, before)]
        for c, b in zip(_COUNTERS, before):
            c.launches = b
        return graph, launched
