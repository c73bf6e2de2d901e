"""Steps on persistent state replayed as CUDA graphs (``StepGraphs``): the
runner of the flow sessions (``pipeline/kv_session.py``,
``pipeline/device_session.py``, ``pipeline/kv_batcher.py``), the speech
LM's ``generate`` and the LM batcher (``serving/lm_server.py``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..ops.fused_block import launch_fused_tf_group
from ..ops.fused_conformer import launch_fused_conformer_group
from .flops import DispatchMeter

# the wrappers whose launch counts a replayed graph adds to
_COUNTERS = (launch_fused_tf_group, launch_fused_conformer_group)


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
    the graphs replay one at a time on one stream."""

    def __init__(self, device: torch.device, enabled: bool,
                 meter: Optional[DispatchMeter] = None):
        self.device = device
        self.enabled = bool(enabled) and device.type == "cuda"
        self.meter = meter
        self.graphs: Dict[tuple, tuple] = {}   # key -> (graph, launches)
        self._stream = None
        self._pool = None

    def run(self, key: tuple, fn: Callable[[], None]) -> None:
        if self.meter is not None and self.meter.enabled:
            ran, _ = self.meter.note(key, fn)
            if ran:                    # the key's first metered call: eager
                return
        if not self.enabled:
            fn()
            return
        got = self.graphs.get(key)
        if got is None:
            self.graphs[key] = self._capture(fn)
            return
        graph, launched = got
        graph.replay()
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
