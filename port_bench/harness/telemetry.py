"""The program's own telemetry, windowed for the per-layer readers.

The port records spans, counters and per-request stamps into one store per
process (``moss_speech_decoder_cosy_torch.utils.profiling.TELEMETRY``):
the decode server's engine, the continuous batcher and the CUDA-graph
runner.  A reader takes what started inside the window [t0, t1) and leaves
out whatever overlaps the traced slice, where the profiler slows the host.
A program without that store reads as nothing: the functions here return
empty lists or None, and the reader returns None.

Per-tick metrics divide by the ticks of the batcher's pumps that started in
the window outside the slice (``batcher.pump`` spans; the ``batcher.ticks``
counter's increments inside them).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from port_bench.harness.window import percentile


def store():
    """The program's telemetry store, or None where it has none."""
    try:
        from moss_speech_decoder_cosy_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "TELEMETRY", None)


def _clear_of_slice(run, a: float, b: float) -> bool:
    if not run.slice:
        return True
    lo, hi = run.slice
    return b < lo or a > hi


def in_window(run, spans) -> list:
    """The spans that started in the window and do not overlap the
    slice."""
    return [s for s in spans
            if run.t0 <= s.t0 < run.t1 and _clear_of_slice(run, s.t0, s.t1)]


def pumps(run) -> list:
    """The window's ``batcher.pump`` spans, oldest first."""
    tel = store()
    if tel is None:
        return []
    return sorted(in_window(run, tel.spans("batcher.pump")),
                  key=lambda s: s.t0)


def _inside(pumps_, t: float) -> bool:
    i = bisect.bisect_right([p.t0 for p in pumps_], t) - 1
    return i >= 0 and t <= pumps_[i].t1


def counted(run, name: str, pumps_) -> float:
    """The increments of counter ``name`` made inside ``pumps_``."""
    tel = store()
    if tel is None or not pumps_:
        return 0.0
    return float(sum(n for t, n in tel.increments(name)
                     if _inside(pumps_, t)))


def inside_pumps(name_prefix: str, pumps_) -> list:
    """The spans whose name starts with ``name_prefix`` and which started
    inside ``pumps_``."""
    tel = store()
    if tel is None or not pumps_:
        return []
    return [s for n in tel.names() if n.startswith(name_prefix)
            for s in tel.spans(n) if _inside(pumps_, s.t0)]


def per_tick_ms(run, total_ms: float, pumps_) -> Optional[float]:
    """``total_ms`` over the ticks of ``pumps_``."""
    ticks = counted(run, "batcher.ticks", pumps_)
    return total_ms / ticks if ticks else None


def phase_device_ms(run, name: str) -> Optional[float]:
    """The device ms of the window's pumps' ``name`` phase per tick; None
    where a phase has no device time (no CUDA events: the CPU)."""
    tel = store()
    ps = pumps(run)
    if tel is None or not ps:
        return None
    tel.resolve(wait=True)
    pump_ids = {p.id for p in ps}
    emits = [s for s in tel.spans("batcher.emit") if s.parent in pump_ids]
    # a phase is a child of its pump; a finalize tail, of its pump's emit
    parents = pump_ids | {s.id for s in emits}
    spans = [s for s in tel.spans(name) if s.parent in parents]
    if not spans or any(s.device_ms is None for s in spans):
        return None
    total = sum(s.device_ms for s in spans)
    if name == "batcher.emit":
        emit_ids = {s.id for s in spans}
        fins = [s for s in tel.spans("batcher.finalize")
                if s.parent in emit_ids]
        if any(s.device_ms is None for s in fins):
            return None
        total -= sum(s.device_ms for s in fins)
    return per_tick_ms(run, total, ps)


def requests(run) -> List[Dict]:
    """The records of the requests opened in the window that got a first
    chunk, each with its ``open`` -> ``first_chunk`` clear of the slice."""
    tel = store()
    if tel is None:
        return []
    keys = ("open", "finished", "first_chunk")
    return [r for r in list(tel.requests.values())
            if all(k in r for k in keys) and run.t0 <= r["open"] < run.t1
            and _clear_of_slice(run, r["open"], r["first_chunk"])]


def p95(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return percentile(values, 95) if values else None
