"""Tracing, latency accounting and the port's telemetry store, after the
JAX package's ``utils/profiling.py`` (the reference has only manual latency
prints, server.py:81, cal_RTF cuda events).

- ``trace(log_dir)``: ``torch.profiler`` over the block (CPU activities,
  plus CUDA's when a card is present), written into ``log_dir`` as a Chrome
  trace (Perfetto / chrome://tracing).  On a card the block runs inside
  ``utils.graphs.profiled_window``, between marker kernels (ROADMAP C4: a
  trace misses its first 1-40 ms on the H100), and ``trace`` raises if the
  trace does not hold every kernel of the block.
- ``annotate(name)``: a named region in the trace (``record_function``),
  and an NVTX range on a card.
- ``LatencyStats``: rolling per-name latency samples with p50 / p95
  (``measure``, ``summary``), and the telemetry store: spans, counters and
  per-request stamps kept in bounded rings in memory.  ``TELEMETRY`` is the
  process's one store; the decode server's engine, the continuous batcher
  and ``StepGraphs`` record into it, and readers take what they need from
  it after the work (``port_bench/metrics/``).

A span is (id, name, start, end, parent span id, request id) on
``time.perf_counter()``; the parent is the span open in the same thread or
asyncio task.  ``span(name, device=dev)`` also records a pair of CUDA
events on ``dev``'s current stream at its edges; its ``device_ms`` is
filled in later, without a synchronize, once both events have passed (or
by ``resolve(wait=True)`` when the store is read).  While ``torch.profiler``
records, and only then, each span also opens ``annotate(name)``, so the
trace names the host's time by the program's spans (not a span held across
an ``await``, ``annotated=False``: its thread runs other tasks meanwhile).
``enabled`` (on by default) is the one switch: off, nothing is recorded.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Callable, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

# the id of the span open in this thread or asyncio task
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "telemetry_span", default=None)


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


class Span(NamedTuple):
    """One recorded span: ``t0`` / ``t1`` on ``time.perf_counter()``,
    ``parent`` the id of the span open when it started (or None), ``rid``
    the request id (or None), ``device_ms`` the device time between its
    CUDA events (None without events, or before they are resolved)."""
    id: int
    name: str
    t0: float
    t1: float
    parent: Optional[int]
    rid: Optional[int]
    device_ms: Optional[float]

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class _Open:
    """A span being recorded (what ``LatencyStats.span`` hands out)."""

    __slots__ = ("id", "name", "rid", "t0", "_store", "_device", "_token",
                 "_note", "_start", "_annotated")

    def __init__(self, store: "LatencyStats", name: str, rid, device,
                 annotated: bool):
        self._store, self.name, self.rid, self._device = (store, name, rid,
                                                          device)
        self._annotated = annotated
        self.id = next(store._ids)
        self._note = self._start = None

    def __enter__(self) -> "_Open":
        self._token = _CURRENT.set(self.id)
        if self._annotated and _autograd_profiler._is_profiler_enabled:
            self._note = annotate(self.name)
            self._note.__enter__()
        if self._device is not None:
            self._start = self._store._event(self._device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        store = self._store
        if self._start is not None:
            store._pend(self.id, self._start, store._event(self._device),
                        self._device)
        t1 = time.perf_counter()
        _CURRENT.reset(self._token)
        parent = _CURRENT.get()
        if self._note is not None:
            self._note.__exit__(*exc)
        store._ring(self.name).append((self.id, self.t0, t1, parent,
                                       self.rid))
        return False


class _Off:
    """The span a disabled store hands out: records nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class LatencyStats:
    """Rolling per-name latency samples (``measure``, ``summary``), and the
    port's telemetry store (the module docstring): spans in one bounded
    ring per name (``span_capacity`` each), counters with their timed
    increments in one bounded ring per name, and per-request stamps for
    the last ``request_capacity`` requests."""

    def __init__(self, capacity: int = 1024, span_capacity: int = 1 << 16,
                 request_capacity: int = 1 << 14):
        self.capacity = capacity
        self.samples: Dict[str, List[float]] = {}
        self.enabled = True
        self.span_capacity = span_capacity
        self.request_capacity = request_capacity
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self.clear()

    def clear(self) -> None:
        """Drops every span, counter and request recorded so far (events
        not yet resolved are dropped with their spans)."""
        with self._lock:
            # name -> ring of (id, t0, t1, parent, rid)
            self._rings: Dict[str, Deque[tuple]] = {}
            self._device_ms: Dict[int, float] = {}
            self.counters: Dict[str, float] = {}
            self._incs: Dict[str, Deque[Tuple[float, float]]] = {}
            self.requests: "collections.OrderedDict[int, Dict]" = \
                collections.OrderedDict()
            self._pending: List[tuple] = []   # (id, start, end, device)
            self._free_events: Dict[object, list] = {}

    # ------------------------------------------------------------- spans
    def span(self, name: str, rid: Optional[int] = None, device=None,
             annotated: bool = True):
        """A context manager that records a span ``name``; spans opened
        inside it (in this thread or asyncio task) are its children.
        ``device``: a ``torch.device`` whose current stream gets a CUDA
        event at each edge (CUDA only, never inside a graph capture).
        ``annotated=False`` for a span held across an ``await``: its thread
        runs other tasks meanwhile, so it opens no region in a trace."""
        if not self.enabled:
            return _OFF
        if device is not None and (
                device.type != "cuda"
                or torch.cuda.is_current_stream_capturing()):
            device = None
        return _Open(self, name, rid, device, annotated)

    def call(self, name: str, fn: Callable[[], object]):
        """``fn()`` recorded as a span ``name`` with no children (the cheap
        path of ``span``: no context of its own while no profiler
        records)."""
        if not self.enabled:
            return fn()
        if _autograd_profiler._is_profiler_enabled:
            with self.span(name):
                return fn()
        t = time.perf_counter()
        out = fn()
        self.add(name, t, time.perf_counter())
        return out

    def add(self, name: str, t0: float, t1: float,
            rid: Optional[int] = None) -> None:
        """Records a span whose edges the caller stamped; its parent is the
        span open here now."""
        if self.enabled:
            self._ring(name).append((next(self._ids), t0, t1,
                                     _CURRENT.get(), rid))

    def _ring(self, name: str) -> Deque[tuple]:
        ring = self._rings.get(name)
        if ring is None:
            ring = self._rings.setdefault(
                name, collections.deque(maxlen=self.span_capacity))
        return ring

    def names(self) -> List[str]:
        return list(self._rings)

    def spans(self, name: str) -> List[Span]:
        """The spans named ``name`` still in their ring, oldest first."""
        dev = self._device_ms
        return [Span(i, name, t0, t1, parent, rid, dev.get(i))
                for i, t0, t1, parent, rid in list(self._rings.get(name, ()))]

    def children(self, span: Span) -> List[Span]:
        return [s for n in self.names() for s in self.spans(n)
                if s.parent == span.id]

    def self_s(self, span: Span) -> float:
        """The span's duration less the part of it its children cover."""
        ivs = sorted((max(c.t0, span.t0), min(c.t1, span.t1))
                     for c in self.children(span))
        covered, end = 0.0, span.t0
        for a, b in ivs:
            a = max(a, end)
            if b > a:
                covered += b - a
                end = b
        return span.duration_s - covered

    # ------------------------------------------------------- device time
    def _event(self, device):
        free = self._free_events.get(device)
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def _pend(self, sid: int, start, end, device) -> None:
        with self._lock:
            self._pending.append((sid, start, end, device))
            n = len(self._pending)
        if n >= 32:
            self.resolve()

    def resolve(self, wait: bool = False) -> None:
        """Fills in the device time of the spans whose end event has passed
        (``wait``: of every span, synchronizing on each end event)."""
        with self._lock:
            pending, self._pending = self._pending, []
        keep, done = [], []
        for sid, start, end, device in pending:
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append((sid, start, end, device))
                continue
            done.append((sid, start.elapsed_time(end)))
            self._free_events.setdefault(device, []).extend((start, end))
        with self._lock:
            self._pending[:0] = keep
            self._device_ms.update(done)
            while len(self._device_ms) > self.span_capacity:
                del self._device_ms[next(iter(self._device_ms))]

    # ---------------------------------------------------------- counters
    def count(self, name: str, n: float = 1) -> None:
        """Adds ``n`` to counter ``name``; the increment is kept with its
        time (``increments``)."""
        if not self.enabled:
            return
        t = time.perf_counter()
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
            inc = self._incs.get(name)
            if inc is None:
                inc = self._incs[name] = collections.deque(
                    maxlen=self.span_capacity)
            inc.append((t, n))

    def increments(self, name: str) -> List[Tuple[float, float]]:
        """(time, n) of the counter's increments still in its ring."""
        return list(self._incs.get(name, ()))

    # ---------------------------------------------------------- requests
    def request(self) -> Optional[int]:
        """A new request id, its record stamped ``open`` now (None when the
        store is off)."""
        if not self.enabled:
            return None
        rid = next(self._ids)
        self.requests[rid] = {"open": time.perf_counter()}
        while len(self.requests) > self.request_capacity:
            self.requests.popitem(last=False)
        return rid

    def stamp(self, rid: Optional[int], key: str,
              t: Optional[float] = None) -> None:
        """Stamps ``key`` of request ``rid``'s record (now by default)."""
        rec = self.requests.get(rid)
        if rec is not None:
            rec[key] = time.perf_counter() if t is None else t

    def note(self, rid: Optional[int], **fields) -> None:
        """Sets fields of request ``rid``'s record."""
        rec = self.requests.get(rid)
        if rec is not None:
            rec.update(fields)

    # -------------------------------------------------- latency samples
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


# the process's telemetry store: the engine, the batcher and StepGraphs
# record into it; readers run after them
TELEMETRY = LatencyStats()
