"""Window arithmetic: what the clients saw, reduced to the end-to-end metrics.

Every time is the host clock (``time.perf_counter``) of the process that runs
the clients.  A request is counted when it was sent inside the window
[t0, t1); its audio is counted where it arrived inside the window, whatever
the request.

- ``audio_x_realtime``: the seconds of audio that arrived inside the window,
  over the window's seconds: all the work over all the window.
- ``first_audio_p95_ms``: the 95th percentile, over every request sent in the
  window, of the time from sending it to its first audio.
- ``request_rtf_p95``: the 95th percentile, over the same requests, of the
  time from sending it to its last audio over its audio seconds.

Audio is counted in a driver's units at its ``sample_rate``: samples at the
vocoder's rate for a driver that serves waveforms; a driver that serves
speech tokens counts each token as 1/12.5 s of audio (``sample_rate`` 12.5,
the speech-token rate), so the three metrics keep their definitions.

A request that failed, or had not finished when the drain after the window
ended, misses both tails: it counts as infinitely late.  Percentiles are the
nearest rank: the value at rank ceil(0.95 n).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Record:
    """One request as its client saw it."""
    index: int
    n_tokens: int
    audio_s: float                      # the audio the request asks for
    t_send: float
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    error: Optional[str] = None
    chunks: List[Tuple[float, int]] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.error is None and self.t_last is not None

    def first_ms(self) -> float:
        if not self.ok or self.t_first is None:
            return math.inf
        return (self.t_first - self.t_send) * 1e3

    def rtf(self) -> float:
        if not self.ok:
            return math.inf
        return (self.t_last - self.t_send) / self.audio_s


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile ``q`` (0-100) of ``values``."""
    if not values:
        return math.inf
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return s[k - 1]


def sent_in(records: List[Record], t0: float, t1: float) -> List[Record]:
    return [r for r in records if t0 <= r.t_send < t1]


def audio_in(records: List[Record], t0: float, t1: float,
             sample_rate: int) -> float:
    """Seconds of audio that arrived inside [t0, t1)."""
    samples = sum(n for r in records for t, n in r.chunks if t0 <= t < t1)
    return samples / sample_rate


def summarize(records: List[Record], t0: float, t1: float,
              sample_rate: int) -> Dict[str, float]:
    sent = sent_in(records, t0, t1)
    return {
        "audio_x_realtime": audio_in(records, t0, t1, sample_rate)
        / (t1 - t0),
        "first_audio_p95_ms": percentile([r.first_ms() for r in sent], 95),
        "request_rtf_p95": percentile([r.rtf() for r in sent], 95),
        "attempted": len(sent),
        "failed": sum(1 for r in sent if not r.ok),
    }


@dataclasses.dataclass
class Served:
    """A finished request's inputs and the audio its client received."""
    tokens: object              # (n,) int32
    speaker: object             # (speaker_dim,) float32
    output: object              # (samples,) float32: the waveform


@dataclasses.dataclass
class RunResult:
    """What a driver's run leaves for the summary, the check and the
    per-layer metrics' readers."""
    cell: object                        # spec.Cell
    records: List[Record]
    t0: float                           # the window
    t1: float
    sample_rate: int
    spans: object = None                # trace.Spans (traced runs)
    trace: Optional[Dict] = None        # trace.DeviceTrace.result()
    slice: Optional[Tuple[float, float]] = None   # the traced slice
    counters: Dict = dataclasses.field(default_factory=dict)
    t_done: Optional[float] = None      # the last request sent has ended
