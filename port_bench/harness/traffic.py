"""The general traffic generator: a traffic file's parameters and a seed ->
the requests, one after another.

Lengths are stratified: every block of ``strata`` requests holds the same
lengths, the distribution's quantiles at (i + 1/2) / strata, and the seed
only orders them.  So every seed sends the same mix of sizes, and runs with
different seeds differ in order, token ids and speakers, not in work.  A
request's content depends on the seed and its index alone, however many
requests a run takes.

A traffic file (``traffic/<name>.json``)::

    {"clients": 16,
     "tokens": {"dist": "lognormal", "median": 100, "sigma": 0.6,
                "min": 40, "max": 375, "strata": 32},
     "vocab": 16384, "speaker_dim": 192}

``clients`` clients run a closed loop with no think time: each sends its
next request when its last one has ended.

``dist`` is ``lognormal`` (``median``, ``sigma``) or ``uniform`` (between
``min`` and ``max``); lengths are clipped to [min, max].  Token ids are
uniform over ``vocab``; each request has its own speaker vector, standard
normal of ``speaker_dim``.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    tokens: np.ndarray          # (n,) int32
    speaker: np.ndarray         # (speaker_dim,) float32

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])


def lengths(spec: Dict) -> List[int]:
    """The ``strata`` lengths of one block, in quantile order."""
    n, lo, hi = int(spec["strata"]), int(spec["min"]), int(spec["max"])
    qs = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "lognormal":
        z = statistics.NormalDist()
        raw = [spec["median"] * math.exp(spec["sigma"] * z.inv_cdf(q))
               for q in qs]
    elif spec["dist"] == "uniform":
        raw = [lo + q * (hi - lo) for q in qs]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [min(hi, max(lo, int(round(v)))) for v in raw]


class Traffic:
    """The request stream of one seed: ``get(i)`` is request ``i``."""

    def __init__(self, traffic: Dict, seed: int):
        self.spec = traffic
        self.seed = int(seed)
        self._block = lengths(traffic["tokens"])
        self._orders: Dict[int, np.ndarray] = {}

    def _rng(self, *key: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, *key])

    def length(self, i: int) -> int:
        n = len(self._block)
        b = i // n
        if b not in self._orders:
            self._orders[b] = self._rng(0, b).permutation(n)
        return self._block[int(self._orders[b][i % n])]

    def get(self, i: int) -> Request:
        rng = self._rng(1, i)
        n = self.length(i)
        tokens = rng.integers(0, int(self.spec["vocab"]), n).astype(np.int32)
        speaker = rng.standard_normal(int(self.spec["speaker_dim"])).astype(
            np.float32)
        return Request(i, tokens, speaker)
