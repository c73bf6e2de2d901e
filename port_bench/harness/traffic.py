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
     "vocab": 16384, "speaker_dim": 192,
     "prompt": {"dist": "uniform", "min": 8, "max": 24, "strata": 8,
                "vocab": 151936}}

``clients`` clients run a closed loop with no think time: each sends its
next request when its last one has ended.

``dist`` is ``lognormal`` (``median``, ``sigma``) or ``uniform`` (between
``min`` and ``max``); lengths are clipped to [min, max].  Token ids are
uniform over ``vocab``; each request has its own speaker vector, standard
normal of ``speaker_dim`` (none where the file has no ``speaker_dim``).

The optional ``prompt`` block gives each request a prompt: its lengths are
stratified as the tokens' are, its ids uniform over the block's ``vocab``.
Its draws come from generator keys of their own, so a file without the block
sends the same requests as before it existed, and with it the same tokens
and speakers; ``Request.prompt`` is empty without it.
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
    prompt: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))      # (p,) int32

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
        self._prompt = traffic.get("prompt")
        self._prompt_block = (None if self._prompt is None
                              else lengths(self._prompt))
        self._orders: Dict[tuple, np.ndarray] = {}

    def _rng(self, *key: int) -> np.random.Generator:
        # keys: (0, block) the lengths' order, (1, i) tokens and speaker,
        # (2, block) the prompt lengths' order, (3, i) the prompt's ids
        return np.random.default_rng([self.seed, *key])

    def _stratum(self, block: List[int], key: int, i: int) -> int:
        n = len(block)
        b = i // n
        if (key, b) not in self._orders:
            self._orders[key, b] = self._rng(key, b).permutation(n)
        return block[int(self._orders[key, b][i % n])]

    def length(self, i: int) -> int:
        return self._stratum(self._block, 0, i)

    def prompt_length(self, i: int) -> int:
        return (0 if self._prompt is None
                else self._stratum(self._prompt_block, 2, i))

    def get(self, i: int) -> Request:
        rng = self._rng(1, i)
        n = self.length(i)
        tokens = rng.integers(0, int(self.spec["vocab"]), n).astype(np.int32)
        speaker = rng.standard_normal(int(self.spec.get(
            "speaker_dim", 0))).astype(np.float32)
        req = Request(i, tokens, speaker)
        if self._prompt is not None:
            req.prompt = self._rng(3, i).integers(
                0, int(self._prompt["vocab"]), self.prompt_length(i)).astype(
                    np.int32)
        return req
