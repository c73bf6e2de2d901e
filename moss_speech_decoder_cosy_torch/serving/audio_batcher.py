"""Continuous-batching audio serving: the asyncio engine over
``pipeline/kv_batcher.py``, after the JAX package's
``serving/audio_batcher.py`` (``AudioStream``, ``AudioBatchEngine``,
``plan_lanes``).

- ``AudioBatchEngine``: admission awaits a free lane; push and finish change
  the batcher's state only under the engine lock; ONE pump task advances
  all lanes and fans the wav chunks out to per-request asyncio queues, and
  sleeps while ``KVContinuousBatcher.has_work()`` says a burst would advance
  nothing.
- ``plan_lanes``: the device-memory plan of the est ring pool: full rings,
  else int8 rings, else fewer lanes.

The HTTP front end of the JAX module (``AudioBatcherHTTPServer``,
``decode_stream_client``) is not ported: it needs ``aiohttp`` and, for its
Ogg Opus format, the serving codecs (ROADMAP items A6 and A11).
"""

from __future__ import annotations

import asyncio
import logging
from typing import AsyncIterator, Dict, Optional

import numpy as np
import torch

from ..models.flow.kv_stream import est_cache_bytes, init_kv_cache


class AudioStream:
    """One admitted request: async push / finish, and async iteration over
    its wav chunks (float32 ``(1, samples)``; it ends when the engine
    drains the lane)."""

    def __init__(self, engine: "AudioBatchEngine", lane: int):
        self._engine = engine
        self.lane = lane
        self._q: asyncio.Queue = asyncio.Queue()
        self.finished = False

    async def push(self, tokens) -> None:
        await self._engine._call(self._engine.batcher.push, self.lane,
                                 np.asarray(tokens))
        self._engine._kick()

    async def finish(self) -> None:
        self.finished = True
        await self._engine._call(self._engine.batcher.finish, self.lane)
        self._engine._kick()

    def __aiter__(self) -> AsyncIterator[np.ndarray]:
        return self

    async def __anext__(self) -> np.ndarray:
        chunk = await self._q.get()
        if chunk is None:
            raise StopAsyncIteration
        return chunk


def plan_lanes(decoder, n_lanes: int, ring_tokens: Optional[int],
               block_size: Optional[int], hbm_budget_bytes: int):
    """Device-memory plan of the est pool (the JAX package's spill policy):
    given a budget for the lanes' rings and conv caches, the cheapest
    configuration that serves ``n_lanes``:

    1. the full-precision rings (extended to ``ring + hop`` frames for the
       write-then-attend dataflow the engine's full-precision lanes run),
       if they fit;
    2. int8 rings (``ring_quant``, the concat dataflow), if they fit;
    3. else int8 rings and the lanes capped to what the budget affords (a
       request then waits for a free lane).

    Bytes are counted from tensors on the ``meta`` device (nothing is
    allocated); the extension covers the rings only, not the conv caches.
    Returns (n_lanes, ring_quant, per_lane_bytes, note)."""
    hop = block_size or decoder.pipe_cfg.block_size
    ring = (ring_tokens if ring_tokens is not None
            else decoder.pipe_cfg.max_token_len - hop)
    dt = decoder.compute_dtype or torch.float32

    def lane_bytes(quant: bool) -> int:
        est = init_kv_cache(decoder.flow_cfg, ring, dtype=dt,
                            est_dtype=decoder.estimator_dtype or dt,
                            device="meta", est_quant=quant)["est"]
        if quant:
            return est_cache_bytes(est)
        rf = ring * decoder.ratio
        ring_b = est_cache_bytes({"kv": est["kv"]})
        return (ring_b // rf * (rf + hop * decoder.ratio)
                + est_cache_bytes({"convs": est["convs"]}))

    full_b = lane_bytes(False)
    if n_lanes * full_b <= hbm_budget_bytes:
        return n_lanes, False, full_b, "full-precision rings fit"
    q_b = lane_bytes(True)
    if n_lanes * q_b <= hbm_budget_bytes:
        return (n_lanes, True, q_b,
                f"spilled to int8 rings ({full_b} -> {q_b} bytes a lane)")
    capped = max(1, hbm_budget_bytes // q_b)
    return (capped, True, q_b,
            f"int8 rings and lanes capped {n_lanes} -> {capped} (budget "
            f"{hbm_budget_bytes} bytes)")


class AudioBatchEngine:
    """Lane admission and the pump loop over one ``KVContinuousBatcher``.

    ``hbm_budget_bytes`` (optional) applies ``plan_lanes`` before the pool
    is allocated: the batcher opens with the plan's lanes and
    ``ring_quant``; the plan is kept in ``self.lane_plan``."""

    def __init__(self, decoder, n_lanes: int = 4,
                 block_size: Optional[int] = None,
                 ring_tokens: Optional[int] = None, token_cap: int = 1024,
                 pump_iters: int = 8, idle_sleep_s: float = 0.002,
                 hbm_budget_bytes: Optional[int] = None):
        ring_quant = False
        self.lane_plan = None
        if hbm_budget_bytes is not None:
            n_lanes, ring_quant, per_lane, note = plan_lanes(
                decoder, n_lanes, ring_tokens, block_size, hbm_budget_bytes)
            self.lane_plan = {"n_lanes": n_lanes, "ring_quant": ring_quant,
                              "per_lane_bytes": per_lane, "note": note}
        self.batcher = decoder.kv_batcher(
            n_lanes=n_lanes, block_size=block_size, ring_tokens=ring_tokens,
            token_cap=token_cap, ring_quant=ring_quant)
        self.decoder = decoder
        self.pump_iters = pump_iters
        self.idle_sleep_s = idle_sleep_s
        self._streams: Dict[int, AudioStream] = {}
        self._lock = asyncio.Lock()
        self._pump_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()

    async def _call(self, fn, *args):
        """Runs a (device-blocking) batcher call in the default executor
        under the engine lock, so it never races the pump."""
        loop = asyncio.get_running_loop()
        async with self._lock:
            return await loop.run_in_executor(None, lambda: fn(*args))

    def _kick(self) -> None:
        self._wake.set()

    async def open(self, prompt_token=None, prompt_feat=None,
                   embedding=None) -> AudioStream:
        """Admits a stream (awaits a free lane).  A missing prompt piece
        defaults to empty, a missing speaker embedding to zeros."""
        d = self.decoder
        if prompt_token is None:
            prompt_token = np.zeros((1, 0), np.int32)
        if prompt_feat is None:
            prompt_feat = np.zeros((1, prompt_token.shape[1] * d.ratio,
                                    d.flow_cfg.output_size), np.float32)
        if embedding is None:
            embedding = np.zeros((1, d.flow_cfg.spk_embed_dim), np.float32)
        loop = asyncio.get_running_loop()
        while True:
            async with self._lock:
                if self.batcher.free_lanes > 0:
                    lane = await loop.run_in_executor(
                        None, lambda: self.batcher.admit(
                            np.asarray(prompt_token, np.int32),
                            np.asarray(prompt_feat, np.float32),
                            np.asarray(embedding, np.float32)))
                    stream = AudioStream(self, lane)
                    self._streams[lane] = stream
                    break
            await asyncio.sleep(0.01)           # pool full: wait for a lane
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.ensure_future(self._pump_loop())
        self._kick()
        return stream

    async def _pump_loop(self):
        loop = asyncio.get_running_loop()
        try:
            while self._streams:
                async with self._lock:
                    out = None
                    if self.batcher.has_work():
                        out = await loop.run_in_executor(
                            None, lambda: self.batcher.pump(
                                max_iters=self.pump_iters))
                if out is None:
                    # nothing a burst could advance: wait for push / finish
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(self._wake.wait(),
                                               self.idle_sleep_s)
                    except asyncio.TimeoutError:
                        pass
                    continue
                for lane, chunk in out.items():
                    s = self._streams.get(lane)
                    if s is not None:
                        s._q.put_nowait(chunk)
                # the lanes pump() freed have drained
                for lane in list(self._streams):
                    if not self.batcher._lanes[lane].active:
                        self._streams.pop(lane)._q.put_nowait(None)
                await asyncio.sleep(0)
        except Exception:                       # engine failure: close all
            logging.exception("audio batcher pump failed; closing streams")
            for s in self._streams.values():
                s._q.put_nowait(None)
            self._streams.clear()
            raise
        finally:
            self._pump_task = None
