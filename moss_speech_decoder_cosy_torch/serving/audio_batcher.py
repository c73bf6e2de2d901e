"""Continuous-batching audio serving: the asyncio engine over
``pipeline/kv_batcher.py`` and its HTTP front end, after the JAX package's
``serving/audio_batcher.py``.

- ``AudioBatchEngine``: admission awaits a free lane; push and finish change
  the batcher's state only under the engine lock; ONE pump task advances
  all lanes and fans the wav chunks out to per-request asyncio queues, and
  sleeps while ``KVContinuousBatcher.has_work()`` says a burst would advance
  nothing.  It records into the telemetry store
  (``utils/profiling.TELEMETRY``): a request id per ``open``, each request's
  stamps (``open``, ``admitted``, ``pushed``, ``finished``, ``first_chunk``,
  ``last_chunk``; its ``lane`` and ``first_ticks``), the spans
  ``engine.open`` (children ``engine.lane_wait``, ``engine.admit``),
  ``engine.push`` and ``engine.finish`` (child ``engine.lock_wait``: the
  wait for the engine lock; the rest is the call's own time), the body's
  ``engine.encode``, and ``engine.pump_gap``: the pump loop's time outside
  ``pump`` while a stream is open.  The spans held across an ``await`` open
  no region in a profiler's trace.
- ``plan_lanes``: the device-memory plan of the est ring pool: full rings,
  else int8 rings, else fewer lanes.
- ``decode_stream``: one ``POST /decode_stream`` request with no transport:
  JSON-shaped params in, (status, headers, body) out, the body an async
  iterator over the encoded audio while the decode still runs:
  ``audio/L16`` (raw little-endian int16 at the decoder's rate) or
  ``audio/ogg`` (Ogg Opus, RFC 7845).  501 where libopus is missing, 400
  for an unknown format.
- ``AudioBatcherHTTPServer``: the aiohttp shell that writes
  ``decode_stream``'s result out; ``decode_stream_client`` its client.
  aiohttp is imported only where either is built.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import logging
import time
from typing import AsyncIterator, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.flow.kv_stream import est_cache_bytes, init_kv_cache
from ..utils.profiling import TELEMETRY
from . import protocol
from .ws_server import aiohttp_module


class AudioStream:
    """One admitted request: async push / finish, and async iteration over
    its wav chunks (float32 ``(1, samples)``; it ends when the engine
    drains the lane).  ``rid``: its id in the telemetry store."""

    def __init__(self, engine: "AudioBatchEngine", lane: int,
                 rid: Optional[int] = None):
        self._engine = engine
        self.lane = lane
        self.rid = rid
        self._q: asyncio.Queue = asyncio.Queue()
        self.finished = False
        self._handed = False            # a chunk was put on the queue

    async def push(self, tokens) -> None:
        with TELEMETRY.span("engine.push", rid=self.rid, annotated=False):
            await self._engine._call(self._engine.batcher.push, self.lane,
                                     np.asarray(tokens), rid=self.rid)
        TELEMETRY.stamp(self.rid, "pushed")
        self._engine._kick()

    async def finish(self) -> None:
        self.finished = True
        with TELEMETRY.span("engine.finish", rid=self.rid,
                            annotated=False):
            await self._engine._call(self._engine.batcher.finish, self.lane,
                                     rid=self.rid)
        TELEMETRY.stamp(self.rid, "finished")
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

    async def _call(self, fn, *args, rid: Optional[int] = None):
        """Runs a (device-blocking) batcher call in the default executor
        under the engine lock, so it never races the pump."""
        loop = asyncio.get_running_loop()
        t = time.perf_counter()
        async with self._lock:
            TELEMETRY.add("engine.lock_wait", t, time.perf_counter(), rid)
            return await loop.run_in_executor(None, lambda: fn(*args))

    def _kick(self) -> None:
        self._wake.set()

    async def open(self, prompt_token=None, prompt_feat=None,
                   embedding=None) -> AudioStream:
        """Admits a stream (awaits a free lane).  A missing prompt piece
        defaults to empty, a missing speaker embedding to zeros."""
        rid = TELEMETRY.request()
        with TELEMETRY.span("engine.open", rid=rid, annotated=False):
            stream = await self._admit(rid, prompt_token, prompt_feat,
                                       embedding)
        TELEMETRY.stamp(rid, "admitted")
        TELEMETRY.note(rid, lane=stream.lane)
        if self._pump_task is None or self._pump_task.done():
            # a context of its own: the loop's spans have no request parent
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump_loop(), context=contextvars.Context())
        self._kick()
        return stream

    async def _admit(self, rid, prompt_token, prompt_feat,
                     embedding) -> AudioStream:
        d = self.decoder
        if prompt_token is None:
            prompt_token = np.zeros((1, 0), np.int32)
        if prompt_feat is None:
            prompt_feat = np.zeros((1, prompt_token.shape[1] * d.ratio,
                                    d.flow_cfg.output_size), np.float32)
        if embedding is None:
            embedding = np.zeros((1, d.flow_cfg.spk_embed_dim), np.float32)
        loop = asyncio.get_running_loop()
        t = time.perf_counter()
        while True:
            async with self._lock:
                if self.batcher.free_lanes > 0:
                    TELEMETRY.add("engine.lane_wait", t, time.perf_counter(),
                                  rid)
                    with TELEMETRY.span("engine.admit", rid=rid,
                                        annotated=False):
                        lane = await loop.run_in_executor(
                            None, lambda: self.batcher.admit(
                                np.asarray(prompt_token, np.int32),
                                np.asarray(prompt_feat, np.float32),
                                np.asarray(embedding, np.float32)))
                    stream = AudioStream(self, lane, rid)
                    self._streams[lane] = stream
                    return stream
            await asyncio.sleep(0.01)           # pool full: wait for a lane

    def _pump_timed(self):
        """One pump (in the executor): (chunks, start, end)."""
        t = time.perf_counter()
        out = self.batcher.pump(max_iters=self.pump_iters)
        return out, t, time.perf_counter()

    async def _pump_loop(self):
        loop = asyncio.get_running_loop()
        t_gap = time.perf_counter()     # the end of the last pump
        try:
            while self._streams:
                async with self._lock:
                    out = None
                    if self.batcher.has_work():
                        out, t_pump, t_end = await loop.run_in_executor(
                            None, self._pump_timed)
                if out is None:
                    # nothing a burst could advance: wait for push / finish
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(self._wake.wait(),
                                               self.idle_sleep_s)
                    except asyncio.TimeoutError:
                        pass
                    continue
                TELEMETRY.add("engine.pump_gap", t_gap, t_pump)
                t_gap = t_end
                for lane, chunk in out.items():
                    s = self._streams.get(lane)
                    if s is not None:
                        s._q.put_nowait(chunk)
                        if not s._handed:
                            s._handed = True
                            TELEMETRY.stamp(s.rid, "first_chunk")
                            TELEMETRY.note(s.rid, first_ticks=self.batcher.
                                           _lanes[lane].first_ticks)
                        TELEMETRY.stamp(s.rid, "last_chunk")
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
            TELEMETRY.add("engine.pump_gap", t_gap, time.perf_counter())
            self._pump_task = None


FORMATS = {"pcm16": "audio/L16", "oggopus": "audio/ogg"}


class AudioBody:
    """The body of one ``decode_stream`` response: async iteration over the
    encoded bytes.  Each call of the format's encoder on the event loop (the
    Ogg Opus encoder, or the pcm16 packing) is a span ``engine.encode`` of
    request ``rid`` in the telemetry store."""

    def __init__(self, chunks: AsyncIterator[np.ndarray], writer=None,
                 rid: Optional[int] = None):
        self._chunks = chunks
        self._writer = writer
        self.rid = rid

    def _encode(self, fn, *a) -> bytes:
        with TELEMETRY.span("engine.encode", rid=self.rid):
            return fn(*a)

    async def __aiter__(self):
        async for chunk in self._chunks:
            pcm = np.clip(np.asarray(chunk[0], np.float32), -1.0, 1.0)
            if self._writer is None:
                yield self._encode(protocol.pcm16_encode, pcm)
            else:
                data = self._encode(self._writer.encode, pcm)
                if data:
                    yield data
        if self._writer is not None:
            yield self._encode(self._writer.flush)


async def _once(data: bytes):
    yield data


def _error(status: int, message: str):
    return (status, {"Content-Type": "application/json"},
            _once(json.dumps({"error": message}).encode()))


async def decode_stream(engine: "AudioBatchEngine", params: dict
                        ) -> Tuple[int, Dict[str, str], AsyncIterator[bytes]]:
    """One ``/decode_stream`` request through ``engine``.  ``params`` as the
    request's JSON: ``{"tokens": [[...]], "prompt_token": [[...]]?,
    "prompt_feat": [[[...]]]?, "embedding": [[...]]?, "format":
    "pcm16"|"oggopus"}``.  Returns (status, headers, body); with status 200
    the body is an ``AudioBody`` that streams while later chunks are still
    being computed."""
    fmt = params.get("format", "pcm16")
    sr = engine.decoder.pipe_cfg.sample_rate
    if fmt not in FORMATS:
        return _error(400, f"unknown format {fmt!r}")
    writer = None
    if fmt == "oggopus":
        from .opus import available
        if not available():
            return _error(501, "libopus not available")
        from .ogg import OggOpusWriter
        writer = OggOpusWriter(sample_rate=sr)

    def arr(key, dtype):
        v = params.get(key)
        return None if v is None else np.asarray(v, dtype)

    stream = await engine.open(prompt_token=arr("prompt_token", np.int32),
                               prompt_feat=arr("prompt_feat", np.float32),
                               embedding=arr("embedding", np.float32))
    await stream.push(np.asarray(params["tokens"], np.int32))
    await stream.finish()
    return 200, {"Content-Type": FORMATS[fmt], "X-Sample-Rate": str(sr),
                 "Cache-Control": "no-cache"}, AudioBody(stream, writer,
                                                    stream.rid)


class AudioBatcherHTTPServer:
    """``POST /decode_stream`` over an ``AudioBatchEngine``: the aiohttp
    shell of ``decode_stream``."""

    def __init__(self, engine: AudioBatchEngine,
                 host: str = "0.0.0.0", port: int = 10010):
        web = aiohttp_module("AudioBatcherHTTPServer").web
        self.engine = engine
        self.host, self.port = host, port
        self.app = web.Application()
        self.app.add_routes([web.post("/decode_stream", self.handle)])

    async def handle(self, request):
        web = aiohttp_module("AudioBatcherHTTPServer").web
        status, headers, body = await decode_stream(self.engine,
                                                     await request.json())
        if status != 200:
            return web.Response(status=status, headers=headers,
                                body=b"".join([c async for c in body]))
        resp = web.StreamResponse(headers=headers)
        await resp.prepare(request)
        async for data in body:
            await resp.write(data)
        await resp.write_eof()
        return resp

    def run(self):                                      # pragma: no cover
        aiohttp_module("AudioBatcherHTTPServer").web.run_app(
            self.app, host=self.host, port=self.port)


async def decode_stream_client(url: str, payload: dict) -> np.ndarray:
    """Client of ``/decode_stream``: float32 (1, samples) (pcm16 read back
    as int16 / 32767, the JAX package's client)."""
    aiohttp = aiohttp_module("decode_stream_client")
    async with aiohttp.ClientSession() as session:
        async with session.post(url, json=payload) as resp:
            resp.raise_for_status()
            body = await resp.read()
            ctype = resp.headers["Content-Type"]
            sr = int(resp.headers["X-Sample-Rate"])
    if ctype == "audio/L16":
        return (np.frombuffer(body, "<i2").astype(np.float32)
                / 32767.0)[None]
    from .ogg import OggOpusReader
    return np.asarray(OggOpusReader(sample_rate=sr).decode(body),
                      np.float32)[None]
