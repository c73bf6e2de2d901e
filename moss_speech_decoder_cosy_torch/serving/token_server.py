"""Token streaming servers and the voice-chat audio consumer, after the JAX
package's ``serving/token_server.py``.  Each server is a core that knows
no transport plus an aiohttp shell that only moves bytes (aiohttp is
imported only where a shell or the client is built):

- ``token_stream`` (core) / ``TokenSSEServer`` (shell): ``POST
  /generate_stream`` answered with ``data: {"token_id": id}`` SSE lines
  from a pluggable token generator, wire-compatible with the reference's
  FastAPI LLM server (GLM_modules/model_server.py:82-130);
- ``BatcherTokenEngine`` (core) / ``BatcherSSEServer`` (shell): the same
  route over a ``serving.lm_server.ContinuousBatcher``: concurrent requests
  share the slot pool, one pump task advances every slot and fans tokens
  out to per-request queues.  Request JSON: {"text_ids": [...], "seed":
  int, "max_len": int, "prompt_speech_ids": [...]?};
- ``ChatAudioConsumer``: the web_demo.py:129-172 decode loop: demux audio /
  text ids by ``audio_offset`` and decode audio in ramping blocks of 25,
  50, 100, 150, 200 tokens, each block prompted by every block before it.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import (AsyncIterable, AsyncIterator, Callable, Dict, Iterable,
                    List, Optional, Tuple)

import numpy as np

from .ws_server import aiohttp_module

SSE_HEADERS = {"Content-Type": "text/event-stream",
               "Cache-Control": "no-cache"}


def sse_line(token_id: int) -> bytes:
    """One SSE event carrying a token id."""
    return f"data: {json.dumps({'token_id': int(token_id)})}\n\n".encode()


async def token_stream(generate_fn: Callable[[dict], Iterable[int]],
                       params: dict) -> AsyncIterator[bytes]:
    """SSE lines of ``generate_fn(params)``'s tokens; the generator runs in
    the loop's default executor, one token at a time."""
    loop = asyncio.get_running_loop()
    it = iter(generate_fn(params))
    while True:
        tok = await loop.run_in_executor(None, next, it, None)
        if tok is None:
            return
        yield sse_line(tok)


async def _write_sse(request, lines: AsyncIterable[bytes]):
    web = aiohttp_module("the SSE servers").web
    resp = web.StreamResponse(headers=SSE_HEADERS)
    await resp.prepare(request)
    async for line in lines:
        await resp.write(line)
    await resp.write_eof()
    return resp


class TokenSSEServer:
    """The aiohttp shell of ``token_stream``."""

    def __init__(self, generate_fn: Callable[[dict], Iterable[int]],
                 host: str = "0.0.0.0", port: int = 10000):
        web = aiohttp_module("TokenSSEServer").web
        self.generate_fn = generate_fn
        self.host, self.port = host, port
        self.app = web.Application()
        self.app.add_routes([web.post("/generate_stream", self.handle)])

    async def handle(self, request):
        return await _write_sse(request, token_stream(
            self.generate_fn, await request.json()))

    def run(self):                                      # pragma: no cover
        aiohttp_module("TokenSSEServer").web.run_app(
            self.app, host=self.host, port=self.port)


class BatcherTokenEngine:
    """Concurrent token streams over one ``ContinuousBatcher``, on one event
    loop.  Submit and the pump's steps both hold the lock, so no emitted
    token can race past a stream's registration."""

    def __init__(self, batcher):
        self.batcher = batcher
        self._queues: Dict[int, asyncio.Queue] = {}
        self._lock = asyncio.Lock()
        self._pump: Optional[asyncio.Task] = None

    async def _admit(self, params) -> Tuple[int, List[int],
                                            Optional[asyncio.Queue]]:
        loop = asyncio.get_running_loop()
        while True:
            async with self._lock:
                req = await loop.run_in_executor(
                    None, lambda: self.batcher.submit(
                        np.asarray(params["text_ids"], np.int64),
                        params.get("prompt_speech_ids"),
                        int(params.get("seed", 0)),
                        int(params.get("max_len", 512))))
                if req is not None:
                    first = list(self.batcher.result(req))
                    q = None
                    if not self.batcher.finished(req):
                        q = asyncio.Queue()
                        self._queues[req] = q
                    return req, first, q
            await asyncio.sleep(0.02)           # pool full: wait for a slot

    async def _pump_loop(self):
        loop = asyncio.get_running_loop()
        try:
            while self._queues:
                async with self._lock:
                    out = await loop.run_in_executor(None, self.batcher.step)
                for req, toks in out.items():
                    q = self._queues.get(req)
                    if q is not None:
                        for t in toks:
                            q.put_nowait(t)
                for req in list(self._queues):
                    if self.batcher.finished(req):
                        self._queues.pop(req).put_nowait(None)
                await asyncio.sleep(0)
        except Exception:                       # engine failure: close all
            logging.exception("batcher pump failed; closing streams")
            for q in self._queues.values():
                q.put_nowait(None)
            self._queues.clear()
            raise
        finally:
            self._pump = None

    async def generate_stream(self, params: dict
                              ) -> Tuple[int, Dict[str, str],
                                         AsyncIterator[bytes]]:
        """One ``/generate_stream`` request: (status, headers, body), the
        body an async iterator of SSE lines that streams while the batcher
        decodes; 400 for a request over the batcher's buckets."""
        try:
            req, first, q = await self._admit(params)
        except ValueError as e:
            return 400, {"Content-Type": "application/json"}, _once(
                json.dumps({"error": str(e)}).encode())
        if q is not None and self._pump is None:
            self._pump = asyncio.ensure_future(self._pump_loop())
        return 200, dict(SSE_HEADERS), self._body(first, q)

    async def _body(self, first: List[int], q: Optional[asyncio.Queue]):
        for tok in first:
            yield sse_line(tok)
        while q is not None:
            tok = await q.get()
            if tok is None:
                return
            yield sse_line(tok)


async def _once(data: bytes):
    yield data


class BatcherSSEServer:
    """The aiohttp shell of ``BatcherTokenEngine.generate_stream``."""

    def __init__(self, batcher, host: str = "0.0.0.0", port: int = 10000):
        web = aiohttp_module("BatcherSSEServer").web
        self.engine = BatcherTokenEngine(batcher)
        self.host, self.port = host, port
        self.app = web.Application()
        self.app.add_routes([web.post("/generate_stream", self.handle)])

    async def handle(self, request):
        web = aiohttp_module("BatcherSSEServer").web
        status, headers, body = await self.engine.generate_stream(
            await request.json())
        if status != 200:
            return web.Response(status=status, headers=headers,
                                body=b"".join([c async for c in body]))
        return await _write_sse(request, body)

    def run(self):                                      # pragma: no cover
        aiohttp_module("BatcherSSEServer").web.run_app(
            self.app, host=self.host, port=self.port)


def parse_sse(lines: Iterable[bytes]) -> List[int]:
    """Token ids of SSE lines (``data: {"token_id": id}``)."""
    out = []
    for raw in lines:
        line = raw.decode().strip()
        if line.startswith("data:"):
            out.append(int(json.loads(line[5:])["token_id"]))
    return out


async def consume_sse(url: str, payload: dict) -> AsyncIterable[int]:
    """Async client of ``/generate_stream`` (web_demo.py:133)."""
    aiohttp = aiohttp_module("consume_sse")
    async with aiohttp.ClientSession() as session:
        async with session.post(url, json=payload) as resp:
            async for raw in resp.content:
                for tok in parse_sse([raw]):
                    yield tok


class ChatAudioConsumer:
    """Streams LLM tokens into audio with the prompt-growing block scheme
    of web_demo.py:129-172 on an ``AudioDecoder``."""

    BLOCK_SIZES = (25, 50, 100, 150, 200)

    def __init__(self, decoder, audio_offset: int,
                 end_token_id: Optional[int] = None):
        self.decoder = decoder
        self.audio_offset = audio_offset
        self.end_token_id = end_token_id
        self.text_tokens: List[int] = []
        self.audio_tokens: List[int] = []
        self._decoded_tokens = np.zeros((1, 0), np.int32)
        self._decoded_mel = np.zeros(
            (1, 0, decoder.flow_cfg.output_size), np.float32)
        self._block_idx = 0
        self.wav_chunks: List[np.ndarray] = []

    def _block_size(self) -> int:
        return self.BLOCK_SIZES[min(self._block_idx,
                                    len(self.BLOCK_SIZES) - 1)]

    def _decode_block(self):
        if not self.audio_tokens:
            return
        block = np.asarray(self.audio_tokens, np.int32)[None]
        self.audio_tokens = []
        mel = self.decoder._flow_mel(
            block, self._decoded_tokens, self._decoded_mel,
            np.zeros((1, self.decoder.flow_cfg.spk_embed_dim), np.float32),
            streaming=False, finalize=True)
        wav, _ = self.decoder._hift(mel, np.zeros((1, 0, 1), np.float32))
        self.wav_chunks.append(wav)
        self._decoded_tokens = np.concatenate(
            [self._decoded_tokens, block], axis=1)
        self._decoded_mel = np.concatenate([self._decoded_mel, mel], axis=1)
        self._block_idx += 1

    def push(self, token_id: int):
        if self.end_token_id is not None and token_id == self.end_token_id:
            return
        if token_id >= self.audio_offset:
            self.audio_tokens.append(token_id - self.audio_offset)
            if len(self.audio_tokens) >= self._block_size():
                self._decode_block()
        else:
            self.text_tokens.append(token_id)

    def finish(self) -> np.ndarray:
        self._decode_block()
        if self.wav_chunks:
            return np.concatenate(self.wav_chunks, axis=-1)
        return np.zeros((1, 0), np.float32)
