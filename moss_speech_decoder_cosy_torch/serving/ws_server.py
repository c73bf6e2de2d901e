"""Websocket audio server, the reference ``server.py`` rebuilt (the port's
copy of the JAX package's ``serving/ws_server.py``).

Protocol and framing follow server.py:9-108: a binary handshake (0x00),
80 ms audio frames (0x01), text messages (0x02).  Audio payloads are pcm16,
length-prefixed opus packets (serving/opus.py), or standard Ogg Opus pages
wire-compatible with the reference's sphn framing (serving/ogg.py,
``codec="ogg"``).

The server is two parts:

- ``ChatSession``: one session's request handling with no transport.  It
  holds the codec pair and the frame buffer; ``feed(message)`` turns one
  received message into the messages to send back, running the
  ``handler(samples) -> samples`` of every complete 1920-sample frame in
  the default thread-pool executor, so the event loop keeps serving while
  the card works.  It records each frame's handler latency.
- ``AudioWsServer``: the aiohttp shell that only moves bytes between a
  websocket and a ``ChatSession``.  Like the reference, one session at a
  time holds the processing lock (server.py:15,94).

aiohttp is imported only where a server or client is built, so the core
runs where aiohttp is missing.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, List, Optional

import numpy as np

from . import protocol
from .protocol import FRAME_SAMPLES, KIND_AUDIO, KIND_HANDSHAKE

CODECS = ("pcm16", "opus", "ogg")


def aiohttp_module(what: str):
    """``aiohttp``, or an ImportError that names it and ``what`` needs it."""
    try:
        import aiohttp
        import aiohttp.web  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{what} needs aiohttp, which is not installed "
                          f"({e})") from e
    return aiohttp


def make_audio_codec(codec: str):
    """(encoder, decoder) of a wire codec; (None, None) for pcm16."""
    if codec == "opus":
        from .opus import OpusDecoder, OpusEncoder
        return (OpusEncoder(protocol.SAMPLE_RATE),
                OpusDecoder(protocol.SAMPLE_RATE))
    if codec == "ogg":
        from .ogg import OggOpusReader, OggOpusWriter
        return (OggOpusWriter(protocol.SAMPLE_RATE),
                OggOpusReader(protocol.SAMPLE_RATE))
    if codec != "pcm16":
        raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")
    return None, None


class ChatSession:
    """One websocket chat session without its transport: ``handshake()``
    is the first message to send; ``await feed(message)`` takes one
    received binary message and returns the messages to send back (audio
    of every complete frame the handler returned samples for).
    ``handler_ms`` lists each frame's handler wall time."""

    def __init__(self, handler: Callable[[np.ndarray], np.ndarray],
                 codec: str = "pcm16", log: bool = False):
        self.handler = handler
        self.enc, self.dec = make_audio_codec(codec)
        self.log = log
        self.buf = np.zeros(0, np.float32)
        self.handler_ms: List[float] = []

    @staticmethod
    def handshake() -> bytes:
        return protocol.frame_message(KIND_HANDSHAKE)

    def _encode(self, samples: np.ndarray) -> Optional[bytes]:
        if self.enc is None:
            return protocol.pcm16_encode(samples)
        data = self.enc.encode(np.asarray(samples, np.float32))
        return data or None

    async def feed(self, message: bytes) -> List[bytes]:
        kind, payload = protocol.parse_message(message)
        if kind != KIND_AUDIO:
            return []
        if self.dec is not None:
            samples = np.asarray(self.dec.decode(payload), np.float32)
        else:
            samples = protocol.pcm16_decode(payload)
        self.buf = np.concatenate([self.buf, samples])
        loop = asyncio.get_running_loop()
        replies: List[bytes] = []
        while len(self.buf) >= FRAME_SAMPLES:
            frame, self.buf = (self.buf[:FRAME_SAMPLES],
                               self.buf[FRAME_SAMPLES:])
            t0 = time.perf_counter()
            out = await loop.run_in_executor(None, self.handler, frame)
            ms = (time.perf_counter() - t0) * 1e3
            self.handler_ms.append(ms)
            if self.log:
                print(f"frame processed in {ms:.1f} ms")
            if out is None or len(out) == 0:
                continue
            data = self._encode(out)
            if data:
                replies.append(protocol.frame_message(KIND_AUDIO, data))
        return replies


class AudioWsServer:
    """``GET /api/chat`` websocket over ``ChatSession``s; ``handler``
    defaults to echo."""

    def __init__(self, handler: Optional[Callable] = None,
                 codec: str = "pcm16", host: str = "0.0.0.0",
                 port: int = 8023, log: bool = True):
        web = aiohttp_module("AudioWsServer").web
        if codec not in CODECS:
            raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")
        self.handler = handler or (lambda samples: samples)
        self.codec = codec
        self.host = host
        self.port = port
        self.log = log
        self.lock = asyncio.Lock()
        self.app = web.Application()
        self.app.add_routes([web.get("/api/chat", self.handle_chat)])

    async def handle_chat(self, request):
        aiohttp = aiohttp_module("AudioWsServer")
        ws = aiohttp.web.WebSocketResponse()
        await ws.prepare(request)
        async with self.lock:                          # one active session
            session = ChatSession(self.handler, self.codec, self.log)
            await ws.send_bytes(session.handshake())
            async for msg in ws:
                if msg.type != aiohttp.WSMsgType.BINARY:
                    continue
                for data in await session.feed(msg.data):
                    await ws.send_bytes(data)
        return ws

    def run(self):                                      # pragma: no cover
        aiohttp_module("AudioWsServer").web.run_app(
            self.app, host=self.host, port=self.port)


async def stream_wav(url: str, samples: np.ndarray, codec: str = "pcm16",
                     frame_samples: int = FRAME_SAMPLES,
                     settle_s: float = 1.0) -> np.ndarray:
    """Headless client (the client_streaming.sh / client.py role): streams
    the samples to the server and returns the audio it sent back once
    ``settle_s`` passed with nothing received."""
    aiohttp = aiohttp_module("stream_wav")
    enc, dec = make_audio_codec(codec)
    out: List[np.ndarray] = []
    async with aiohttp.ClientSession() as session:
        async with session.ws_connect(url) as ws:
            kind, _ = protocol.parse_message(await ws.receive_bytes())
            if kind != KIND_HANDSHAKE:
                raise RuntimeError(f"expected a handshake, got kind {kind}")

            async def sender():
                for i in range(0, len(samples), frame_samples):
                    chunk = samples[i: i + frame_samples]
                    if enc is not None:
                        data = enc.encode(chunk)
                        if not data:
                            continue
                    else:
                        data = protocol.pcm16_encode(chunk)
                    await ws.send_bytes(
                        protocol.frame_message(KIND_AUDIO, data))
                    await asyncio.sleep(0)

            send_task = asyncio.create_task(sender())
            try:
                while True:
                    msg = await asyncio.wait_for(ws.receive(),
                                                 timeout=settle_s)
                    if msg.type != aiohttp.WSMsgType.BINARY or not msg.data:
                        break
                    kind, payload = protocol.parse_message(msg.data)
                    if kind == KIND_AUDIO:
                        out.append(np.asarray(
                            dec.decode(payload) if dec is not None
                            else protocol.pcm16_decode(payload),
                            np.float32))
            except asyncio.TimeoutError:
                pass
            await send_task
    return np.concatenate(out) if out else np.zeros(0, np.float32)
