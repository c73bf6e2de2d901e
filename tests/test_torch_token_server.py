"""The port's token servers (``serving/token_server.py``), on the CPU with
the tiny speech LM:

- the SSE line format equals the JAX server's (``data: {"token_id": id}``
  and a blank line), and ``parse_sse`` reads it back;
- ``token_stream``, the core of ``TokenSSEServer``, streams a generator's
  tokens;
- ``BatcherTokenEngine``, the core of ``BatcherSSEServer``: two concurrent
  requests (one slot, so the second waits for the first; and two slots)
  each stream exactly ``generate``'s tokens for their seed, and a request
  over the buckets answers 400; the same in a process where aiohttp
  cannot be imported, where building either shell raises an ImportError
  naming aiohttp;
- the aiohttp shells on localhost (port 0): two concurrent clients.

Torch runs on one thread here, as in the other port test modules."""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from moss_speech_decoder_cosy_torch.models.llm import speech_lm as TS
from moss_speech_decoder_cosy_torch.serving import token_server as TTS
from moss_speech_decoder_cosy_torch.serving.lm_server import (
    ContinuousBatcher)
from moss_speech_decoder_cosy_torch.weights import seeded_state

ROOT = Path(__file__).resolve().parents[1]
REQUESTS = [dict(text_ids=[3, 1, 4, 1, 5], seed=21, max_len=11),
            dict(text_ids=[9, 2, 6], seed=22, max_len=8)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_lm():
    cfg = TS.tiny_speech_lm_config()
    with torch.device("meta"):
        lm = TS.Qwen2SpeechLM(cfg)
    return TS.load_lm(TS.Qwen2SpeechLM, cfg, seeded_state(lm, 8),
                      device="cpu")


@pytest.fixture(scope="module")
def lm():
    return tiny_lm()


def generated(lm, req):
    toks, n = lm(np.asarray(req["text_ids"])[None], np.zeros((1, 0)),
                 seed=req["seed"], max_len=req["max_len"])
    return toks[:n].tolist()


async def engine_run(lm, slots):
    """Both REQUESTS at once through one engine; the 400 of a request over
    the text bucket."""
    eng = TTS.BatcherTokenEngine(ContinuousBatcher(
        lm, slots=slots, step_chunk=3, text_buckets=(8,)))

    async def one(req):
        status, headers, body = await eng.generate_stream(req)
        return status, headers, [line async for line in body]
    return await asyncio.gather(
        *(one(r) for r in REQUESTS + [dict(text_ids=list(range(9)))]))


def test_sse_line_format_equals_jax():
    for tok in (0, 7, 6563):
        line = TTS.sse_line(tok)
        want = f"data: {json.dumps({'token_id': tok})}\n\n".encode()
        assert line == want == f'data: {{"token_id": {tok}}}\n\n'.encode()
    lines = [TTS.sse_line(t) for t in (4, 5, 6)] + [b"\n", b": comment\n"]
    assert TTS.parse_sse(lines) == [4, 5, 6]


def test_token_stream_core():
    async def run():
        return [line async for line in TTS.token_stream(
            lambda p: iter(range(p["n"])), {"n": 5})]
    assert TTS.parse_sse(asyncio.run(run())) == list(range(5))


@pytest.mark.parametrize("slots", [1, 2])
def test_batcher_engine_two_concurrent_requests(lm, slots):
    results = asyncio.run(engine_run(lm, slots))
    for req, (status, headers, lines) in zip(REQUESTS, results):
        assert status == 200
        assert headers["Content-Type"] == "text/event-stream"
        assert TTS.parse_sse(lines) == generated(lm, req)
    status, headers, lines = results[-1]
    assert status == 400 and "bucket" in json.loads(b"".join(lines))["error"]


_NO_AIOHTTP = r"""
import asyncio, sys
sys.modules["aiohttp"] = None
sys.path.insert(0, "tests")
import torch
torch.set_num_threads(1)
from test_torch_token_server import REQUESTS, engine_run, generated, tiny_lm
from moss_speech_decoder_cosy_torch.serving import token_server as TTS
lm = tiny_lm()
results = asyncio.run(engine_run(lm, 1))
for req, (status, _, lines) in zip(REQUESTS, results):
    assert status == 200 and TTS.parse_sse(lines) == generated(lm, req)
for build in (lambda: TTS.TokenSSEServer(lambda p: []),
              lambda: TTS.BatcherSSEServer(None)):
    try:
        build()
    except ImportError as e:
        assert "aiohttp" in str(e), e
    else:
        raise AssertionError("built a shell without aiohttp")
print("OK")
"""


def test_batcher_engine_without_aiohttp():
    r = subprocess.run([sys.executable, "-c", _NO_AIOHTTP], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr


def test_sse_shells_over_aiohttp(lm):
    aiohttp = pytest.importorskip("aiohttp")
    from aiohttp.test_utils import TestServer

    async def run():
        out = []
        for server in (TTS.TokenSSEServer(lambda p: iter(p["text_ids"])),
                       TTS.BatcherSSEServer(ContinuousBatcher(
                           lm, slots=2, step_chunk=3, text_buckets=(8,)))):
            ts = TestServer(server.app, port=0)
            await ts.start_server()
            try:
                url = str(ts.make_url("/generate_stream"))
                got = await asyncio.gather(
                    *([_collect(url, r) for r in REQUESTS]
                      + [_status(aiohttp, url,
                                 dict(text_ids=list(range(9))))]))
            finally:
                await ts.close()
            out.append(got)
        return out
    echo, batched = asyncio.run(run())
    assert echo[:2] == [r["text_ids"] for r in REQUESTS]
    assert batched[:2] == [generated(lm, r) for r in REQUESTS]
    assert batched[2] == 400


async def _collect(url, payload):
    return [t async for t in TTS.consume_sse(url, payload)]


async def _status(aiohttp, url, payload):
    async with aiohttp.ClientSession() as s:
        async with s.post(url, json=payload) as resp:
            await resp.read()
            return resp.status
