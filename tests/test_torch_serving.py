"""The port's serving layer against the JAX package's, on the CPU:

- byte for byte: protocol frames and pcm16 (``native`` against its numpy
  versions too), the Ogg CRC vector, Ogg pages, Opus packets and Ogg Opus
  streams for the same input, and the chunker's cuts;
- the transport-free cores: ``ChatSession`` (handshake, frames, codecs)
  and ``decode_stream`` (its pcm16 body equal to the clip-and-scale of the
  engine's float chunks, 400 for an unknown format);
- aiohttp on localhost (port 0): the websocket echo in pcm16 and Ogg Opus,
  the JAX client against the port's server, ``/decode_stream`` pcm16 from
  two concurrent clients within 1 LSB of the JAX server's body for the
  same requests (tiny f32 decoder, the port's NSF source given the JAX
  draws), oggopus read back to the pcm16 length, 400, the web page;
- ``make_vc_handler`` over 2 s of seeded frames against the JAX handler
  (tokens equal, audio within 1e-4 of the JAX audio's peak) and
  ``make_compare_handler`` with and without ``prep`` against the JAX one;
- ``boot_warmup`` / ``boot_warmup_batcher`` on the CPU (no graphs: the
  card's no-new-capture test is in ``test_torch_cuda.py``);
- every new entry point raises without a card unless given
  ``device="cpu"``; every module of the port imports with aiohttp, yaml
  and safetensors blocked, and the network shells then raise ImportError
  naming aiohttp.

Torch runs on one thread here, as in the other port test modules."""

import asyncio
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu import codec as JC
from moss_speech_decoder_cosy_tpu import native as JN
from moss_speech_decoder_cosy_tpu.models.flow import CausalMaskedDiffWithXvec
from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator
from moss_speech_decoder_cosy_tpu.pipeline import AudioDecoder as JDecoder
from moss_speech_decoder_cosy_tpu.serving import audio_batcher as JAB
from moss_speech_decoder_cosy_tpu.serving import audio_process as JAP
from moss_speech_decoder_cosy_tpu.serving import ogg as JOgg
from moss_speech_decoder_cosy_tpu.serving import opus as JOpus
from moss_speech_decoder_cosy_tpu.serving import protocol as JP
from moss_speech_decoder_cosy_tpu.serving import web_demo as JWD
from moss_speech_decoder_cosy_tpu.serving import ws_server as JWS
from moss_speech_decoder_cosy_tpu.tokenizer import model as JT
from moss_speech_decoder_cosy_tpu.tokenizer import tiny_tokenizer_config
from moss_speech_decoder_cosy_tpu.utils.config import (
    CFMConfig, PipelineConfig, tiny_flow_config, tiny_hift_config)
from moss_speech_decoder_cosy_torch import codec as TCodec
from moss_speech_decoder_cosy_torch import native as TN
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder as TDecoder
from moss_speech_decoder_cosy_torch.serving import audio_batcher as TAB
from moss_speech_decoder_cosy_torch.serving import audio_process as TAP
from moss_speech_decoder_cosy_torch.serving import boot as TBoot
from moss_speech_decoder_cosy_torch.serving import ogg as TOgg
from moss_speech_decoder_cosy_torch.serving import opus as TOpus
from moss_speech_decoder_cosy_torch.serving import protocol as TP
from moss_speech_decoder_cosy_torch.serving import web_demo as TWD
from moss_speech_decoder_cosy_torch.serving import ws_server as TWS
from moss_speech_decoder_cosy_torch.tokenizer import config as TTC
from moss_speech_decoder_cosy_torch.utils import config as TC
from moss_speech_decoder_cosy_torch.utils.profiling import TELEMETRY
from moss_speech_decoder_cosy_torch.weights import (
    flow_state_from_jax, hift_state_from_jax, tokenizer_state_from_jax)

ROOT = Path(__file__).resolve().parents[1]
HOP, RING = 2, 7
VC_REL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _need_opus():
    if not (TOpus.available() and JOpus.available()):
        pytest.skip("libopus is not installed")


def jax_draws(harmonics, length, device):
    k_ini, k_noise = jax.random.split(jax.random.PRNGKey(0))
    rand_ini = jax.random.uniform(k_ini, (1, harmonics), dtype=jnp.float32)
    noise = jax.random.normal(k_noise, (1, length, harmonics), jnp.float32)
    return (torch.from_numpy(np.array(rand_ini)).to(device),
            torch.from_numpy(np.array(noise)).to(device))


def _sine(n, f=440.0, sr=24000, amp=0.5):
    return (amp * np.sin(2 * np.pi * f * np.arange(n) / sr)).astype(
        np.float32)


# ------------------------------------------------------------ byte-level
def test_protocol_frames_and_pcm16_equal_jax():
    for kind, payload in ((TP.KIND_HANDSHAKE, b""), (TP.KIND_AUDIO, b"\x01"),
                          (TP.KIND_TEXT, "hi".encode())):
        msg = TP.frame_message(kind, payload)
        assert msg == JP.frame_message(kind, payload)
        assert TP.parse_message(msg) == JP.parse_message(msg)
    with pytest.raises(ValueError):
        TP.parse_message(b"")
    assert (TP.FRAME_SAMPLES, TP.SAMPLE_RATE) == (JP.FRAME_SAMPLES,
                                                  JP.SAMPLE_RATE) == (
        1920, 24000)
    x = (np.random.RandomState(0).randn(TP.FRAME_SAMPLES) * 0.7).astype(
        np.float32)
    data = TP.pcm16_encode(x)
    assert data == JP.pcm16_encode(x)
    np.testing.assert_array_equal(TP.pcm16_decode(data),
                                  JP.pcm16_decode(data))


def test_native_matches_numpy_and_jax():
    assert TN.available(), "a C++ compiler is expected here"
    assert TN._target().parent == ROOT / "build" / "native"
    rng = np.random.RandomState(1)
    x = (rng.randn(5000) * 0.8).astype(np.float32)
    data = TN.pcm16_encode(x)
    assert data == TN.pcm16_encode_np(x) == JN.pcm16_encode(x)
    np.testing.assert_array_equal(TN.pcm16_decode(data),
                                  TN.pcm16_decode_np(data))
    np.testing.assert_array_equal(TN.pcm16_decode(data),
                                  JN.pcm16_decode(data))
    n = 256
    head, tail = rng.randn(n).astype(np.float32), rng.randn(n).astype(
        np.float32)
    win = np.hamming(2 * n).astype(np.float32)
    got = TN.crossfade(head, tail, win[:n], win[n:])
    np.testing.assert_array_equal(got, TN.crossfade_np(head, tail, win[:n],
                                                       win[n:]))
    np.testing.assert_array_equal(got, JN.crossfade(head, tail, win[:n],
                                                    win[n:]))
    with pytest.raises(ValueError):
        TN.crossfade(head, tail[:10], win[:n], win[n:])


def test_ogg_crc_and_pages_equal_jax():
    assert TOgg.ogg_crc(b"") == 0
    assert TOgg.ogg_crc(b"123456789") == 0x765E7680 ^ 0xFFFFFFFF
    rng = np.random.RandomState(0)
    sizes = [1, 17, 255, 256, 1000, 255 * 255 + 123]
    packets = [bytes(rng.randint(0, 256, s, dtype=np.uint8)) for s in sizes]
    edge = [bytes([i % 256]) * 10 for i in range(255)] + [b"x" * 7]
    granules = [(i + 1) * 960 for i in range(len(edge))]
    tw, jw = TOgg.OggPageWriter(), JOgg.OggPageWriter()
    for w in (tw, jw):
        w.out = (w.page_out(packets[:3], granule=960)
                 + w.page_out(packets[3:], granule=1920)
                 + w.page_out(edge, granules[-1], eos=True,
                              granules=granules))
    assert tw.out == jw.out
    r = TOgg.OggPageReader()
    got = []
    for i in range(0, len(tw.out), 7):
        got.extend(p for p, _ in r.packets_in(tw.out[i: i + 7]))
    assert got == packets + edge and r.eos
    bad = bytearray(tw.out)
    bad[40] ^= 0xFF
    with pytest.raises(ValueError):
        TOgg.OggPageReader().packets_in(bytes(bad))


def test_opus_packets_and_ogg_opus_equal_jax():
    _need_opus()
    x = _sine(24000 + 333)
    for kw in ({}, {"dtx": True}, {"fec": True, "loss_perc": 20},
               {"bitrate": 32000, "complexity": 5}):
        t, j = TOpus.OpusEncoder(24000, **kw), JOpus.OpusEncoder(24000, **kw)
        assert t.lookahead() == j.lookahead() > 0
        assert t.encode_packets(x[:7000]) == j.encode_packets(x[:7000])
        assert t.encode(x[7000:]) == j.encode(x[7000:])
        assert t.pending == len(j._buf)
    tw, jw = TOgg.OggOpusWriter(24000), JOgg.OggOpusWriter(24000)
    data = tw.encode(x[:10000]) + tw.encode(x[10000:]) + tw.flush()
    assert data == jw.encode(x[:10000]) + jw.encode(x[10000:]) + jw.flush()
    got = TOgg.OggOpusReader(24000).decode(data)
    want = np.asarray(JOgg.OggOpusReader(24000).decode(data), np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert len(got) >= len(x) - tw.pre_skip * 24000 // 48000 - tw.enc.frame
    # the length-prefixed framing, and loss recovery
    enc = TOpus.OpusEncoder(24000, fec=True, loss_perc=20)
    pkts = enc.encode_packets(x)
    dec = TOpus.OpusDecoder(24000)
    assert len(dec.decode_fec(pkts[6], enc.frame)) == enc.frame
    assert len(dec.conceal(enc.frame)) == enc.frame
    y = TOpus.OpusDecoder(24000).decode(TOpus.OpusEncoder(24000).encode(x))
    np.testing.assert_array_equal(
        y, np.asarray(JOpus.OpusDecoder(24000).decode(
            JOpus.OpusEncoder(24000).encode(x)), np.float32))


def test_ogg_eos_granule_trims_padding():
    _need_opus()
    w = TOgg.OggOpusWriter(sample_rate=24000)
    n_real = w.enc.frame + w.enc.frame // 3
    data = w.encode([0.01] * n_real) + w.flush()
    eos_granule, i = None, 0
    while i < len(data):
        nseg = data[i + 26]
        if data[i + 5] & TOgg.EOS:
            eos_granule = int.from_bytes(data[i + 6:i + 14], "little",
                                         signed=True)
        i += 27 + nseg + sum(data[i + 27:i + 27 + nseg])
    assert eos_granule == w.pre_skip + n_real * 48000 // 24000


def test_chunker_cuts_equal_jax():
    sr = 24000
    rng = np.random.RandomState(2)
    loud = _sine(sr // 2, 220.0)
    pieces = [loud[: sr // 8], np.concatenate([loud[sr // 8:],
                                               np.zeros(sr // 4)]),
              (rng.randn(sr) * 0.3).astype(np.float32),
              np.zeros(sr // 3, np.float32), loud]
    t = TAP.AudioStreamProcessor(sr=sr, min_chunk_seconds=0.25)
    j = JAP.AudioStreamProcessor(sr=sr, min_chunk_seconds=0.25)
    cuts = 0
    for p in pieces:
        got, want = t.push(p), j.push(p)
        assert (got is None) == (want is None)
        if got is not None:
            cuts += 1
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.flush(), j.flush())
    assert cuts >= 3


# ------------------------------------------------- transport-free cores
def test_chat_session_core():
    async def run(codec):
        s = TWS.ChatSession(lambda f: f * 0.5, codec=codec)
        assert s.handshake() == bytes([TP.KIND_HANDSHAKE])
        enc, dec = TWS.make_audio_codec(codec)
        x = _sine(TP.FRAME_SAMPLES * 3 + 100)
        replies = []
        assert await s.feed(TP.frame_message(TP.KIND_TEXT, b"hi")) == []
        for i in range(0, len(x), 1000):
            data = (TP.pcm16_encode(x[i:i + 1000]) if enc is None
                    else enc.encode(x[i:i + 1000]))
            replies += await s.feed(TP.frame_message(TP.KIND_AUDIO, data))
        out = []
        for r in replies:
            kind, payload = TP.parse_message(r)
            assert kind == TP.KIND_AUDIO
            out.append(TP.pcm16_decode(payload) if dec is None
                       else dec.decode(payload))
        return s, x, np.concatenate(out)

    s, x, out = asyncio.run(run("pcm16"))
    assert len(s.handler_ms) == 3 and len(s.buf) == 100
    assert len(out) == 3 * TP.FRAME_SAMPLES
    np.testing.assert_allclose(out, x[:len(out)] * 0.5, atol=2e-4)
    if TOpus.available():
        s, x, out = asyncio.run(run("ogg"))
        assert len(s.handler_ms) >= 2 and 0.1 < np.std(out) < 1.0
    with pytest.raises(ValueError, match="codec"):
        TWS.ChatSession(lambda f: f, codec="mp3")


@pytest.fixture(scope="module")
def decoders():
    """The tiny f32 decoders of both packages on one set of weights (3 ODE
    steps, hop 2), the port's NSF source given the JAX draws."""
    cfg = dataclasses.replace(tiny_flow_config(),
                              cfm=CFMConfig(n_timesteps=3, max_noise_len=2048))
    hcfg = tiny_hift_config()
    fp = jax.jit(CausalMaskedDiffWithXvec(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), jnp.zeros((1, 0, cfg.output_size)),
        jnp.zeros((1, cfg.spk_embed_dim)))
    hp = jax.jit(HiFTGenerator(hcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, cfg.output_size)))
    hp = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 200.0 if "conv_post" in str(p)
        and str(p[-1]) == "['g']" else a, hp)
    jdec = JDecoder(cfg, hcfg, fp, hp, PipelineConfig(
        block_size=HOP, mel_cache_len=2, max_token_len=9))
    tdec = TDecoder(
        dataclasses.replace(TC.tiny_flow_config(), cfm=TC.CFMConfig(
            n_timesteps=3, max_noise_len=2048)),
        TC.tiny_hift_config(), flow_state_from_jax(jax.tree.map(np.asarray,
                                                                fp)),
        hift_state_from_jax(jax.tree.map(np.asarray, hp)),
        TC.PipelineConfig(block_size=HOP, mel_cache_len=2, max_token_len=9),
        device="cpu", nsf_draws=jax_draws)
    return jdec, tdec


def _requests(cfg):
    rng = np.random.RandomState(13)
    out = []
    for n_prompt, n in ((2, 12), (0, 9)):
        p = {"tokens": rng.randint(0, cfg.vocab_size, (1, n)).tolist(),
             "embedding": rng.randn(1, cfg.spk_embed_dim).tolist()}
        if n_prompt:
            p["prompt_token"] = rng.randint(0, cfg.vocab_size,
                                            (1, n_prompt)).tolist()
            p["prompt_feat"] = (rng.randn(1, n_prompt * cfg.token_mel_ratio,
                                          cfg.output_size) * 0.3).tolist()
        out.append(p)
    return out


def _engine(mod, dec, n_lanes=2):
    return mod.AudioBatchEngine(dec, n_lanes=n_lanes, block_size=HOP,
                                ring_tokens=RING, token_cap=64)


def test_decode_stream_core(decoders):
    """The body equals the clip-and-scale of the engine's float chunks for
    the same request, sample for sample; an unknown format gives 400."""
    _, tdec = decoders
    req = _requests(tdec.flow_cfg)[0]

    async def run():
        engine = _engine(TAB, tdec, n_lanes=1)
        status, headers, body = await TAB.decode_stream(engine, req)
        data = b"".join([c async for c in body])
        s = await engine.open(np.asarray(req["prompt_token"]),
                              np.asarray(req["prompt_feat"], np.float32),
                              np.asarray(req["embedding"], np.float32))
        await s.push(np.asarray(req["tokens"]))
        await s.finish()
        chunks = [c async for c in s]
        bad = await TAB.decode_stream(engine, dict(req, format="mp3"))
        bad_body = b"".join([c async for c in bad[2]])
        return status, headers, body, data, chunks, bad, bad_body

    status, headers, body, data, chunks, bad, bad_body = asyncio.run(run())
    assert status == 200 and headers["Content-Type"] == "audio/L16"
    assert headers["X-Sample-Rate"] == "24000"
    encode = [sp for sp in TELEMETRY.spans("engine.encode")
              if sp.rid == body.rid]
    assert body.rid is not None and sum(sp.duration_s for sp in encode) > 0
    got = np.frombuffer(data, "<i2")
    want = (np.clip(np.concatenate(chunks, axis=1)[0], -1, 1)
            * 32767.0).astype("<i2")
    assert len(got) == 12 * 4 * tdec.hift_cfg.total_upsample
    np.testing.assert_array_equal(got, want)
    assert bad[0] == 400 and b"mp3" in bad_body


# ------------------------------------------------------------- aiohttp
async def _serve(app):
    from aiohttp.test_utils import TestServer
    server = TestServer(app, port=0)
    await server.start_server()
    return server


def test_ws_echo_and_ogg_roundtrip_over_aiohttp():
    pytest.importorskip("aiohttp")

    async def run(codec, client):
        srv = TWS.AudioWsServer(handler=lambda s: s * 0.5, codec=codec,
                                log=False)
        server = await _serve(srv.app)
        try:
            url = str(server.make_url("/api/chat")).replace("http", "ws")
            x = _sine(TP.FRAME_SAMPLES * 3)
            return x, await client(url, x, codec=codec, settle_s=0.5)
        finally:
            await server.close()

    for client in (TWS.stream_wav, JWS.stream_wav):
        x, out = asyncio.run(run("pcm16", client))
        assert len(out) == len(x)
        np.testing.assert_allclose(out, x * 0.5, atol=2e-4)
    if TOpus.available():
        x, out = asyncio.run(run("ogg", TWS.stream_wav))
        assert len(out) >= len(x) - TP.FRAME_SAMPLES - 2 * 480
        assert 0.05 < np.std(out[960:]) < 1.0


def test_http_decode_stream_matches_jax_server(decoders):
    """Two concurrent clients on each package's server, the same requests:
    the pcm16 bodies within 1 LSB; oggopus on the port's server reads back
    to the pcm16 length within an Opus frame; 400 for an unknown format."""
    aiohttp = pytest.importorskip("aiohttp")
    jdec, tdec = decoders
    reqs = _requests(tdec.flow_cfg)

    async def post(url, payload):
        async with aiohttp.ClientSession() as s:
            async with s.post(url, json=payload) as resp:
                return resp.status, resp.headers.get("Content-Type"), \
                    await resp.read()

    async def run(mod, dec, extra):
        server = await _serve(mod.AudioBatcherHTTPServer(
            _engine(mod, dec)).app)
        try:
            url = str(server.make_url("/decode_stream"))
            got = await asyncio.gather(*[post(url, r) for r in reqs])
            for r in extra:
                got.append(await post(url, r))
            return got
        finally:
            await server.close()

    ogg_req = dict(reqs[0], format="oggopus")
    port = asyncio.run(run(TAB, tdec, [ogg_req, dict(reqs[0],
                                                     format="mp3")]))
    ref = asyncio.run(run(JAB, jdec, []))
    n_up = tdec.hift_cfg.total_upsample
    for (ts, tct, tb), (js, jct, jb), r in zip(port, ref, reqs):
        assert ts == js == 200 and tct == jct == "audio/L16"
        t, j = np.frombuffer(tb, "<i2"), np.frombuffer(jb, "<i2")
        assert len(t) == len(j) == len(r["tokens"][0]) * 4 * n_up
        assert np.abs(j).max() > 1000, "trivial waveform"
        assert np.abs(t.astype(np.int32) - j).max() <= 1
    status, ctype, body = port[len(reqs)]
    assert status == 200 and ctype == "audio/ogg"
    if TOpus.available():
        pcm = TOgg.OggOpusReader(24000).decode(body)
        n, frame = len(port[0][2]) // 2, 24000 * 20 // 1000
        assert n - frame <= len(pcm) <= n + frame and np.isfinite(pcm).all()
    else:
        assert status == 501
    assert port[-1][0] == 400 and b"mp3" in port[-1][2]


def test_web_demo_page_serves():
    aiohttp = pytest.importorskip("aiohttp")

    async def run():
        demo = TWD.WebDemo(handler=lambda s: s,
                           compare_handler=lambda wav: {})
        server = await _serve(demo.ws.app)
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(server.make_url("/")) as resp:
                    return resp.status, await resp.text()
        finally:
            await server.close()

    status, text = asyncio.run(run())
    assert status == 200
    for needle in ("WebSocket", "getUserMedia", "api/compare", 'id="mic"',
                   'id="prep"', "const SR = 24000, FRAME = 1920"):
        assert needle in text, needle


# ------------------------------------------------------------- handlers
class _Recording:
    """A codec whose streaming tokenizer records the tokens it emits."""

    def __init__(self, codec):
        self.codec, self.decoder, self.tokens = codec, codec.decoder, []

    def new_encode_session(self):
        sess, rec = self.codec.new_encode_session(), self.tokens

        class Session:
            def push(self, wav):
                out = list(sess.push(wav))
                rec.extend(np.asarray(t).reshape(-1) for t in out)
                return out
        return Session()


@pytest.fixture(scope="module")
def codecs():
    """Tiny codecs of both packages on one set of weights (the decoders of
    ``tests/test_torch_codec.py``: block 4, mel cache 4, window 16)."""
    tcfg = tiny_tokenizer_config()
    tp = jax.jit(JT.WhisperVQEncoder(tcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, tcfg.num_mel_bins)),
        jnp.ones((1, 16), bool))
    fcfg, hcfg = tiny_flow_config(), tiny_hift_config()
    fp = jax.jit(CausalMaskedDiffWithXvec(fcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), jnp.zeros((1, 0, fcfg.output_size)),
        jnp.zeros((1, fcfg.spk_embed_dim)))
    hp = jax.jit(HiFTGenerator(hcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 8, hcfg.in_channels)))
    hp = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 200.0 if "conv_post" in str(p)
        and str(p[-1]) == "['g']" else a, hp)
    pipe = dict(block_size=4, mel_cache_len=4, max_token_len=16)
    jdec = JDecoder(fcfg, hcfg, fp, hp, PipelineConfig(**pipe))
    tdec = TDecoder(TC.tiny_flow_config(), TC.tiny_hift_config(),
                    flow_state_from_jax(jax.tree.map(np.asarray, fp)),
                    hift_state_from_jax(jax.tree.map(np.asarray, hp)),
                    TC.PipelineConfig(**pipe), device="cpu",
                    nsf_draws=jax_draws)
    jc = JC.SpeechCodec(tcfg, tp, jdec, segment_seconds=1.28)
    tc = TCodec.SpeechCodec(TTC.tiny_tokenizer_config(),
                            tokenizer_state_from_jax(jax.tree.map(
                                np.asarray, tp)), tdec,
                            segment_seconds=1.28, device="cpu")
    rng = np.random.RandomState(9)
    prompt = types.SimpleNamespace(
        token=rng.randint(0, fcfg.vocab_size, (1, 3)).astype(np.int32),
        feat=(rng.randn(1, 12, fcfg.output_size) * 0.3).astype(np.float32),
        embedding=rng.randn(1, fcfg.spk_embed_dim).astype(np.float32))
    return jc, tc, prompt


def _seeded_speech(seconds, sr, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120.0 + 40.0 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * t)
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    return (0.2 * env * voiced + 0.01 * rng.randn(len(t))).astype(
        np.float32)


def test_vc_handler_matches_jax(codecs):
    """2 s of seeded 24 kHz frames through both packages' VC handlers: the
    same tokens, audio within 1e-4 of the JAX audio's peak, frame for
    frame."""
    jc, tc, prompt = codecs
    jrec, trec = _Recording(jc), _Recording(tc)
    jh = JWD.make_vc_handler(jrec, prompt)
    th = TWD.make_vc_handler(trec, prompt)
    wav = _seeded_speech(2.0, 24000, 3)
    got, want = [], []
    for i in range(0, len(wav), TP.FRAME_SAMPLES):
        frame = wav[i: i + TP.FRAME_SAMPLES]
        g, w = th(frame), np.asarray(jh(frame), np.float32)
        assert g.shape == w.shape and g.dtype == np.float32
        got.append(g)
        want.append(w)
    # 25 tokens of 80 ms; the last waits for audio beyond the 2 s
    assert len(trec.tokens) == len(jrec.tokens) == 24
    np.testing.assert_array_equal(np.concatenate(trec.tokens),
                                  np.concatenate(jrec.tokens))
    got, want = np.concatenate(got), np.concatenate(want)
    hop = (tc.decoder.pipe_cfg.block_size * tc.decoder.ratio
           * tc.decoder.hift_cfg.total_upsample)
    assert len(got) >= 4 * hop                  # at least four hops out
    peak = float(np.abs(want).max())
    assert peak > 0.05, "trivial waveform"
    assert float(np.abs(got - want).max()) <= VC_REL_TOL * peak


def test_compare_handler_matches_jax():
    """``make_compare_handler`` with and without ``prep`` on a stand-in
    codec, against the JAX handler: the same prompts prepared the same
    way, the same wavs."""
    calls = {}

    class FakeCodec:
        def __init__(self, name):
            self.name = name
            calls[name] = []

        def prepare_prompt(self, w24, w16, pick_loudest_seconds=None,
                           target_rms=None):
            calls[self.name].append((pick_loudest_seconds, target_rms))
            return "prepped"

        def convert_voice(self, wav16, prompt, streaming=False):
            calls[self.name].append((prompt, streaming))
            return wav16[None, :24000] * (0.5 if streaming else 1.0)

    rng = np.random.RandomState(1)
    w24 = (rng.randn(9600) * 0.1).astype(np.float32)
    w16 = (rng.randn(6400) * 0.1).astype(np.float32)
    wav = (rng.randn(24000) * 0.1).astype(np.float32)
    th = TWD.make_compare_handler(FakeCodec("t"), "raw", (w24, w16))
    jh = JWD.make_compare_handler(FakeCodec("j"), "raw", (w24, w16))
    for prep in (False, True):
        got, want = th(wav, prep=prep), jh(wav, prep=prep)
        assert set(got) == set(want) == {"offline", "streaming"}
        for k in got:
            np.testing.assert_array_equal(got[k]["wav"], want[k]["wav"])
            assert got[k]["seconds"] >= 0 and got[k]["rtf"] >= 0
    assert calls["t"] == calls["j"]
    assert calls["t"][0] == ("raw", False)
    assert calls["t"][2][0] == pytest.approx(0.8 * 6400 / 16000)
    assert TWD._wav_b64(got["offline"]["wav"], 24000) == JWD._wav_b64(
        want["offline"]["wav"], 24000)


# ------------------------------------------------------------------ boot
def test_boot_warmups_on_the_cpu(decoders, codecs):
    """``boot_warmup_batcher`` drives the warm-up streams through the
    instance that serves, which then decodes a request exactly as a
    batcher that was never warmed (no graphs on the CPU);
    ``boot_warmup`` runs the windowed session and the tokenizer."""
    _, tdec = decoders
    req = _requests(tdec.flow_cfg)[0]

    def decode(b):
        lane = b.admit(np.asarray(req["prompt_token"], np.int32),
                       np.asarray(req["prompt_feat"], np.float32),
                       np.asarray(req["embedding"], np.float32))
        b.push(lane, np.asarray(req["tokens"], np.int32))
        b.finish(lane)
        out = []
        while b._lanes[lane].active:
            out += [v for k, v in b.pump(max_iters=8).items() if k == lane]
        return np.concatenate(out, axis=1)

    warm = tdec.kv_batcher(n_lanes=2, block_size=HOP, ring_tokens=RING,
                           token_cap=64)
    prompt = types.SimpleNamespace(
        token=np.asarray(req["prompt_token"], np.int32),
        feat=np.asarray(req["prompt_feat"], np.float32),
        embedding=np.asarray(req["embedding"], np.float32))
    assert TBoot.boot_warmup_batcher(warm, prompt=prompt, verbose=False) > 0
    assert warm.ticks > 0 and warm._steps.graphs == {}
    cold = tdec.kv_batcher(n_lanes=2, block_size=HOP, ring_tokens=RING,
                           token_cap=64)
    np.testing.assert_array_equal(decode(warm), decode(cold))
    _, tc, vprompt = codecs
    assert TBoot.boot_warmup(codec=tc, prompt=vprompt, n_tokens=12,
                             verbose=False) > 0
    assert TBoot.boot_warmup(decoder=tdec, n_tokens=6, verbose=False) > 0


# ---------------------------------------------------------- entry points
def test_entry_points_need_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from moss_speech_decoder_cosy_torch.bin import inference as TI
    from moss_speech_decoder_cosy_torch.models.campplus import (
        CAMPPlus, SpeakerEncoder)
    args = types.SimpleNamespace(
        flow_version="v2", bf16=False, block_size=5, max_token_len=40,
        model_dir=None, flow_ckpt=None, hift_ckpt=None, tokenizer_ckpt=None,
        device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TI.build_decoder(args)
    path = tmp_path / "campplus.onnx"
    path.write_bytes(b"")
    with pytest.raises(ValueError, match="graph"):
        SpeakerEncoder.from_onnx(str(path), device="cpu")
    with torch.device("meta"):
        model = CAMPPlus(embedding_size=4, growth_rate=2, bn_size=1,
                         init_channels=4, block_layers=(1,),
                         block_dilations=(1,))
    from test_torch_checkpoint import onnx_bytes, reference_sd
    from moss_speech_decoder_cosy_torch.weights import seeded_state
    sd = {k: v.numpy() for k, v in reference_sd(
        "campplus", (1,), seeded_state(model, 0)).items()}
    path.write_bytes(onnx_bytes(sd))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpeakerEncoder.from_onnx(str(path), model)
    spk = SpeakerEncoder.from_onnx(str(path), model, device="cpu")
    assert spk(np.zeros(16000, np.float32)).shape == (1, 4)


_BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys
for name in ("aiohttp", "yaml", "safetensors"):
    sys.modules[name] = None
import moss_speech_decoder_cosy_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not any(n.split(".")[0] in ("jax", "flax", "moss_speech_decoder_cosy_tpu")
               for n in sys.modules), "the port imported JAX"
from moss_speech_decoder_cosy_torch.serving import audio_batcher, web_demo, ws_server
for build in (lambda: ws_server.AudioWsServer(), lambda: web_demo.WebDemo(),
              lambda: audio_batcher.AudioBatcherHTTPServer(None)):
    try:
        build()
    except ImportError as e:
        assert "aiohttp" in str(e), e
    else:
        raise AssertionError("built a server without aiohttp")
print("IMPORTED", len(names))
"""


def test_port_imports_without_aiohttp_yaml_safetensors():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split("IMPORTED")[1])
    assert n >= 60, r.stdout
