"""The port's asyncio serving engine (``serving/audio_batcher.py``) on the
CPU, tiny configs, f32:

- two concurrent asyncio clients, each pushing its tokens in pieces, get
  exactly the audio the same streams give decoded one after the other
  through the same engine (the JAX package's
  ``test_engine_concurrent_clients_match_sequential``);
- ``plan_lanes`` counts ring and conv-cache bytes apart: its per-lane bytes
  equal the batcher's allocated pool over its lanes and are at most the
  JAX package's figure (which extends the conv caches too); over budgets
  that hit each of its three branches (full rings, the spill to int8
  rings, int8 rings with the lanes capped) it gives the JAX package's
  ``(n_lanes, ring_quant)``, and the engine opens its batcher with the
  plan's lanes and int8 rings."""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from moss_speech_decoder_cosy_tpu.serving import audio_batcher as JB
from moss_speech_decoder_cosy_tpu.utils import config as jcfg
from moss_speech_decoder_cosy_torch.models.flow import kv_stream as T
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
from moss_speech_decoder_cosy_torch.serving.audio_batcher import (
    AudioBatchEngine, plan_lanes)
from moss_speech_decoder_cosy_torch.utils import config as C
from moss_speech_decoder_cosy_torch.weights import seeded_states

HOP, RING = 2, 7


@pytest.fixture(scope="module")
def dec():
    flow_cfg = dataclasses.replace(
        C.tiny_flow_config(), cfm=C.CFMConfig(n_timesteps=3,
                                              max_noise_len=2048))
    hift_cfg = C.tiny_hift_config()
    flow_state, hift_state = seeded_states(flow_cfg, hift_cfg)
    # a louder vocoder head, so the waveform tolerance bites
    hift_state["conv_post.g"] = hift_state["conv_post.g"] * 200.0
    return AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                        C.PipelineConfig(block_size=HOP, mel_cache_len=2,
                                         max_token_len=9), device="cpu")


def _streams(dec):
    cfg = dec.flow_cfg
    rng = np.random.RandomState(11)
    out = []
    for n_prompt, n in ((3, 14), (0, 11)):
        out.append((rng.randint(0, cfg.vocab_size, (1, n_prompt)),
                    rng.randn(1, n_prompt * cfg.token_mel_ratio,
                              cfg.output_size).astype(np.float32),
                    rng.randn(1, cfg.spk_embed_dim).astype(np.float32),
                    rng.randint(0, cfg.vocab_size, (1, n))))
    return out


async def _client(engine, ptok, pfeat, emb, toks, pieces):
    s = await engine.open(ptok if ptok.shape[1] else None,
                          pfeat if ptok.shape[1] else None, emb)
    cuts = np.linspace(0, toks.shape[1], pieces + 1).astype(int)
    for a, b in zip(cuts[:-1], cuts[1:]):
        await s.push(toks[:, a:b])
        await asyncio.sleep(0.003)
    await s.finish()
    return np.concatenate([c async for c in s], axis=1)


def test_engine_concurrent_clients_match_sequential(dec):
    streams = _streams(dec)

    async def run(concurrent):
        engine = AudioBatchEngine(dec, n_lanes=2, block_size=HOP,
                                  ring_tokens=RING, token_cap=64)
        if concurrent:
            outs = await asyncio.gather(*[
                _client(engine, *st, pieces=3 + i)
                for i, st in enumerate(streams)])
        else:
            outs = [await _client(engine, *st, pieces=1) for st in streams]
        assert not engine._streams and engine.batcher.free_lanes == 2
        return outs

    together = asyncio.run(run(True))
    apart = asyncio.run(run(False))
    for (_, _, _, toks), got, want in zip(streams, together, apart):
        assert got.shape == want.shape == (
            1, toks.shape[1] * 4 * dec.hift_cfg.total_upsample)
        assert np.abs(want).max() > 0.05, "trivial waveform"
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _jax_stand_in(dec):
    """The structural decoder the JAX package's plan_lanes reads (as its
    tests/test_kv_batcher.py builds one), with the same geometry."""
    class P:
        block_size = dec.pipe_cfg.block_size
        max_token_len = dec.pipe_cfg.max_token_len
        mel_cache_len = dec.pipe_cfg.mel_cache_len

    class D:
        pass
    d = D()
    d.flow_cfg = dataclasses.replace(
        jcfg.tiny_flow_config(), cfm=jcfg.CFMConfig(n_timesteps=3,
                                                    max_noise_len=2048))
    d.pipe_cfg, d.compute_dtype, d.estimator_dtype = P(), None, None
    d.ratio = d.flow_cfg.token_mel_ratio
    return d


def _allocated(b) -> int:
    """Bytes of a batcher's est pool: rings (and int8 scales), conv
    caches."""
    return T.est_cache_bytes(b._est_g)


@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
def test_plan_lanes_counts_the_pool(dec, quant):
    budget = 1 << 30
    if quant:                      # just under the full rings of 4 lanes
        budget = 4 * plan_lanes(dec, 4, RING, HOP, 1 << 30)[2] - 1
    n, got_quant, per_lane, note = plan_lanes(dec, 4, RING, HOP, budget)
    assert (n, got_quant) == (4, quant)
    assert ("int8" if quant else "fit") in note
    b = dec.kv_batcher(n_lanes=4, block_size=HOP, ring_tokens=RING,
                       token_cap=16, ring_quant=quant)
    assert per_lane * 4 == _allocated(b)
    jn, jquant, jper_lane, _ = JB.plan_lanes(_jax_stand_in(dec), 4, RING,
                                             HOP, budget)
    assert (jn, jquant) == (n, got_quant)
    assert per_lane <= jper_lane


def test_plan_lanes_spills_and_caps_as_jax(dec):
    full = plan_lanes(dec, 4, RING, HOP, 1 << 30)[2]
    q = plan_lanes(dec, 4, RING, HOP, 4 * full - 1)[2]
    assert q < full
    jdec = _jax_stand_in(dec)
    jfull = JB.plan_lanes(jdec, 4, RING, HOP, 1 << 30)[2]
    assert jfull >= full          # the JAX package extends the conv caches
    assert plan_lanes(dec, 4, RING, HOP, 4 * full)[:2] == (4, False)
    for budget, want in ((4 * jfull, (4, False)), (4 * full - 1, (4, True)),
                         (4 * q, (4, True)), (4 * q - 1, (3, True)),
                         (q + 1, (1, True)), (1, (1, True))):
        n, quant, per_lane, _ = plan_lanes(dec, 4, RING, HOP, budget)
        jn, jquant, jper_lane, _ = JB.plan_lanes(jdec, 4, RING, HOP, budget)
        assert (n, quant) == (jn, jquant) == want, budget
        assert per_lane <= jper_lane
    engine = AudioBatchEngine(dec, n_lanes=4, block_size=HOP,
                              ring_tokens=RING, token_cap=16,
                              hbm_budget_bytes=3 * q)
    assert engine.lane_plan["ring_quant"] is True
    assert engine.lane_plan["n_lanes"] == engine.batcher.lanes == 3
    b = engine.batcher
    assert b._quant and not b._fused and not b._kernel
    assert _allocated(b) == 3 * q
    assert torch.device(b.dev).type == "cpu"


def test_engine_on_int8_rings_serves_a_stream(dec):
    """The capped int8 engine serves a stream as the int8 batcher does."""
    q = plan_lanes(dec, 4, RING, HOP, 1)[2]
    (ptok, pfeat, emb, toks), _ = _streams(dec)

    async def run():
        engine = AudioBatchEngine(dec, n_lanes=4, block_size=HOP,
                                  ring_tokens=RING, token_cap=64,
                                  hbm_budget_bytes=q)
        assert engine.batcher.lanes == 1 and engine.batcher._quant
        return await _client(engine, ptok, pfeat, emb, toks, pieces=2)

    got = asyncio.run(run())
    b = dec.kv_batcher(n_lanes=1, block_size=HOP, ring_tokens=RING,
                       token_cap=64, ring_quant=True)
    lane = b.admit(ptok, pfeat, emb)
    b.push(lane, toks)
    b.finish(lane)
    chunks = []
    while b._lanes[lane].active:
        chunks.extend(b.pump().values())
    np.testing.assert_allclose(got, np.concatenate(chunks, axis=1),
                               atol=2e-5, rtol=0)
