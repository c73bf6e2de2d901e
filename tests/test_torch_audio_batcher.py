"""The port's asyncio serving engine (``serving/audio_batcher.py``) on the
CPU, tiny configs, f32:

- two concurrent asyncio clients, each pushing its tokens in pieces, get
  exactly the audio the same streams give decoded one after the other
  through the same engine (the JAX package's
  ``test_engine_concurrent_clients_match_sequential``);
- ``plan_lanes`` counts ring and conv-cache bytes apart: its per-lane bytes
  equal the batcher's allocated pool over its lanes and are at most the
  JAX package's figure (which extends the conv caches too); a budget that
  fits gives the JAX package's plan, and one that needs int8 rings
  raises."""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from moss_speech_decoder_cosy_tpu.serving import audio_batcher as JB
from moss_speech_decoder_cosy_tpu.utils import config as jcfg
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


def test_plan_lanes_counts_the_pool(dec):
    n, quant, per_lane, note = plan_lanes(dec, 4, RING, HOP, 1 << 30)
    assert (n, quant) == (4, False) and "fit" in note
    b = dec.kv_batcher(n_lanes=4, block_size=HOP, ring_tokens=RING,
                       token_cap=16)
    pool = b._est_g
    leaves = (list(pool["kv"]["mid"]) + [pool["kv"]["down"],
                                         pool["kv"]["up"]])
    stack = [pool["convs"]]
    while stack:
        for v in stack.pop().values():
            (stack.append if isinstance(v, dict) else leaves.append)(v)
    allocated = sum(t.numel() * t.element_size() for t in leaves)
    assert per_lane * 4 == allocated
    jn, jquant, jper_lane, _ = JB.plan_lanes(_jax_stand_in(dec), 4, RING,
                                             HOP, 1 << 30)
    assert (jn, jquant) == (n, quant)
    assert per_lane <= jper_lane


def test_plan_lanes_needing_int8_rings_raises(dec):
    _, _, per_lane, _ = plan_lanes(dec, 4, RING, HOP, 1 << 30)
    assert plan_lanes(dec, 4, RING, HOP, 4 * per_lane)[0] == 4
    with pytest.raises(NotImplementedError, match="A3"):
        plan_lanes(dec, 4, RING, HOP, 4 * per_lane - 1)
    with pytest.raises(NotImplementedError, match="A3"):
        AudioBatchEngine(dec, n_lanes=4, block_size=HOP, ring_tokens=RING,
                         hbm_budget_bytes=4 * per_lane - 1)
    engine = AudioBatchEngine(dec, n_lanes=4, block_size=HOP,
                              ring_tokens=RING, token_cap=16,
                              hbm_budget_bytes=4 * per_lane)
    assert engine.lane_plan["per_lane_bytes"] == per_lane
    assert torch.device(engine.batcher.dev).type == "cpu"
