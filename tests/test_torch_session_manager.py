"""The port's ``MultiStreamManager`` (``serving/session_manager.py``) over
the port's decoder on the CPU, tiny config, seeded weights: its lifecycle
(open, push, finish, stats, close), per-stream knobs and errors, and that
the chunks it returns are those of a standalone session and of
``stream_inference`` for the same tokens (1e-6)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
from moss_speech_decoder_cosy_torch.serving.session_manager import (
    MultiStreamManager)
from moss_speech_decoder_cosy_torch.utils import config as C
from moss_speech_decoder_cosy_torch.weights import seeded_states


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread while this module runs: its tensors are tiny,
    and where the suite's workers load every core, torch's thread pool
    makes each op wait on threads that get no core (measured ~20x
    slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dec():
    cfg, hcfg = C.tiny_flow_config(), C.tiny_hift_config()
    return AudioDecoder(cfg, hcfg, *seeded_states(cfg, hcfg),
                        C.PipelineConfig(block_size=3, mel_cache_len=2,
                                         max_token_len=9), device="cpu")


def _tokens(dec, n, seed=0):
    return np.random.RandomState(seed).randint(
        0, dec.flow_cfg.vocab_size, (1, n)).astype(np.int32)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


def test_lifecycle_matches_standalone_sessions(dec):
    """Two streams with their own knobs, pushed in pieces and interleaved:
    each gets the chunks of its own standalone session, and concatenated
    the audio of ``stream_inference``; then stats, finish (idempotent) and
    close."""
    mgr = MultiStreamManager(dec, codec="opus")
    assert mgr.codec == "opus"
    tok_a, tok_b = _tokens(dec, 20), _tokens(dec, 17, seed=1)
    a = mgr.open("a", block_size=3)
    b = mgr.open("b", block_size=4, max_token_len=12)
    assert (a.session.hop, b.session.hop) == (3, 4)
    assert b.session.max_token_len == 12
    assert set(mgr.active) == {"a", "b"}

    got_a = mgr.push("a", tok_a[0, :12])
    got_b = mgr.push("b", tok_b[0, :5])
    got_a += mgr.push("a", tok_a[0, 12:]) + mgr.finish("a")
    got_b += mgr.push("b", tok_b[0, 5:]) + mgr.finish("b")
    for got, toks, kw in ((got_a, tok_a, dict(block_size=3)),
                          (got_b, tok_b, dict(block_size=4,
                                              max_token_len=12))):
        ref = dec.new_session(**kw)
        _same(got, list(ref.push(toks[0])) + list(ref.finish()))
        np.testing.assert_allclose(np.concatenate(got, axis=-1),
                                   dec.stream_inference(toks, **kw),
                                   atol=1e-6, rtol=0)

    stats = mgr.stats()
    frames = dec.ratio * dec.hift_cfg.total_upsample
    assert stats["a"] == {"emitted_samples": 20 * frames,
                          "seconds": 20 * frames / 24000, "finished": True}
    assert stats["b"]["emitted_samples"] == 17 * frames
    assert mgr.finish("a") == [] and mgr.active == []
    mgr.close("a")
    mgr.close("b")
    assert mgr.stats() == {}
    with pytest.raises(KeyError):
        mgr.push("a", tok_a[0, :3])


def test_prompted_stream(dec):
    """A stream opened with a prompt decodes as a session with it."""
    cfg = dec.flow_cfg
    rng = np.random.RandomState(2)
    prompt = SimpleNamespace(
        token=rng.randint(0, cfg.vocab_size, (1, 2)).astype(np.int32),
        feat=rng.randn(1, 2 * cfg.token_mel_ratio,
                       cfg.output_size).astype(np.float32),
        embedding=rng.randn(1, cfg.spk_embed_dim).astype(np.float32))
    toks = _tokens(dec, 14, seed=3)
    mgr = MultiStreamManager(dec)
    mgr.open("p", prompt=prompt)
    got = mgr.push("p", toks) + mgr.finish("p")
    want = dec.stream_inference(toks, prompt.token, prompt.feat,
                                prompt.embedding)
    np.testing.assert_allclose(np.concatenate(got, axis=-1), want,
                               atol=1e-6, rtol=0)


def test_errors(dec):
    mgr = MultiStreamManager(dec, max_streams=2)
    mgr.open("a")
    with pytest.raises(KeyError, match="already open"):
        mgr.open("a")
    mgr.open("b")
    with pytest.raises(RuntimeError, match="max_streams"):
        mgr.open("c")
    mgr.finish("a")
    with pytest.raises(RuntimeError, match="already finished"):
        mgr.push("a", [1, 2, 3])
    mgr.close("a")
    mgr.open("c")                     # a closed stream frees its place
    assert set(mgr.stats()) == {"b", "c"}
