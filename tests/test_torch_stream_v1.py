"""The port's CosyVoice-v1 streaming session (``pipeline/stream_v1.py``)
against the JAX package's ``StreamSessionV1``, f32 on the CPU, on the tiny
v1 flow of ``test_torch_flow_v1`` and a tiny 22.05 kHz HiFT (the port fed
the JAX source's draws), with a prompt and hops of 30 tokens growing by 1.2
to 40 (150 tokens: windows of 50, 56 and 60 tokens, then the last 44):

- the hop schedule: the windows, the hop lengths and the flow calls;
- the chunks pushed 7 tokens at a time equal the chunks of one push, bit
  for bit;
- each chunk's wav within 1e-4 of the JAX session's, lengths equal;
- ``fade_in_out`` equal to JAX's.

Torch runs on one thread here, as in the other port test modules."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator as JHiFT
from moss_speech_decoder_cosy_tpu.pipeline import stream_v1 as JS
from moss_speech_decoder_cosy_tpu.utils import config as JC
from moss_speech_decoder_cosy_torch.models.hift import HiFTGenerator as THiFT
from moss_speech_decoder_cosy_torch.pipeline import stream_v1 as TS
from moss_speech_decoder_cosy_torch.utils import config as TC
from moss_speech_decoder_cosy_torch.weights import hift_state_from_jax

from test_torch_flow_v1 import N_MEL, SPK, init_v1, port_v1, tiny_v1_config
from test_torch_hift import jax_phase_draws

WAV_ATOL = 1e-4
N_TOKENS, N_PROMPT = 150, 6
HOPS = dict(token_min_hop_len=30, token_max_hop_len=40,
            stream_scale_factor=1.2)


def tiny_hift_22k(C):
    return dataclasses.replace(C.tiny_hift_config(), in_channels=N_MEL,
                               sampling_rate=22050)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jflow, fparams = init_v1(tiny_v1_config(JC), seed=20)
    jh = JHiFT(tiny_hift_22k(JC))
    hparams = jax.jit(jh.init)(jax.random.PRNGKey(21),
                               jnp.zeros((1, 8, N_MEL)))
    hparams = jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(
        lambda path, a: a * 200.0 if "conv_post" in str(path)
        and str(path[-1]) == "['g']" else a, hparams))
    th = THiFT(tiny_hift_22k(TC))
    th.load_state_dict(hift_state_from_jax(hparams), strict=True)
    th.draws = jax_phase_draws
    rng = np.random.RandomState(22)
    prompt = (rng.randint(0, 64, (1, N_PROMPT)),
              (rng.randn(1, int(round(N_PROMPT * 22050 / 256 / 50)), N_MEL)
               * 0.5).astype(np.float32),
              rng.randn(1, SPK).astype(np.float32))
    tokens = rng.randint(0, 64, N_TOKENS)
    return (jflow, fparams, jh, hparams,
            port_v1(tiny_v1_config(TC), fparams), th.eval(), prompt, tokens)


def _port_session(models):
    _, _, _, _, tflow, th, prompt, _ = models
    return TS.StreamSessionV1(tflow, th, *prompt, **HOPS)


def _run(sess, tokens, piece=None):
    pieces = [tokens] if piece is None else [
        tokens[i: i + piece] for i in range(0, len(tokens), piece)]
    chunks = []
    for p in pieces:
        chunks += sess.push_tokens(p)
    return chunks + [sess.finalize()]


@pytest.fixture(scope="module")
def jax_chunks(models):
    jflow, fparams, jh, hparams, _, _, prompt, tokens = models
    sess = JS.StreamSessionV1(jflow, fparams, jh, hparams, *prompt, **HOPS)
    return [np.asarray(c) for c in _run(sess, tokens)]


def test_hop_schedule(models):
    sess = _port_session(models)
    hops = []
    for i in range(0, N_TOKENS, 10):
        before = len(sess.pending)
        sess.push_tokens(models[-1][i: i + 10])
        if len(sess.pending) < before + 10:
            hops.append(sess.token_hop_len)
    sess.finalize()
    assert sess.windows == [50, 56, 60, 44]
    assert hops == [36, 40, 40]
    assert sess.mel_overlap_len == int(20 / 50 * 22050 / 256) == 34


def test_incremental_feed_equals_one_push(models):
    tokens = models[-1]
    bulk = _run(_port_session(models), tokens)
    fed = _run(_port_session(models), tokens, piece=7)
    assert len(bulk) == len(fed) == 4
    for a, b in zip(bulk, fed):
        np.testing.assert_array_equal(a, b)


def test_chunks_match_jax(models, jax_chunks):
    got = _run(_port_session(models), models[-1])
    assert [c.shape for c in got] == [c.shape for c in jax_chunks]
    assert float(np.abs(np.concatenate(jax_chunks)).max()) > 0.05
    for g, w in zip(got, jax_chunks):
        np.testing.assert_allclose(g, w, atol=WAV_ATOL, rtol=0)


def test_fade_in_out_matches_jax():
    rng = np.random.RandomState(0)
    head = rng.randn(1, 9, 3).astype(np.float32)
    tail = rng.randn(1, 4, 3).astype(np.float32)
    win = np.hamming(8).astype(np.float32)
    np.testing.assert_array_equal(TS.fade_in_out(head, tail, win),
                                  JS.fade_in_out(head, tail, win))
