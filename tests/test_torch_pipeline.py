"""The port's AudioDecoder (token2wav, stream_inference) against the JAX
AudioDecoder on the tiny configs, f32 on the CPU, plus the weight bridge's
coverage.

The port runs the slice's configuration, ``use_flash_attention=True`` (the
kernel's plain version on the CPU); the JAX side runs its XLA attention
path, which tests/test_pallas_attention.py pins to its flash kernel.  The
port's NSF source is fed the JAX draws (``PRNGKey(0)``)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.flow import (
    CausalMaskedDiffWithXvec as JFlow)
from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator as JHiFT
from moss_speech_decoder_cosy_tpu.pipeline import AudioDecoder as JDecoder
from moss_speech_decoder_cosy_tpu.utils.config import (
    PipelineConfig, tiny_flow_config, tiny_hift_config)
from moss_speech_decoder_cosy_torch.models.flow import (
    CausalMaskedDiffWithXvec as TFlow)
from moss_speech_decoder_cosy_torch.models.hift import HiFTGenerator as THiFT
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder as TDecoder
from moss_speech_decoder_cosy_torch.utils import config as tcfg
from moss_speech_decoder_cosy_torch.weights import (
    flow_state_from_jax, hift_state_from_jax)

# mel parity is 2e-4 (tests/test_torch_flow.py); the iSTFT head turns that
# into at most this much on the waveform at the tiny configs' amplitude
WAV_ATOL = 2e-4


def jax_draws(harmonics, length, device):
    k_ini, k_noise = jax.random.split(jax.random.PRNGKey(0))
    rand_ini = jax.random.uniform(k_ini, (1, harmonics), dtype=jnp.float32)
    noise = jax.random.normal(k_noise, (1, length, harmonics), jnp.float32)
    return (torch.from_numpy(np.array(rand_ini)).to(device),
            torch.from_numpy(np.array(noise)).to(device))


def _leaf_count(params):
    return len(jax.tree_util.tree_leaves(params))


@pytest.fixture(scope="module")
def params():
    fcfg, hcfg = tiny_flow_config(), tiny_hift_config()
    fp = jax.jit(JFlow(fcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), jnp.zeros((1, 0, fcfg.output_size)),
        jnp.zeros((1, fcfg.spk_embed_dim)))
    hp = jax.jit(JHiFT(hcfg).init)(jax.random.PRNGKey(1),
                                   jnp.zeros((1, 8, hcfg.in_channels)))
    hp = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 200.0 if "conv_post" in str(path)
        and str(path[-1]) == "['g']" else a, hp)
    return fp, hp


@pytest.fixture(scope="module")
def decoders(params):
    fp, hp = params
    pipe = PipelineConfig(block_size=4, mel_cache_len=6, max_token_len=16)
    jdec = JDecoder(tiny_flow_config(), tiny_hift_config(), fp, hp, pipe)
    fcfg = tcfg.tiny_flow_config()
    fcfg = dataclasses.replace(fcfg, estimator=dataclasses.replace(
        fcfg.estimator, use_flash_attention=True))
    tdec = TDecoder(
        fcfg, tcfg.tiny_hift_config(),
        flow_state_from_jax(jax.tree.map(np.asarray, fp)),
        hift_state_from_jax(jax.tree.map(np.asarray, hp)),
        tcfg.PipelineConfig(block_size=4, mel_cache_len=6, max_token_len=16),
        device="cpu", nsf_draws=jax_draws)
    return jdec, tdec


def _close(got, want, atol=WAV_ATOL):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(want).max() > 0.05, "trivial waveform"
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_token2wav_matches_jax(decoders):
    jdec, tdec = decoders
    tok = np.random.RandomState(0).randint(0, 64, (1, 20))
    _close(tdec.token2wav(tok), jdec.token2wav(tok))


def test_token2wav_with_prompt_and_speed_match_jax(decoders):
    jdec, tdec = decoders
    rng = np.random.RandomState(1)
    p_tok = rng.randint(0, 64, (1, 4))
    p_feat = rng.randn(1, 16, 16).astype(np.float32) * 0.1
    emb = rng.randn(1, 12).astype(np.float32)
    tok = rng.randint(0, 64, (1, 12))
    _close(tdec.token2wav(tok, p_tok, p_feat, emb),
           jdec.token2wav(tok, p_tok, p_feat, emb))
    _close(tdec.token2wav(tok, speed=1.25), jdec.token2wav(tok, speed=1.25))


@pytest.mark.parametrize("prompt", [False, True])
def test_stream_inference_matches_jax(decoders, prompt):
    """Windowed streaming: sliding token window, HiFT caches, cross-fades;
    a 3-token prompt exercises the first-hop padding."""
    jdec, tdec = decoders
    rng = np.random.RandomState(2)
    tok = rng.randint(0, 64, (1, 17))
    args = ()
    if prompt:
        args = (rng.randint(0, 64, (1, 3)),
                rng.randn(1, 12, 16).astype(np.float32) * 0.1)
    got = tdec.stream_inference(tok, *args)
    assert got.shape == (1, 17 * 4 * tdec.hift_cfg.total_upsample)
    _close(got, jdec.stream_inference(tok, *args))


def test_incremental_push_equals_one_shot(decoders):
    _, tdec = decoders
    tok = np.random.RandomState(3).randint(0, 64, (1, 23))
    sess = tdec.new_session()
    chunks = []
    for i in range(0, 23, 7):
        chunks += list(sess.push(tok[0, i:i + 7]))
    chunks += list(sess.finish())
    np.testing.assert_allclose(np.concatenate(chunks, axis=-1),
                               tdec.stream_inference(tok), atol=1e-6)


def test_bf16_and_hybrid_estimator_dtypes(params):
    """bf16 compute runs finite; the bf16-encoder / f32-estimator hybrid
    is closer to f32 than all-bf16, as in the JAX package."""
    fp, hp = params
    fs = flow_state_from_jax(jax.tree.map(np.asarray, fp))
    hs = hift_state_from_jax(jax.tree.map(np.asarray, hp))
    pipe = tcfg.PipelineConfig(block_size=4, mel_cache_len=4,
                               max_token_len=16)
    tok = np.random.RandomState(0).randint(0, 64, (1, 24))
    none = (np.zeros((1, 0), np.int64), np.zeros((1, 0, 16), np.float32),
            np.zeros((1, 12), np.float32))
    mels = {}
    for name, kw in [("f32", {}),
                     ("bf16", dict(compute_dtype=torch.bfloat16)),
                     ("hybrid", dict(compute_dtype=torch.bfloat16,
                                     estimator_dtype=torch.float32))]:
        dec = TDecoder(tcfg.tiny_flow_config(), tcfg.tiny_hift_config(), fs,
                       hs, pipe, device="cpu", **kw)
        mels[name] = dec._flow_mel(tok, *none, streaming=False,
                                   finalize=True)
        if name == "bf16":
            wav = dec.stream_inference(tok)
            assert wav.dtype == np.float32 and np.isfinite(wav).all()
    scale = np.abs(mels["f32"]).mean()
    err_bf16 = np.abs(mels["bf16"] - mels["f32"]).mean() / scale
    err_hyb = np.abs(mels["hybrid"] - mels["f32"]).mean() / scale
    assert err_hyb < err_bf16 / 2 and err_hyb < 0.02, (err_hyb, err_bf16)


@pytest.mark.parametrize("which", ["flow", "hift"])
def test_weights_map_every_leaf_once(params, which):
    fp, hp = params
    tree = fp if which == "flow" else hp
    convert = flow_state_from_jax if which == "flow" else hift_state_from_jax
    state = convert(jax.tree.map(np.asarray, tree))
    assert len(state) == _leaf_count(tree)
    module = (TFlow(tcfg.tiny_flow_config()) if which == "flow"
              else THiFT(tcfg.tiny_hift_config()))
    assert set(state) == set(module.state_dict())
    module.load_state_dict(state, strict=True)
