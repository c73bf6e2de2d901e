"""The port's synthesizer path (``synthesizer.py``, ``serving/
token_server.ChatAudioConsumer``) on the CosyVoice2 topology against the
JAX package, f32 on the CPU, tiny widths, the same weights:

- a tiny ``cosyvoice2_flow_config`` topology (25 Hz tokens,
  ``token_mel_ratio`` 2, ``upsample_stride`` 2): the port's ``_flow_mel``
  (offline and one streaming hop) within 2e-4 of JAX (the flow tests'
  mel tolerance) and its ``token2wav`` and ``stream_inference`` within 1e-4
  of JAX's waveforms (the NSF source fed the JAX draws);
- ``SpeechSynthesizer``: ``tts``, ``tts(streaming=True)`` and
  ``tts_stream`` give exactly the port decoder's output for the tokens the
  port's LM generated (``generate_tokens``), at least the text ratio's
  2 x 6 = 12 of them for a 6-id text;
- ``ChatAudioConsumer``: the same interleaved text / audio id stream gives
  the JAX consumer's text ids, blocks and waveform (1e-4).

Torch runs on one thread here, as in the other port test modules."""

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
from moss_speech_decoder_cosy_tpu.serving import token_server as JTS
from moss_speech_decoder_cosy_tpu.utils import config as jcfg
from moss_speech_decoder_cosy_torch.models.llm import speech_lm as TS
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder as TDecoder
from moss_speech_decoder_cosy_torch.serving import token_server as TTS
from moss_speech_decoder_cosy_torch.synthesizer import SpeechSynthesizer
from moss_speech_decoder_cosy_torch.utils import config as tcfg
from moss_speech_decoder_cosy_torch.weights import (
    flow_state_from_jax, hift_state_from_jax, seeded_state)

MEL_ATOL = 2e-4
WAV_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(harmonics, length, device):
    """The JAX HiFT source's draws (``PRNGKey(0)``)."""
    k_ini, k_noise = jax.random.split(jax.random.PRNGKey(0))
    rand_ini = jax.random.uniform(k_ini, (1, harmonics), dtype=jnp.float32)
    noise = jax.random.normal(k_noise, (1, length, harmonics), jnp.float32)
    return (torch.from_numpy(np.array(rand_ini)).to(device),
            torch.from_numpy(np.array(noise)).to(device))


def cosy2_tiny(cfg_mod):
    """The tiny flow at CosyVoice2's topology (the preset's ratios on the
    tiny widths)."""
    tiny, preset = cfg_mod.tiny_flow_config(), cfg_mod.cosyvoice2_flow_config()
    return dataclasses.replace(
        tiny, input_frame_rate=preset.input_frame_rate,
        token_mel_ratio=preset.token_mel_ratio,
        encoder=dataclasses.replace(
            tiny.encoder, upsample_stride=preset.encoder.upsample_stride))


@pytest.fixture(scope="module")
def decoders():
    fcfg_j, hcfg = cosy2_tiny(jcfg), jcfg.tiny_hift_config()
    fp = jax.jit(JFlow(fcfg_j).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), jnp.zeros((1, 0, fcfg_j.output_size)),
        jnp.zeros((1, fcfg_j.spk_embed_dim)))
    hp = jax.jit(JHiFT(hcfg).init)(jax.random.PRNGKey(1),
                                   jnp.zeros((1, 8, hcfg.in_channels)))
    pipe = dict(block_size=4, mel_cache_len=6, max_token_len=16)
    jdec = JDecoder(fcfg_j, hcfg, fp, hp, jcfg.PipelineConfig(**pipe))
    fcfg_t = cosy2_tiny(tcfg)
    assert fcfg_t.token_mel_ratio == 2 and \
        fcfg_t.encoder.upsample_stride == 2
    fcfg_t = dataclasses.replace(fcfg_t, estimator=dataclasses.replace(
        fcfg_t.estimator, use_flash_attention=True))
    tdec = TDecoder(fcfg_t, tcfg.tiny_hift_config(),
                    flow_state_from_jax(jax.tree.map(np.asarray, fp)),
                    hift_state_from_jax(jax.tree.map(np.asarray, hp)),
                    tcfg.PipelineConfig(**pipe), device="cpu",
                    nsf_draws=jax_draws)
    return jdec, tdec


def test_cosyvoice2_presets_match_jax():
    assert dataclasses.asdict(tcfg.cosyvoice2_flow_config()) == \
        dataclasses.asdict(jcfg.cosyvoice2_flow_config())


def test_cosyvoice2_topology_decode_matches_jax(decoders):
    jdec, tdec = decoders
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (1, 22)).astype(np.int32)
    ptok = rng.randint(0, 64, (1, 3)).astype(np.int32)
    pfeat = rng.randn(1, 3 * 2, 16).astype(np.float32)
    emb = rng.randn(1, 12).astype(np.float32)
    for args, kw in (((tokens, ptok, pfeat, emb),
                      dict(streaming=False, finalize=True)),
                     ((tokens[:, :11], ptok, pfeat, emb),
                      dict(streaming=True, finalize=False))):
        want = jdec._flow_mel(*args, **kw)
        got = tdec._flow_mel(*args, **kw)
        assert got.shape == want.shape
        assert got.shape[1] == (args[0].shape[1] - (
            0 if kw["finalize"] else 3)) * 2
        np.testing.assert_allclose(got, want, atol=MEL_ATOL)
    want = jdec.token2wav(tokens, ptok, pfeat, emb)
    got = tdec.token2wav(tokens, ptok, pfeat, emb)
    assert got.shape == want.shape == (
        1, 22 * 2 * tdec.hift_cfg.total_upsample)
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)
    want = jdec.stream_inference(tokens)
    got = tdec.stream_inference(tokens)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)


def test_synthesizer_paths_give_the_decoders_output(decoders):
    _, tdec = decoders
    cfg = TS.tiny_speech_lm_config()          # 32 speech tokens < vocab 64
    with torch.device("meta"):
        lm = TS.Qwen2SpeechLM(cfg)
    lm = TS.load_lm(TS.Qwen2SpeechLM, cfg, seeded_state(lm, 3), device="cpu")
    synth = SpeechSynthesizer(lm, tdec, max_tokens=20)
    text = np.random.RandomState(1).randint(0, 100, (1, 6))    # min_len 12
    tokens = synth.generate_tokens(text, seed=4)
    assert 12 <= tokens.shape[1] <= 20 and (tokens < 32).all()
    np.testing.assert_array_equal(
        tokens, synth.generate_tokens(text, seed=4))
    wav = synth.tts(text, seed=4)
    np.testing.assert_array_equal(wav, tdec.token2wav(tokens))
    swav = synth.tts(text, streaming=True, seed=4)
    ref = tdec.stream_inference(tokens)
    np.testing.assert_array_equal(swav, ref)
    chunks = list(synth.tts_stream(text, seed=4))
    np.testing.assert_array_equal(np.concatenate(chunks, -1), ref)
    assert wav.shape == swav.shape == (
        1, tokens.shape[1] * 2 * tdec.hift_cfg.total_upsample)


def test_chat_audio_consumer_matches_jax(decoders):
    jdec, tdec = decoders
    rng = np.random.RandomState(2)
    stream = []
    for i in range(4):                 # text and audio ids interleaved
        stream += list(rng.randint(0, 50, 2))
        stream += [1000 + t for t in rng.randint(0, 64, 6 + i)]
    stream += [9999, 7]
    got_c = TTS.ChatAudioConsumer(tdec, audio_offset=1000, end_token_id=9999)
    want_c = JTS.ChatAudioConsumer(jdec, audio_offset=1000,
                                   end_token_id=9999)
    for c in (got_c, want_c):
        c.BLOCK_SIZES = (4, 8, 16)
        for t in stream:
            c.push(int(t))
    got, want = got_c.finish(), want_c.finish()
    assert got_c.text_tokens == [int(t) for t in want_c.text_tokens]
    assert [w.shape for w in got_c.wav_chunks] == \
        [w.shape for w in want_c.wav_chunks]
    assert len(got_c.wav_chunks) >= 4
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)
