"""The tokenizer side of the codec in the port against the JAX package, f32
on the CPU, tiny configs, the same weights (``tokenizer_state_from_jax``,
``campplus_state_from_jax``, ``flow_state_from_jax``,
``hift_state_from_jax``), the port's NSF source given the JAX draws:

- ``mel_filter_bank`` equal; ``WhisperFeatureExtractor`` and
  ``StreamingFeatures`` (pushes of odd sizes) within 2e-4;
- ``kaldi_fbank`` and ``matcha_mel_spectrogram`` within 1e-4 (the fbank
  of a float64 reference too, see its test);
- ``WhisperVQEncoder``: the batch ``forward`` and the streaming ``step``
  against JAX, pooled pre-VQ features within 1e-5 and tokens equal; the
  port's streaming equal to its batch forward (the JAX package's
  ``test_tokenizer_streaming_equals_batch``);
- ``CAMPPlus`` with seeded BatchNorm running statistics (not the init's
  0 / 1, so inference BatchNorm is exercised) within 1e-5, and
  ``SpeakerEncoder`` likewise;
- ``SpeechCodec.encode`` / ``encode_streaming`` against the JAX codec on
  single and multi-segment audio: tokens equal, and streaming equal to
  batch; full segments of a position table off the bucket grid against
  the JAX tokenizer segment by segment;
- ``prepare_prompt`` (loudest segment, RMS normalization, the matcha mel,
  the CAM++ embedding) within 1e-5;
- ``convert_voice`` (tokens, then ``token2wav``) with the same NSF draws:
  wav within 1e-4.

Torch runs on one thread here, as in the other port test modules."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu import codec as JC
from moss_speech_decoder_cosy_tpu.models import campplus as JCam
from moss_speech_decoder_cosy_tpu.models.flow import CausalMaskedDiffWithXvec
from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator
from moss_speech_decoder_cosy_tpu.ops import melspec as JM
from moss_speech_decoder_cosy_tpu.ops.masks import mask_to_bias
from moss_speech_decoder_cosy_tpu.pipeline import AudioDecoder as JDecoder
from moss_speech_decoder_cosy_tpu.tokenizer import features as JF
from moss_speech_decoder_cosy_tpu.tokenizer import model as JT
from moss_speech_decoder_cosy_tpu.tokenizer import tiny_tokenizer_config
from moss_speech_decoder_cosy_tpu.utils.config import (
    PipelineConfig, tiny_flow_config, tiny_hift_config)
from moss_speech_decoder_cosy_torch import codec as TC
from moss_speech_decoder_cosy_torch.models import campplus as TCam
from moss_speech_decoder_cosy_torch.ops import melspec as TM
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder as TDecoder
from moss_speech_decoder_cosy_torch.tokenizer import config as tcfg_tok
from moss_speech_decoder_cosy_torch.tokenizer import features as TF
from moss_speech_decoder_cosy_torch.tokenizer import model as TT
from moss_speech_decoder_cosy_torch.utils import config as tcfg
from moss_speech_decoder_cosy_torch.weights import (
    campplus_state_from_jax, flow_state_from_jax, hift_state_from_jax,
    tokenizer_state_from_jax)

CAM_KW = dict(embedding_size=12, growth_rate=4, bn_size=2, init_channels=8,
              block_layers=(2, 2, 1), block_dilations=(1, 2, 2))


def jax_draws(harmonics, length, device):
    k_ini, k_noise = jax.random.split(jax.random.PRNGKey(0))
    rand_ini = jax.random.uniform(k_ini, (1, harmonics), dtype=jnp.float32)
    noise = jax.random.normal(k_noise, (1, length, harmonics), jnp.float32)
    return (torch.from_numpy(np.array(rand_ini)).to(device),
            torch.from_numpy(np.array(noise)).to(device))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tok():
    cfg = tiny_tokenizer_config()
    m = JT.WhisperVQEncoder(cfg)
    params = jax.jit(m.init)(jax.random.PRNGKey(0),
                             jnp.zeros((1, 16, cfg.num_mel_bins)),
                             jnp.ones((1, 16), bool))
    with torch.device("meta"):
        tm = TT.WhisperVQEncoder(tcfg_tok.tiny_tokenizer_config())
    tm.load_state_dict(tokenizer_state_from_jax(_np(params)), strict=True,
                       assign=True)
    return cfg, m, params, tm.eval()


def _seeded_bn(params, seed):
    """JAX CAM++ params with every BatchNorm's running statistics drawn."""
    rng = np.random.RandomState(seed)

    def go(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = go(v)
            elif k == "mean":
                out[k] = jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                     * 0.1)
            elif k == "var":
                out[k] = jnp.asarray(0.5 + rng.rand(*v.shape).astype(
                    np.float32))
            elif k in ("scale", "bias") and v.ndim == 1:
                out[k] = v + jnp.asarray(rng.randn(*v.shape).astype(
                    np.float32) * 0.1)
            else:
                out[k] = v
        return out
    return go(params)


@pytest.fixture(scope="module")
def cam():
    m = JCam.CAMPPlus(**CAM_KW)
    params = _seeded_bn(_np(jax.jit(m.init)(jax.random.PRNGKey(3),
                                            jnp.zeros((1, 50, 80)))), 4)
    with torch.device("meta"):
        tm = TCam.CAMPPlus(**CAM_KW)
    tm.load_state_dict(campplus_state_from_jax(_np(params)), strict=True,
                       assign=True)
    return m, params, tm.eval()


@pytest.fixture(scope="module")
def codecs(tok, cam):
    cfg, _, tparams, _ = tok
    jcam, cparams, _ = cam
    fcfg, hcfg = tiny_flow_config(), tiny_hift_config()
    fp = jax.jit(CausalMaskedDiffWithXvec(fcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), jnp.zeros((1, 0, fcfg.output_size)),
        jnp.zeros((1, fcfg.spk_embed_dim)))
    hp = jax.jit(HiFTGenerator(hcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 8, hcfg.in_channels)))
    hp = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 200.0 if "conv_post" in str(path)
        and str(path[-1]) == "['g']" else a, hp)
    pipe = dict(block_size=4, mel_cache_len=4, max_token_len=16)
    jdec = JDecoder(fcfg, hcfg, fp, hp, PipelineConfig(**pipe))
    tdec = TDecoder(tcfg.tiny_flow_config(), tcfg.tiny_hift_config(),
                    flow_state_from_jax(_np(fp)), hift_state_from_jax(_np(hp)),
                    tcfg.PipelineConfig(**pipe), device="cpu",
                    nsf_draws=jax_draws)
    mel_kw = dict(n_fft=96, num_mels=fcfg.output_size, sampling_rate=24000,
                  hop_size=48, win_size=96)
    jspk = JCam.SpeakerEncoder(cparams, jcam)
    tspk = TCam.SpeakerEncoder(campplus_state_from_jax(_np(cparams)),
                               _meta_cam(), device="cpu")
    # 1.28 s segments: the tiny position table's capacity
    jc = JC.SpeechCodec(cfg, tparams, jdec, speaker_encoder=jspk,
                        segment_seconds=1.28,
                        prompt_mel_fn=lambda w: JM.matcha_mel_spectrogram(
                            w, **mel_kw))
    tc = TC.SpeechCodec(tcfg_tok.tiny_tokenizer_config(),
                        tokenizer_state_from_jax(_np(tparams)), tdec,
                        speaker_encoder=tspk, segment_seconds=1.28,
                        prompt_mel_fn=lambda w: TM.matcha_mel_spectrogram(
                            w, **mel_kw), device="cpu")
    return jc, tc


def _meta_cam():
    with torch.device("meta"):
        return TCam.CAMPPlus(**CAM_KW)


def _early_peak_wav(rng, n):
    """A wav whose log-mel maximum lies in its first 80 ms, so that the
    streaming clamp (frozen at the first block) equals the batch one."""
    wav = rng.randn(n).astype(np.float32) * 0.05
    wav[:400] += np.sin(np.arange(400) * 0.3).astype(np.float32) * 0.8
    return wav


# ----------------------------------------------------------------- features
def test_mel_filter_bank_matches_jax():
    for args in ((201, 128, 16000), (49, 16, 24000, 0.0, 8000.0)):
        np.testing.assert_array_equal(TF.mel_filter_bank(*args),
                                      JF.mel_filter_bank(*args))


def test_feature_extractor_matches_jax():
    rng = np.random.RandomState(0)
    wav = rng.randn(2, 5000).astype(np.float32) * 0.3
    jfe, tfe = JF.WhisperFeatureExtractor(n_mels=8), \
        TF.WhisperFeatureExtractor(n_mels=8)
    want, jmax = jfe(jnp.asarray(wav))
    got, tmax = tfe(torch.from_numpy(wav))
    assert got.shape == want.shape == (2, 5000 // 160, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    np.testing.assert_allclose(float(tmax), float(jmax), atol=2e-4)
    want2, _ = jfe(jnp.asarray(wav), max_log_spec=jmax + 1.0)
    got2, _ = tfe(torch.from_numpy(wav), max_log_spec=tmax + 1.0)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=2e-4,
                               rtol=0)


def test_streaming_features_match_jax_and_offline():
    rng = np.random.RandomState(1)
    wav = _early_peak_wav(rng, 4321)
    jfe, tfe = JF.WhisperFeatureExtractor(n_mels=8), \
        TF.WhisperFeatureExtractor(n_mels=8)
    js, ts = JF.StreamingFeatures(jfe), TF.StreamingFeatures(tfe, "cpu")
    jout, tout = [], []
    for a, b in ((0, 150), (150, 777), (777, 2000), (2000, 4321)):
        for s, out in ((js, jout), (ts, tout)):
            f = s.push(wav[a:b])
            if f is not None:
                out.append(np.asarray(f))
    for s, out in ((js, jout), (ts, tout)):
        f = s.flush()
        if f is not None:
            out.append(np.asarray(f))
    got, want = np.concatenate(tout, 1), np.concatenate(jout, 1)
    assert got.shape == want.shape == (1, 4321 // 160, 8)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    offline, _ = tfe(torch.from_numpy(wav[None]))
    np.testing.assert_allclose(got, offline.numpy(), atol=2e-4, rtol=0)


def _kaldi_fbank_f64(wav):
    """The same Kaldi fbank in float64 numpy (an FFT, not a DFT product)."""
    w = wav.astype(np.float64)
    t = 1 + (w.shape[1] - 400) // 160
    fr = w[:, np.arange(t)[:, None] * 160 + np.arange(400)[None]]
    fr = fr - fr.mean(-1, keepdims=True)
    fr = fr - 0.97 * np.concatenate([fr[..., :1], fr[..., :-1]], -1)
    fr = fr * (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(400) / 399)) ** 0.85
    power = (np.abs(np.fft.rfft(fr, n=512, axis=-1)) ** 2)[..., :256]
    mel = power @ JM.kaldi_mel_banks(80, 512, 16000).astype(np.float64)
    return np.log(np.maximum(mel, np.finfo(np.float64).eps))


def test_kaldi_fbank_matches_jax():
    """Within 1e-4 of the float64 fbank, and of the JAX package's beyond
    the JAX package's own distance from it: after preemphasis the lowest
    bands hold little power, where an f32 DFT's cancellation moves the log
    by up to 1.7e-4 in the JAX package (measured) and 4.5e-5 in the port."""
    wav = np.random.RandomState(2).randn(2, 8000).astype(np.float32) * 0.2
    want = np.asarray(JM.kaldi_fbank(jnp.asarray(wav)))
    got = TM.kaldi_fbank(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 48, 80)
    exact = _kaldi_fbank_f64(wav)
    np.testing.assert_allclose(got, exact, atol=1e-4, rtol=0)
    assert np.all(np.abs(got - want) <= 1e-4 + np.abs(want - exact))
    np.testing.assert_array_equal(TM.kaldi_mel_banks(80, 512, 16000),
                                  JM.kaldi_mel_banks(80, 512, 16000))


@pytest.mark.parametrize("kw", [dict(), dict(n_fft=96, num_mels=16,
                                             hop_size=48, win_size=96)],
                         ids=["default", "tiny"])
def test_matcha_mel_matches_jax(kw):
    wav = np.random.RandomState(3).randn(1, 9600).astype(np.float32) * 0.2
    want = np.asarray(JM.matcha_mel_spectrogram(jnp.asarray(wav), **kw))
    got = TM.matcha_mel_spectrogram(torch.from_numpy(wav), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------- tokenizer
def _jax_pooled(m, mel, valid):
    """The JAX batch forward up to the pooled pre-VQ features (its
    ``__call__`` keeps them)."""
    x, _, _ = m._convs(mel)
    t2 = x.shape[1]
    x = x + m.embed_positions[None, :t2]
    valid2 = valid[:, ::2]
    pos = jnp.arange(t2)
    allow = pos[None, :] <= pos[:, None]
    bias = mask_to_bias(allow[None] & valid2[:, None, :], x.dtype)[:, None]
    for layer in m.layers:
        x = layer(x, bias)
    return m._pool_and_quantize(x, valid2)


def test_tokenizer_forward_matches_jax(tok):
    cfg, m, params, tm = tok
    rng = np.random.RandomState(4)
    mel = rng.randn(2, 40, cfg.num_mel_bins).astype(np.float32)
    valid = np.ones((2, 40), bool)
    valid[1, 27:] = False
    jids, jvalid, jpooled = m.apply(params, jnp.asarray(mel),
                                    jnp.asarray(valid), method=_jax_pooled)
    with torch.inference_mode():
        ids, tvalid, pooled = tm.encode(torch.from_numpy(mel),
                                        torch.from_numpy(valid))
        fids, fvalid = tm(torch.from_numpy(mel), torch.from_numpy(valid))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(fids.numpy(), ids.numpy())
    assert len(np.unique(ids.numpy())) > 1


def test_tokenizer_step_matches_jax_and_batch(tok):
    cfg, m, params, tm = tok
    rng = np.random.RandomState(5)
    mel = rng.randn(1, 48, cfg.num_mel_bins).astype(np.float32)
    jstate = m.apply(params, 1, method=m.init_state)
    tstate = tm.init_state(1)
    assert tstate.k_cache.shape == (cfg.quantize_position, 1,
                                    cfg.attention_heads,
                                    cfg.max_source_positions, cfg.head_dim)
    assert tstate.pos.device == tm.codebook.device and tstate.pos.ndim == 0

    got_ids, got_pooled = [], []
    with torch.inference_mode():
        for i in range(0, 48, 8):
            chunk = mel[:, i:i + 8]
            jids, jstate = m.apply(params, jnp.asarray(chunk), jstate,
                                   method=m.step)
            ids, pooled = tm.step_features(torch.from_numpy(chunk), tstate)
            np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
            got_ids.append(ids.numpy())
            got_pooled.append(pooled.numpy())
        assert int(tstate.pos) == 24 == int(jstate.pos)
        np.testing.assert_allclose(tstate.k_cache.numpy(),
                                   np.asarray(jstate.k_cache), atol=1e-5,
                                   rtol=0)
        bids, _, bpooled = tm.encode(torch.from_numpy(mel),
                                     torch.ones((1, 48), dtype=torch.bool))
    np.testing.assert_array_equal(np.concatenate(got_ids, 1), bids.numpy())
    np.testing.assert_allclose(np.concatenate(got_pooled, 1),
                               bpooled.numpy(), atol=1e-5, rtol=0)


# ------------------------------------------------------------------- CAM++
def test_campplus_matches_jax_with_running_statistics(cam):
    m, params, tm = cam
    assert float(tm.tdnn_bn.running_var.std()) > 0     # seeded, not 1
    feat = np.random.RandomState(6).randn(2, 130, 80).astype(np.float32)
    want = np.asarray(m.apply(params, jnp.asarray(feat)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(feat)).numpy()
    assert got.shape == want.shape == (2, 12)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_speaker_encoder_matches_jax(codecs):
    jc, tc = codecs
    wav = np.random.RandomState(7).randn(8000).astype(np.float32) * 0.1
    np.testing.assert_allclose(tc.speaker_encoder(wav),
                               jc.speaker_encoder(wav), atol=1e-5, rtol=0)


# ------------------------------------------------------------------- codec
@pytest.mark.parametrize("n,segments", [(12800, 1), (40000, 2)],
                         ids=["one_segment", "segments"])
def test_encode_matches_jax(codecs, n, segments):
    jc, tc = codecs
    wav = np.random.RandomState(8).randn(n).astype(np.float32) * 0.1
    want = jc.encode(wav)
    got = tc.encode(wav)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert n // tc.segment_samples + 1 >= segments
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("copies", [1, 3], ids=["one_segment", "segments"])
def test_encode_streaming_matches_jax_and_batch(codecs, copies):
    jc, tc = codecs
    rng = np.random.RandomState(9)
    wav = np.tile(_early_peak_wav(rng, tc.segment_samples if copies > 1
                                  else 12800), copies)
    batch = tc.encode(wav)
    for step in (None, 777):
        got = tc.encode_streaming(wav, chunk_samples=step)
        np.testing.assert_array_equal(got, batch)
        np.testing.assert_array_equal(
            got, jc.encode_streaming(wav, chunk_samples=step))


def test_segment_frames_stay_in_the_position_table():
    """At the GLM-4-Voice config a full 30 s segment is 3000 mel frames:
    375 tokens, padded to 3000 frames (its bucket, 3072, would need 1536
    of the 1500 positions); shorter segments keep their bucket."""
    cfg = tcfg_tok.glm4_voice_tokenizer_config()
    table = 2 * cfg.max_source_positions
    assert TC._segment_frames(3000, 8, table) == (375, 3000)
    assert TC._segment_frames(500, 8, table) == (62, 512)
    assert TC._segment_frames(3, 8, table) == (1, 128)


def test_encode_full_segments_off_the_bucket_grid(tok):
    """A position table that is no multiple of the 16-token bucket (60
    slots: 15 tokens, 120 frames a segment): ``encode`` over three full
    segments and a tail equals the JAX tokenizer run on each segment
    padded to the table (the JAX codec pads such a segment to 128 frames
    and overruns its table), and ``encode_streaming`` equals it."""
    jcfg = dataclasses.replace(tiny_tokenizer_config(),
                               max_source_positions=60)
    m = JT.WhisperVQEncoder(jcfg)
    params = _np(jax.jit(m.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 16, jcfg.num_mel_bins)),
                                 jnp.ones((1, 16), bool)))
    tc = TC.SpeechCodec(
        dataclasses.replace(tcfg_tok.tiny_tokenizer_config(),
                            max_source_positions=60),
        tokenizer_state_from_jax(params), None, device="cpu")
    seg = tc.segment_samples
    assert seg == 60 * 2 * 160
    base = _early_peak_wav(np.random.RandomState(13), seg)
    wav = np.concatenate([np.tile(base, 3), base[:5000]])
    jfe = JF.WhisperFeatureExtractor(n_mels=jcfg.num_mel_bins)
    want = []
    for s in range(0, len(wav), seg):
        feats, _ = jfe(jnp.asarray(wav[None, s: s + seg]))
        t = feats.shape[1]
        n_tok = t // 8
        feats = jnp.pad(feats, ((0, 0), (0, 120 - t), (0, 0)))
        valid = np.zeros((1, 120), bool)
        valid[:, : n_tok * 8] = True
        ids, token_valid = m.apply(params, feats, jnp.asarray(valid))
        want.append(np.asarray(ids)[np.asarray(token_valid)])
    want = np.concatenate(want)[None]
    got = tc.encode(wav)
    assert got.shape == want.shape == (1, 3 * 15 + 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tc.encode_streaming(wav), got)


@pytest.mark.parametrize("knobs", [dict(), dict(pick_loudest_seconds=0.25,
                                                target_rms=0.05)],
                         ids=["plain", "loudest_rms"])
def test_prepare_prompt_matches_jax(codecs, knobs):
    jc, tc = codecs
    rng = np.random.RandomState(10)
    p16 = rng.randn(6400).astype(np.float32) * 0.1
    p16[3000:4000] *= 5.0
    p24 = rng.randn(9600).astype(np.float32) * 0.1
    want = jc.prepare_prompt(p24, p16, **knobs)
    got = tc.prepare_prompt(p24, p16, **knobs)
    np.testing.assert_array_equal(got.token, want.token)
    assert got.feat.shape == want.feat.shape and got.feat.shape[1] > 0
    np.testing.assert_allclose(got.feat, want.feat, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.embedding, want.embedding, atol=1e-5,
                               rtol=0)


def test_convert_voice_matches_jax(codecs):
    jc, tc = codecs
    rng = np.random.RandomState(11)
    src = rng.randn(12800).astype(np.float32) * 0.1
    p16 = rng.randn(6400).astype(np.float32) * 0.1
    p24 = rng.randn(9600).astype(np.float32) * 0.1
    jp, tp = jc.prepare_prompt(p24, p16), tc.prepare_prompt(p24, p16)
    want = np.asarray(jc.convert_voice(src, jp))
    got = tc.convert_voice(src, tp)
    assert got.shape == want.shape and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_codec_helpers_match_jax():
    rng = np.random.RandomState(12)
    wav = rng.randn(8000).astype(np.float32) * 0.1
    wav[5000:5600] *= 8
    assert TC.calculate_rms(wav) == JC.calculate_rms(wav)
    np.testing.assert_array_equal(TC.normalize_volume(wav, 0.2),
                                  JC.normalize_volume(wav, 0.2))
    got = TC.find_loudest_segment(wav, 16000, 0.1, return_bounds=True)
    want = JC.find_loudest_segment(wav, 16000, 0.1, return_bounds=True)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    assert TC._bucket(700, 128) == JC._bucket(700, 128) == 768


def test_codec_runs_on_cuda_unless_asked(tok):
    """The codec's and the streaming features' default device is CUDA:
    without a card they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.SpeechCodec(tcfg_tok.tiny_tokenizer_config(),
                       tokenizer_state_from_jax(_np(tok[2])), None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.StreamingFeatures(TF.WhisperFeatureExtractor(n_mels=8))
