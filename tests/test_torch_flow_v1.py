"""The port's CosyVoice-v1 flow (``models/flow/flow_v1.py`` and the conformer
layer's macaron FF and conv module) against the JAX package, f32 on the CPU,
on a tiny v1 topology (50 Hz tokens, rel_pos_espnet encoder, two-level
non-causal U-Net); the weights go from flax params through
``weights.flow_v1_state_from_jax``.  Mels within 2e-5.

- the conformer layer with macaron FF and conv module (layer norm, batch
  norm with drawn running statistics, causal), padded rows masked;
- ``ConformerEncoder`` without and with the grid mask
  (``BlockConformerEncoder``);
- ``InterpolateRegulator.inference`` at 30 and 60 tokens (the head / mid /
  tail split above 40), with and without a prompt;
- ``MaskedDiffWithXvec.inference`` with and without a prompt, then again
  from the cache it returned; a chunk shorter than the cache raises
  ``ValueError``;
- the flash path of the two-level non-causal estimator: the port with
  flash equals the JAX package with flash off, while the JAX package with
  flash on differs by more than 0.1 (it masks the half-rate level with the
  full-rate length and lets the non-causal blocks see its padding);
- the presets: ``cosyvoice1_flow_config()`` equal to JAX's,
  ``cosyvoice1_hift_config()`` at 256 samples a frame, the CFM noise at
  its 15000 frames equal to JAX's.

Torch runs on one thread here, as in the other port test modules."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.flow import encoder as JE
from moss_speech_decoder_cosy_tpu.models.flow import flow_v1 as JV1
from moss_speech_decoder_cosy_tpu.models.flow.estimator import (
    CausalConditionalDecoder as JEstimator)
from moss_speech_decoder_cosy_tpu.ops.embeddings import (
    espnet_rel_pos as j_espnet)
from moss_speech_decoder_cosy_tpu.ops.masks import (
    chunk_attention_mask as j_mask)
from moss_speech_decoder_cosy_tpu.utils import config as JC
from moss_speech_decoder_cosy_torch.models.flow import encoder as TE
from moss_speech_decoder_cosy_torch.models.flow import flow_v1 as TV1
from moss_speech_decoder_cosy_torch.models.flow.estimator import (
    CausalConditionalDecoder as TEstimator)
from moss_speech_decoder_cosy_torch.ops.embeddings import (
    espnet_rel_pos as t_espnet)
from moss_speech_decoder_cosy_torch.ops.masks import (
    chunk_attention_mask as t_mask)
from moss_speech_decoder_cosy_torch.utils import config as TC
from moss_speech_decoder_cosy_torch.weights import (
    flow_state_from_jax, flow_v1_state_from_jax, state_from_jax_tree)

ATOL = 2e-5
N_MEL, SPK = 16, 12


def tiny_v1_config(C, **enc):
    """The tiny v1 topology in config module ``C`` (JAX's or the port's)."""
    return C.FlowConfig(
        vocab_size=64, input_size=32, output_size=N_MEL, spk_embed_dim=SPK,
        input_frame_rate=50,
        encoder=C.EncoderConfig(
            input_size=32, output_size=32, attention_heads=2,
            linear_units=48, num_blocks=2, dropout_rate=0.0,
            pos_enc_layer_type="rel_pos_espnet", **enc),
        estimator=C.EstimatorConfig(
            in_channels=4 * N_MEL, out_channels=N_MEL, channels=(16, 16),
            attention_head_dim=8, n_blocks=1, num_mid_blocks=1, num_heads=2,
            causal=False),
        cfm=C.CFMConfig(n_timesteps=4, max_noise_len=1024))


def seeded_bn(tree, seed):
    """flax params with every ``running_mean`` / ``running_var`` drawn."""
    rng = np.random.RandomState(seed)

    def go(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = go(v)
            elif k == "running_mean":
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            elif k == "running_var":
                out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return go(tree)


def init_v1(cfg, seed=0):
    """JAX ``MaskedDiffWithXvec(cfg)`` params (numpy leaves)."""
    jm = JV1.MaskedDiffWithXvec(cfg)
    params = jax.jit(lambda k: jm.init(
        k, jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 3), jnp.int32),
        jnp.zeros((1, 5, N_MEL)), jnp.zeros((1, SPK)), 13,
        method=jm.inference))(jax.random.PRNGKey(seed))
    return jm, seeded_bn(jax.tree.map(np.asarray, params), seed + 1)


def port_v1(cfg_t, params):
    tm = TV1.MaskedDiffWithXvec(cfg_t)
    tm.load_state_dict(flow_v1_state_from_jax(params), strict=True)
    return tm.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flow():
    jm, params = init_v1(tiny_v1_config(JC))
    return jm, params, port_v1(tiny_v1_config(TC), params)


@pytest.mark.parametrize("norm,causal", [("layer_norm", False),
                                         ("batch_norm", False),
                                         ("layer_norm", True)])
def test_conformer_layer_macaron_conv_matches_jax(norm, causal):
    kw = dict(macaron_style=True, use_cnn_module=True, cnn_module_norm=norm,
              cnn_causal=causal, cnn_module_kernel=7)
    jcfg = tiny_v1_config(JC, **kw).encoder
    tcfg = tiny_v1_config(TC, **kw).encoder
    rng = np.random.RandomState(2)
    b, t, d = 2, 11, jcfg.output_size
    x = rng.randn(b, t, d).astype(np.float32)
    valid = np.ones((b, t), bool)
    valid[1, 8:] = False
    jl = JE.ConformerEncoderLayer(jcfg)
    args = (jnp.asarray(x), j_mask(jnp.asarray(valid), 0),
            j_espnet(t, d), jnp.asarray(valid))
    params = seeded_bn(jax.tree.map(np.asarray, jax.jit(jl.init)(
        jax.random.PRNGKey(4), *args)), 5)
    want = jax.jit(jl.apply)(params, *args)
    tl = TE.ConformerEncoderLayer(tcfg)
    tl.load_state_dict(state_from_jax_tree(
        params, same={"running_mean", "running_var"}), strict=True)
    assert (norm == "batch_norm") == hasattr(tl.conv_module, "running_var")
    with torch.no_grad():
        got = tl.eval()(_t(x), t_mask(_t(valid), 0), t_espnet(t, d),
                        _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("block", [0, 4])
def test_conformer_encoder_matches_jax(flow, block):
    """Without (v1 flow) and with the grid mask (the block conformer)."""
    _, params, tm = flow
    cfg = tiny_v1_config(JC).encoder
    rng = np.random.RandomState(3)
    x = rng.randn(1, 13, cfg.input_size).astype(np.float32)
    valid = np.ones((1, 13), bool)
    want = jax.jit(JV1.ConformerEncoder(cfg, static_chunk_size=block).apply)(
        {"params": params["params"]["encoder"]}, jnp.asarray(x),
        jnp.asarray(valid))
    enc = (TV1.BlockConformerEncoder(tiny_v1_config(TC).encoder, block)
           if block else TV1.ConformerEncoder(tiny_v1_config(TC).encoder))
    enc.load_state_dict(tm.encoder.state_dict(), strict=True)
    with torch.no_grad():
        got = enc(_t(x), _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    if block:       # the grid mask matters: it differs from full context
        with torch.no_grad():
            full = tm.encoder(_t(x), _t(valid))
        assert float((full - got).abs().max()) > 1e-3


@pytest.mark.parametrize("n_tok", [30, 60])
@pytest.mark.parametrize("n_prompt", [0, 6])
def test_interpolate_regulator_matches_jax(flow, n_tok, n_prompt):
    """Above 40 tokens the target is split at 20 tokens from each end."""
    _, params, tm = flow
    rng = np.random.RandomState(n_tok + n_prompt)
    x1 = rng.randn(1, n_prompt, N_MEL).astype(np.float32)
    x2 = rng.randn(1, n_tok, N_MEL).astype(np.float32)
    mel_len1 = int(round(n_prompt * 22050 / 256 / 50))
    mel_len2 = int(n_tok / 50 * 22050 / 256)
    reg = JV1.InterpolateRegulator(N_MEL)
    want = reg.apply({"params": params["params"]["length_regulator"]},
                     jnp.asarray(x1), jnp.asarray(x2), mel_len1, mel_len2,
                     50.0, method=reg.inference)
    with torch.no_grad():
        got = tm.length_regulator.inference(_t(x1), _t(x2), mel_len1,
                                            mel_len2, 50.0)
    assert got.shape == (1, mel_len1 + mel_len2, N_MEL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _inputs(n_tok, n_prompt, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 64, (1, n_tok)), rng.randint(0, 64, (1, n_prompt)),
            (rng.randn(1, int(round(n_prompt * 22050 / 256 / 50)), N_MEL)
             * 0.5).astype(np.float32),
            rng.randn(1, SPK).astype(np.float32))


@pytest.mark.parametrize("n_tok,n_prompt", [(30, 0), (60, 6)])
def test_flow_inference_and_cache_match_jax(flow, n_tok, n_prompt):
    """Offline, then a second chunk from the returned z / mu cache."""
    jm, params, tm = flow
    tok, pt, pf, emb = _inputs(n_tok, n_prompt, 7)
    mel_len2 = int(n_tok / 50 * 22050 / 256)
    run = jax.jit(lambda *a: jm.apply(params, *a[:4], mel_len2, a[4],
                                      method=jm.inference))
    want, want_cache = run(tok, pt, pf, emb, None)
    with torch.no_grad():
        got, cache = tm.inference(_t(tok), _t(pt), _t(pf), _t(emb),
                                  mel_len2)
    assert got.shape == (1, mel_len2, N_MEL)
    assert cache.shape == (1, pf.shape[1] + TV1.CACHE_TAIL, N_MEL, 2)
    assert float(np.abs(np.asarray(want)).max()) > 0.5, "trivial mel"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(cache.numpy(), np.asarray(want_cache),
                               atol=ATOL, rtol=0)
    want2, _ = run(tok, pt, pf, emb, want_cache)
    with torch.no_grad():
        got2, _ = tm.inference(_t(tok), _t(pt), _t(pf), _t(emb), mel_len2,
                               cache)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=ATOL,
                               rtol=0)
    assert float(np.abs(np.asarray(want2) - np.asarray(want)).max()) > 1e-3


def test_chunk_shorter_than_its_cache_raises(flow):
    _, _, tm = flow
    tok, pt, pf, emb = _inputs(10, 6, 8)
    cache = torch.zeros(1, pf.shape[1] + TV1.CACHE_TAIL, N_MEL, 2)
    with pytest.raises(ValueError, match="too short"):
        tm.inference(_t(tok), _t(pt), _t(pf), _t(emb),
                     int(10 / 50 * 22050 / 256), cache)


def test_flash_matches_the_masked_path_not_jax_flash():
    """The two-level non-causal U-Net with flash: the port (its kernel's
    plain version on the CPU, each level at its own length) equals the JAX
    masked-bias path (flash off); the JAX flash path (T padded to 512, the
    full-rate length at every level) is far from both."""
    ecfg = tiny_v1_config(JC).estimator
    rng = np.random.RandomState(9)
    b, t, d = 2, 40, N_MEL
    args = [jnp.asarray(a) for a in (
        rng.randn(b, t, d).astype(np.float32), np.ones((b, t), bool),
        rng.randn(b, t, d).astype(np.float32),
        np.array([0.3, 0.8], np.float32), rng.randn(b, d).astype(np.float32),
        (rng.randn(b, t, d) * 0.3).astype(np.float32))]
    params = jax.jit(JEstimator(ecfg).init)(jax.random.PRNGKey(10), *args)
    jax_off = np.asarray(jax.jit(JEstimator(ecfg).apply)(params, *args))
    on = dataclasses.replace(ecfg, use_flash_attention=True)
    jax_on = np.asarray(jax.jit(JEstimator(on).apply)(params, *args))
    est = TEstimator(dataclasses.replace(tiny_v1_config(TC).estimator,
                                         use_flash_attention=True))
    tree = {"params": {"decoder": {"estimator": params["params"]}}}
    pre = "decoder.estimator."
    est.load_state_dict({k[len(pre):]: v for k, v in flow_state_from_jax(
        jax.tree.map(np.asarray, tree)).items()}, strict=True)
    with torch.no_grad():
        port_on = est(*(_t(a) for a in args)).numpy()
    np.testing.assert_allclose(port_on, jax_off, atol=ATOL, rtol=0)
    assert np.abs(jax_on - jax_off).max() > 0.1
    assert np.abs(jax_on - port_on).max() > 0.1


def test_presets():
    """The v1 flow preset is the JAX package's; the v1 HiFT preset carries
    CosyVoice-300M's published rates (256 samples a frame) where the JAX
    preset keeps the 24 kHz ones (480)."""
    assert dataclasses.asdict(TC.cosyvoice1_flow_config()) == \
        dataclasses.asdict(JC.cosyvoice1_flow_config())
    h = TC.cosyvoice1_hift_config()
    assert h.sampling_rate == 22050 and h.total_upsample == 256
    assert h.upsample_rates == (8, 8) and h.upsample_kernel_sizes == (16, 16)
    assert h.source_resblock_kernel_sizes == (7, 11)
    assert JC.cosyvoice1_hift_config().total_upsample == 480
    e = TC.cosyvoice1_flow_config().estimator
    # 64 attention blocks a forward: 4 + 4 down, 48 mid, 4 + 4 up
    assert (2 * len(e.channels) + e.num_mid_blocks) * e.n_blocks == 64
    # the CFM noise at v1's 15000 frames: JAX's first rows
    from moss_speech_decoder_cosy_tpu.models.flow.cfm import (
        _fixed_noise as j_noise)
    from moss_speech_decoder_cosy_torch.models.flow.cfm import (
        _fixed_noise as t_noise)
    n = TC.cosyvoice1_flow_config().cfm.max_noise_len
    np.testing.assert_array_equal(t_noise(n, N_MEL)[:, :900],
                                  j_noise(n, N_MEL)[:, :900])
