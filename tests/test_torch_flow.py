"""The port's flow model (encoder, estimator, CausalMaskedDiffWithXvec) against
the JAX package on ``tiny_flow_config()``, f32 on the CPU, to 2e-4 (the
tolerance of tests/test_flow.py).  One JAX init feeds both packages through
``weights.flow_state_from_jax``."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.flow import (
    CausalConditionalDecoder as JEstimator,
    CausalMaskedDiffWithXvec as JFlow,
    UpsampleConformerEncoder as JEncoder)
from moss_speech_decoder_cosy_tpu.utils.config import tiny_flow_config
from moss_speech_decoder_cosy_torch.models.flow import (
    CausalConditionalDecoder as TEstimator,
    CausalMaskedDiffWithXvec as TFlow)
from moss_speech_decoder_cosy_torch.utils import config as tcfg
from moss_speech_decoder_cosy_torch.weights import flow_state_from_jax

ATOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def flow():
    cfg = tiny_flow_config()
    jm = JFlow(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32),
                              jnp.ones((1, 8), bool), jnp.zeros((1, 0, 16)),
                              jnp.zeros((1, 12)))
    state = flow_state_from_jax(jax.tree.map(np.asarray, params))
    tm = TFlow(tcfg.tiny_flow_config())
    tm.load_state_dict(state, strict=True)
    return cfg, jm, params, tm.eval(), state


def _estimator_inputs(cfg, b=2, t=24, seed=0):
    rng = np.random.RandomState(seed)
    d = cfg.estimator.out_channels
    return dict(x=rng.randn(b, t, d).astype(np.float32),
                valid=np.ones((b, t), bool),
                mu=rng.randn(b, t, d).astype(np.float32),
                t=np.array([0.4, 0.9][:b], np.float32),
                spks=rng.randn(b, d).astype(np.float32),
                cond=(rng.randn(b, t, d) * 0.3).astype(np.float32))


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("context", [False, True])
def test_encoder_matches_jax(flow, streaming, context):
    cfg, _, params, tm, _ = flow
    rng = np.random.RandomState(1)
    x = rng.randn(1, 10, cfg.input_size).astype(np.float32)
    valid = np.ones((1, 10), bool)
    ctx = (rng.randn(1, cfg.pre_lookahead_len, cfg.input_size)
           .astype(np.float32) if context else None)
    want, want_valid = jax.jit(
        JEncoder(cfg.encoder).apply, static_argnames="streaming")(
        {"params": params["params"]["encoder"]}, jnp.asarray(x),
        jnp.asarray(valid),
        context=None if ctx is None else jnp.asarray(ctx),
        streaming=streaming)
    with torch.no_grad():
        got, got_valid = tm.encoder(_t(x), _t(valid),
                                    context=None if ctx is None else _t(ctx),
                                    streaming=streaming)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("streaming", [False, True])
def test_estimator_matches_jax(flow, flash, streaming):
    """Flash off: the masked-bias path on both sides.  Flash on: the JAX
    Pallas kernel in interpret mode (T padded to 512) against the port's
    kernel wrapper (plain version on the CPU, T unpadded)."""
    cfg, _, params, _, state = flow
    ecfg = dataclasses.replace(cfg.estimator, use_flash_attention=flash)
    inp = _estimator_inputs(cfg)
    want = jax.jit(JEstimator(ecfg).apply, static_argnames="streaming")(
        {"params": params["params"]["decoder"]["estimator"]},
        *(jnp.asarray(inp[k]) for k in ("x", "valid", "mu", "t", "spks",
                                        "cond")), streaming=streaming)
    est = TEstimator(dataclasses.replace(
        tcfg.tiny_flow_config().estimator, use_flash_attention=flash))
    pre = "decoder.estimator."
    est.load_state_dict({k[len(pre):]: v for k, v in state.items()
                         if k.startswith(pre)}, strict=True)
    with torch.no_grad():
        got = est(*(_t(inp[k]) for k in ("x", "valid", "mu", "t", "spks",
                                          "cond")), streaming=streaming)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_noncausal_two_level_estimator_matches_jax():
    """The v1 form of the U-Net: non-causal GroupNorm blocks, two levels
    with a strided downsample and a transposed-conv upsample."""
    cfg = dataclasses.replace(tiny_flow_config().estimator, causal=False,
                              channels=(16, 16))
    inp = _estimator_inputs(tiny_flow_config())
    args = [jnp.asarray(inp[k]) for k in ("x", "valid", "mu", "t", "spks",
                                          "cond")]
    jm = JEstimator(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), *args)
    want = jax.jit(jm.apply)(params, *args)
    tree = {"params": {"decoder": {"estimator": params["params"]}}}
    state = flow_state_from_jax(jax.tree.map(np.asarray, tree))
    est = TEstimator(dataclasses.replace(tcfg.tiny_flow_config().estimator,
                                         causal=False, channels=(16, 16)))
    pre = "decoder.estimator."
    est.load_state_dict({k[len(pre):]: v for k, v in state.items()},
                        strict=True)
    with torch.no_grad():
        got = est(*(_t(inp[k]) for k in ("x", "valid", "mu", "t", "spks",
                                          "cond")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_flash_estimator_poisons_padded_rows(flow):
    """The kernel's key mask covers only the scalar length: a right-padded
    row makes the whole output NaN, as in the JAX package."""
    cfg, _, _, _, state = flow
    est = TEstimator(dataclasses.replace(
        tcfg.tiny_flow_config().estimator, use_flash_attention=True))
    pre = "decoder.estimator."
    est.load_state_dict({k[len(pre):]: v for k, v in state.items()
                         if k.startswith(pre)}, strict=True)
    inp = _estimator_inputs(cfg)
    inp["valid"][1, 20:] = False
    with torch.no_grad():
        out = est(*(_t(inp[k]) for k in ("x", "valid", "mu", "t", "spks",
                                          "cond")))
    assert torch.isnan(out).all()


@pytest.mark.parametrize("prompt", [False, True])
@pytest.mark.parametrize("streaming,finalize", [(False, True), (True, False),
                                                (True, True), (False, False)])
def test_flow_mel_matches_jax(flow, streaming, finalize, prompt):
    cfg, jm, params, tm, _ = flow
    rng = np.random.RandomState(2)
    n_prompt = 3 if prompt else 0
    tok = rng.randint(0, cfg.vocab_size, (1, n_prompt + 12)).astype(np.int32)
    valid = np.ones(tok.shape, bool)
    pf = (rng.randn(1, n_prompt * cfg.token_mel_ratio, cfg.output_size)
          * 0.3).astype(np.float32)
    emb = rng.randn(1, cfg.spk_embed_dim).astype(np.float32)
    want = jax.jit(jm.apply, static_argnames=("streaming", "finalize"))(
        params, jnp.asarray(tok), jnp.asarray(valid), jnp.asarray(pf),
        jnp.asarray(emb), streaming=streaming, finalize=finalize)
    with torch.no_grad():
        got = tm(_t(tok).long(), _t(valid), _t(pf), _t(emb),
                 streaming=streaming, finalize=finalize)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_cfm_noise_matches_numpy_randomstate():
    from moss_speech_decoder_cosy_tpu.models.flow.cfm import (
        _fixed_noise as j_noise, t_span_cosine as j_span)
    from moss_speech_decoder_cosy_torch.models.flow.cfm import (
        _fixed_noise as t_noise, t_span_cosine as t_span)
    np.testing.assert_array_equal(t_noise(64, 16), j_noise(64, 16))
    np.testing.assert_array_equal(t_span(10), j_span(10))
