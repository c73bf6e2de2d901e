"""The port's DiT and v-diffusion flow variants (``models/flow/dit.py``,
``models/flow/vdiff.py``) against the JAX package, f32 on the CPU, at
``tiny_dit_config()`` (head dim 64, so 32 rotary channels) and the tiny v1
encoder of ``test_torch_flow_v1``; the weights go from flax params through
``weights.dit_state_from_jax`` / ``gradtts_state_from_jax``:

- ``DiTEstimator`` with a padded row (the -1e10 key mask) within 2e-5;
- ``DiTConditionalCFM`` (fixed noise, CFG batch of 2) within 2e-5;
- ``VDiffusion``'s sampler: eta 0 without CFG, eta 0.5 with JAX's own
  per-step noise draws, and with CFG rate 0.7, within 2e-5;
- ``GradTTSDiffWithXvec.inference`` with a prompt within 2e-5;
- the rotary helper against JAX's ``_rope_partial``.

Torch runs on one thread here, as in the other port test modules."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.flow import dit as JD
from moss_speech_decoder_cosy_tpu.models.flow import vdiff as JV
from moss_speech_decoder_cosy_tpu.utils import config as JC
from moss_speech_decoder_cosy_torch.models.flow import dit as TD
from moss_speech_decoder_cosy_torch.models.flow import vdiff as TV
from moss_speech_decoder_cosy_torch.utils import config as TC
from moss_speech_decoder_cosy_torch.weights import (
    dit_state_from_jax, gradtts_state_from_jax)

from test_torch_flow_v1 import N_MEL, SPK, tiny_v1_config

ATOL = 2e-5
T = 23


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b=2):
    rng = np.random.RandomState(seed)
    d = JD.tiny_dit_config().io_channels
    valid = np.ones((b, T), bool)
    valid[-1, T - 5:] = False
    return dict(x=rng.randn(b, T, d).astype(np.float32), valid=valid,
                mu=rng.randn(b, T, d).astype(np.float32),
                t=np.linspace(0.2, 0.9, b).astype(np.float32),
                spks=rng.randn(b, JD.tiny_dit_config().spk_embed_dim
                               ).astype(np.float32),
                cond=rng.randn(b, T, d).astype(np.float32))


def _nonzero(params):
    """The zero-initialised pre / post convs drawn, so they carry weight."""
    rng = np.random.RandomState(1)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.randn(*a.shape) * 0.05).astype(np.float32)
        if ("preprocess" in str(p) or "postprocess" in str(p)) else a,
        params)


@pytest.fixture(scope="module")
def dit():
    cfg = JD.tiny_dit_config()
    inp = _inputs(0)
    keys = ("x", "valid", "mu", "t", "spks", "cond")
    jm = JD.DiTEstimator(cfg)
    params = _nonzero(_np(jax.jit(jm.init)(
        jax.random.PRNGKey(0), *(jnp.asarray(inp[k]) for k in keys))))
    tm = TD.DiTEstimator(TD.tiny_dit_config())
    tm.load_state_dict(dit_state_from_jax(params), strict=True)
    return cfg, jm, params, tm.eval()


def test_rope_partial_matches_jax():
    x = np.random.RandomState(2).randn(2, 3, 7, 64).astype(np.float32)
    np.testing.assert_allclose(
        TD.rope_partial(_t(x), 1e4).numpy(),
        np.asarray(JD._rope_partial(jnp.asarray(x), 1e4)), atol=1e-6,
        rtol=0)


def test_estimator_matches_jax(dit):
    _, jm, params, tm = dit
    inp = _inputs(3)
    keys = ("x", "valid", "mu", "t", "spks", "cond")
    want = jax.jit(jm.apply)(params, *(jnp.asarray(inp[k]) for k in keys))
    with torch.no_grad():
        got = tm(*(_t(inp[k]) for k in keys))
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_dit_cfm_matches_jax(dit):
    cfg, _, params, _ = dit
    cfm_j = JC.CFMConfig(n_timesteps=4, max_noise_len=256)
    jm = JD.DiTConditionalCFM(cfm_j, cfg)
    inp = _inputs(4, b=1)
    args = [jnp.asarray(inp[k]) for k in ("mu", "valid", "spks", "cond")]
    want = jax.jit(jm.apply)({"params": {"estimator": params["params"]}},
                             *args)
    tm = TD.DiTConditionalCFM(TC.CFMConfig(n_timesteps=4, max_noise_len=256),
                              TD.tiny_dit_config())
    tm.load_state_dict({"estimator." + k: v for k, v in
                        dit_state_from_jax(params).items()}, strict=True)
    with torch.no_grad():
        got = tm.eval()(*(_t(inp[k]) for k in ("mu", "valid", "spks",
                                                "cond")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("eta,cfg_rate", [(0.0, 0.0), (0.5, 0.0),
                                          (0.0, 0.7)])
def test_vdiffusion_sampler_matches_jax(dit, eta, cfg_rate):
    """eta 0.5: the port adds JAX's own per-step draws (its ``rng`` split
    into one key a step, as the JAX sampler splits it)."""
    cfg, _, params, _ = dit
    inp = _inputs(5, b=1)
    n = 5
    jm = JV.VDiffusion(cfg, inference_cfg_rate=cfg_rate)
    rng = jax.random.PRNGKey(6) if eta else None
    want = jax.jit(lambda p, *a: jm.apply(p, *a, n_timesteps=n, eta=eta,
                                          rng=rng))(
        {"params": {"estimator": params["params"]}},
        *(jnp.asarray(inp[k]) for k in ("mu", "valid", "spks", "cond")))
    noise = None
    if eta:
        noise = torch.stack([_t(jax.random.normal(k, inp["mu"].shape,
                                                  jnp.float32))
                             for k in jax.random.split(rng, n)])
    tm = TV.VDiffusion(TD.tiny_dit_config(), inference_cfg_rate=cfg_rate)
    tm.load_state_dict({"estimator." + k: v for k, v in
                        dit_state_from_jax(params).items()}, strict=True)
    with torch.no_grad():
        got = tm.eval()(*(_t(inp[k]) for k in ("mu", "valid", "spks",
                                                "cond")),
                        n_timesteps=n, eta=eta, noise=noise)
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_gradtts_inference_matches_jax():
    fj = tiny_v1_config(JC)
    dj = dataclasses.replace(JD.tiny_dit_config(), io_channels=N_MEL,
                             spk_embed_dim=N_MEL)
    jm = JV.GradTTSDiffWithXvec(fj, dj)
    rng = np.random.RandomState(7)
    n_tok = 24
    tok = rng.randint(0, 64, (1, n_tok))
    valid = np.ones((1, n_tok), bool)
    mel_len = jm.mel_len(n_tok)
    pf = (rng.randn(1, 7, N_MEL) * 0.5).astype(np.float32)
    emb = rng.randn(1, SPK).astype(np.float32)
    params = _nonzero(_np(jax.jit(
        lambda k: jm.init(k, jnp.asarray(tok), jnp.asarray(valid),
                          jnp.asarray(pf), jnp.asarray(emb), mel_len, 3,
                          method=jm.inference))(jax.random.PRNGKey(8))))
    want = jax.jit(lambda p, *a: jm.apply(p, *a, mel_len, 3,
                                          method=jm.inference))(
        params, jnp.asarray(tok), jnp.asarray(valid), jnp.asarray(pf),
        jnp.asarray(emb))
    tm = TV.GradTTSDiffWithXvec(
        tiny_v1_config(TC), dataclasses.replace(
            TD.tiny_dit_config(), io_channels=N_MEL, spk_embed_dim=N_MEL))
    tm.load_state_dict(gradtts_state_from_jax(params), strict=True)
    assert tm.mel_len(n_tok) == mel_len
    with torch.no_grad():
        got = tm.eval().inference(_t(tok), _t(valid), _t(pf), _t(emb),
                                  mel_len, n_timesteps=3)
    assert got.shape == (1, mel_len - 7, N_MEL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
