"""The port's HiFT vocoder against the JAX package on ``tiny_hift_config()``,
f32 on the CPU.  The NSF source's random draws differ between torch and JAX,
so the port is fed JAX's own draws: ``PRNGKey(0)`` split as
models/hift/generator.py:89-107 splits it.  Tolerance 1e-4.

The 22.05 kHz source (``SourceModuleHnNSF``, the v1 vocoder's) fed JAX's
draws within 1e-5 (initial phases uniform in [-pi, pi)); the whole vocoder
at 22.05 kHz within 1e-4; and the v1 preset's published rates, held in one
explicit ``HiFTConfig`` for both packages at a narrow width, give 256
samples a mel frame."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator as JHiFT
from moss_speech_decoder_cosy_tpu.models.hift.generator import (
    linear_interpolate as j_interp)
from moss_speech_decoder_cosy_tpu.utils import config as jcfg
from moss_speech_decoder_cosy_tpu.utils.config import tiny_hift_config
from moss_speech_decoder_cosy_torch.models.hift import HiFTGenerator as THiFT
from moss_speech_decoder_cosy_torch.models.hift.generator import (
    linear_interpolate as t_interp)
from moss_speech_decoder_cosy_torch.utils import config as tcfg
from moss_speech_decoder_cosy_torch.weights import hift_state_from_jax

ATOL = 1e-4


def jax_draws(harmonics, length, device="cpu"):
    """The JAX source's draws for PRNGKey(0), as torch tensors."""
    k_ini, k_noise = jax.random.split(jax.random.PRNGKey(0))
    rand_ini = jax.random.uniform(k_ini, (1, harmonics), dtype=jnp.float32)
    noise = jax.random.normal(k_noise, (1, length, harmonics), jnp.float32)
    return (torch.from_numpy(np.array(rand_ini)).to(device),
            torch.from_numpy(np.array(noise)).to(device))


@pytest.fixture(scope="module")
def hift():
    cfg = tiny_hift_config()
    jm = JHiFT(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              jnp.zeros((1, 8, cfg.in_channels)))
    # a larger conv_post gain puts the iSTFT head at a working amplitude
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 200.0 if "conv_post" in str(path)
        and str(path[-1]) == "['g']" else a, params)
    tm = THiFT(tcfg.tiny_hift_config())
    tm.load_state_dict(hift_state_from_jax(jax.tree.map(np.asarray, params)),
                       strict=True)
    return cfg, jm, params, tm.eval()


def _mel(cfg, t, seed=0):
    return (np.random.RandomState(seed).randn(1, t, cfg.in_channels) * 2.0
            ).astype(np.float32)


@pytest.mark.parametrize("cached", [False, True])
def test_wav_and_source_match_jax(hift, cached):
    cfg, jm, params, tm = hift
    t = 12
    mel = _mel(cfg, t)
    n = 2 * cfg.total_upsample
    cache = (np.random.RandomState(5).randn(1, n, 1) * 0.1).astype(
        np.float32) if cached else None
    want_wav, want_src = jax.jit(jm.apply)(
        params, jnp.asarray(mel),
        None if cache is None else jnp.asarray(cache))
    draws = jax_draws(cfg.nb_harmonics + 1, t * cfg.total_upsample)
    with torch.no_grad():
        wav, src = tm(torch.from_numpy(mel),
                      None if cache is None else torch.from_numpy(cache),
                      draws=draws)
    assert float(np.abs(np.asarray(want_wav)).max()) > 0.05, "trivial wav"
    np.testing.assert_allclose(src.numpy(), np.asarray(want_src), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(wav.numpy(), np.asarray(want_wav), atol=ATOL,
                               rtol=0)


def test_source_module_voiced_and_unvoiced(hift):
    """SourceModuleHnNSF2 alone, on an f0 track crossing the voicing
    threshold (sines gated by uv, noise amplitude switching)."""
    from moss_speech_decoder_cosy_tpu.models.hift.generator import (
        SourceModuleHnNSF2 as JSource)
    cfg, _, params, tm = hift
    L = 6 * cfg.total_upsample
    f0 = np.repeat(np.array([0.0, 5.0, 120.0, 220.0, 9.0, 300.0],
                            np.float32), cfg.total_upsample)[None, :, None]
    want = JSource(cfg).apply({"params": params["params"]["m_source"]},
                              jnp.asarray(f0), jax.random.PRNGKey(0))
    with torch.no_grad():
        got = tm.m_source(torch.from_numpy(f0),
                          *jax_draws(cfg.nb_harmonics + 1, L))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("out_len", [3, 4, 24, 37])
def test_linear_interpolate_matches_jax(out_len):
    x = np.random.RandomState(0).randn(2, 12, 3).astype(np.float32)
    np.testing.assert_allclose(t_interp(torch.from_numpy(x), out_len).numpy(),
                               np.asarray(j_interp(jnp.asarray(x), out_len)),
                               atol=1e-6, rtol=0)


def test_default_draws_are_fixed_per_call(hift):
    """Without injected draws the source uses a generator seeded 0 on every
    call: repeated calls agree, and a cache overwrites the source prefix."""
    cfg, _, _, tm = hift
    mel = torch.from_numpy(_mel(cfg, 10, seed=3))
    with torch.no_grad():
        w1, s1 = tm(mel)
        w2, s2 = tm(mel)
        cache = torch.full((1, cfg.total_upsample, 1), 0.5)
        _, s3 = tm(mel, cache)
    assert w1.shape == (1, 10 * cfg.total_upsample)
    assert torch.equal(w1, w2) and torch.equal(s1, s2)
    assert torch.all(w1.abs() <= cfg.audio_limit)
    assert torch.equal(s3[:, :cache.shape[1]], cache)
    assert torch.equal(s3[:, cache.shape[1]:], s1[:, cache.shape[1]:])


def jax_phase_draws(harmonics, length, device="cpu"):
    """The JAX 22.05 kHz source's draws for PRNGKey(0): initial phases
    uniform in [-pi, pi) and the noise."""
    k_ini, k_noise = jax.random.split(jax.random.PRNGKey(0))
    phase = jax.random.uniform(k_ini, (1, 1, harmonics), jnp.float32,
                               minval=-np.pi, maxval=np.pi)
    noise = jax.random.normal(k_noise, (1, length, harmonics), jnp.float32)
    return (torch.from_numpy(np.array(phase)).reshape(1, harmonics).to(
        device), torch.from_numpy(np.array(noise)).to(device))


def _pair(fields, seed=1):
    """(JAX cfg, JAX module, params, port module) for one set of HiFTConfig
    fields, held in both packages' config classes."""
    jc, tc = jcfg.HiFTConfig(**fields), tcfg.HiFTConfig(**fields)
    jm = JHiFT(jc)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8, jc.in_channels)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 200.0 if "conv_post" in str(path)
        and str(path[-1]) == "['g']" else a, params)
    tm = THiFT(tc)
    tm.load_state_dict(hift_state_from_jax(jax.tree.map(np.asarray, params)),
                       strict=True)
    return jc, jm, params, tm.eval()


def test_source_22k_matches_jax_draws():
    """SourceModuleHnNSF alone over 2,000 samples of an f0 track crossing
    the voicing threshold: the phase integrated at the audio rate."""
    from moss_speech_decoder_cosy_tpu.models.hift.generator import (
        SourceModuleHnNSF as JSource)
    fields = dataclasses.asdict(tiny_hift_config())
    fields["sampling_rate"] = 22050
    cfg, _, params, tm = _pair(fields)
    from moss_speech_decoder_cosy_torch.models.hift.generator import (
        SourceModuleHnNSF as TSource)
    assert isinstance(tm.m_source, TSource)
    L = 2000
    f0 = np.repeat(np.array([0.0, 5.0, 120.0, 220.0, 9.0, 300.0, 180.0,
                             410.0], np.float32), L // 8)[None, :, None]
    want = JSource(cfg).apply({"params": params["params"]["m_source"]},
                              jnp.asarray(f0), jax.random.PRNGKey(0))
    with torch.no_grad():
        got = tm.m_source(torch.from_numpy(f0),
                          *jax_phase_draws(cfg.nb_harmonics + 1, L))
    assert float(np.abs(np.asarray(want)).max()) > 0.01
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("cached", [False, True])
def test_wav_22k_matches_jax(cached):
    fields = dataclasses.asdict(tiny_hift_config())
    fields["sampling_rate"] = 22050
    cfg, jm, params, tm = _pair(fields)
    t = 12
    mel = _mel(cfg, t, seed=2)
    n = 2 * cfg.total_upsample
    cache = (np.random.RandomState(6).randn(1, n, 1) * 0.1).astype(
        np.float32) if cached else None
    want_wav, want_src = jax.jit(jm.apply)(
        params, jnp.asarray(mel),
        None if cache is None else jnp.asarray(cache))
    with torch.no_grad():
        wav, src = tm(torch.from_numpy(mel),
                      None if cache is None else torch.from_numpy(cache),
                      draws=jax_phase_draws(cfg.nb_harmonics + 1,
                                            t * cfg.total_upsample))
    assert float(np.abs(np.asarray(want_wav)).max()) > 0.05, "trivial wav"
    np.testing.assert_allclose(src.numpy(), np.asarray(want_src), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(wav.numpy(), np.asarray(want_wav), atol=ATOL,
                               rtol=0)


def test_v1_rates_give_256_samples_a_frame():
    """``cosyvoice1_hift_config()``'s rates (8, 8), kernels (16, 16) and
    source resblocks (7, 11), at a narrow width, as one explicit config for
    both packages: 256 samples a mel frame, the wavs within 1e-4."""
    fields = dataclasses.asdict(tcfg.cosyvoice1_hift_config())
    fields.update(base_channels=32, f0_cond_channels=24, in_channels=16)
    cfg, jm, params, tm = _pair(fields, seed=3)
    assert cfg.total_upsample == 256
    t = 9
    mel = _mel(cfg, t, seed=4)
    want, _ = jax.jit(jm.apply)(params, jnp.asarray(mel))
    with torch.no_grad():
        wav, _ = tm(torch.from_numpy(mel),
                    draws=jax_phase_draws(cfg.nb_harmonics + 1, t * 256))
    assert wav.shape == np.asarray(want).shape == (1, 256 * t)
    np.testing.assert_allclose(wav.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_default_phase_draws():
    """The 22.05 kHz source's default draws: phases in [-pi, pi), fixed per
    call; the fundamental's phase is zeroed by the source."""
    from moss_speech_decoder_cosy_torch.models.hift.generator import (
        seeded_phase_draws)
    fields = dataclasses.asdict(tiny_hift_config())
    fields["sampling_rate"] = 22050
    _, _, _, tm = _pair(fields)
    assert tm.draws is seeded_phase_draws
    phase, noise = tm.draws(5, 300, torch.device("cpu"))
    again, _ = tm.draws(5, 300, torch.device("cpu"))
    assert torch.equal(phase, again) and noise.shape == (1, 300, 5)
    assert bool((phase >= -np.pi).all()) and bool((phase < np.pi).all())
    f0 = torch.full((1, 300, 1), 200.0)
    moved = phase.clone()
    moved[:, 0] += 1.0
    with torch.no_grad():
        assert torch.equal(tm.m_source(f0, phase, noise),
                           tm.m_source(f0, moved, noise))
