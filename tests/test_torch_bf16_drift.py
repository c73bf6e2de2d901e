"""The port's bf16 deviation held against the JAX package's (ROADMAP C2).

Both packages decode the same tokens offline (``_flow_mel``, no prompt,
``streaming=False, finalize=True``) with the same seeded weights
(``PRNGKey(0)`` / ``PRNGKey(1)``, carried over by ``flow_state_from_jax``),
in f32 and in bf16.  Each package's bf16 mel is measured against its own
f32 mel as a relative MAE, and the port's may be at most 1.2x the JAX
package's.  The port used to compute the estimator's sinusoidal time
embedding in f32 where the JAX package rounds it in bf16; that alone moved
its bf16 mel 1.6x as far (3.76% against 2.31% over these seeds).

Run as a script to print the table:
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bf16_drift.py``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.flow import (
    CausalMaskedDiffWithXvec as JFlow)
from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator as JHiFT
from moss_speech_decoder_cosy_tpu.ops import embeddings as j_emb
from moss_speech_decoder_cosy_tpu.pipeline import AudioDecoder as JDecoder
from moss_speech_decoder_cosy_tpu.utils.config import (
    PipelineConfig, tiny_flow_config, tiny_hift_config)
from moss_speech_decoder_cosy_torch.ops import embeddings as t_emb
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder as TDecoder
from moss_speech_decoder_cosy_torch.utils import config as tcfg
from moss_speech_decoder_cosy_torch.weights import (
    flow_state_from_jax, hift_state_from_jax)

SEEDS = (1, 2, 3)
N_TOKENS = 40
# the port's bf16 drift may be at most this multiple of the reference's
RATIO_LIMIT = 1.2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU decodes run ~20x slower on torch's default thread pool when
    the suite's workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mels():
    """{(package, recipe, seed): mel} for both packages, f32 and bf16."""
    fcfg, hcfg = tiny_flow_config(), tiny_hift_config()
    fp = jax.jit(JFlow(fcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), jnp.zeros((1, 0, fcfg.output_size)),
        jnp.zeros((1, fcfg.spk_embed_dim)))
    hp = jax.jit(JHiFT(hcfg).init)(jax.random.PRNGKey(1),
                                   jnp.zeros((1, 8, hcfg.in_channels)))
    fs = flow_state_from_jax(jax.tree.map(np.asarray, fp))
    hs = hift_state_from_jax(jax.tree.map(np.asarray, hp))
    none = (np.zeros((1, 0), np.int32), np.zeros((1, 0, 16), np.float32),
            np.zeros((1, 12), np.float32))
    out = {}
    for recipe, jdt, tdt in (("f32", None, None),
                             ("bf16", jnp.bfloat16, torch.bfloat16)):
        jdec = JDecoder(fcfg, hcfg, fp, hp,
                        PipelineConfig(block_size=4, mel_cache_len=4,
                                       max_token_len=16),
                        compute_dtype=jdt)
        tdec = TDecoder(tcfg.tiny_flow_config(), tcfg.tiny_hift_config(),
                        fs, hs, tcfg.PipelineConfig(block_size=4,
                                                    mel_cache_len=4,
                                                    max_token_len=16),
                        device="cpu", compute_dtype=tdt)
        for seed in SEEDS:
            tok = np.random.RandomState(seed).randint(
                0, 64, (1, N_TOKENS)).astype(np.int32)
            for pkg, dec in (("jax", jdec), ("port", tdec)):
                out[pkg, recipe, seed] = np.asarray(dec._flow_mel(
                    tok, *none, streaming=False, finalize=True), np.float32)
    return out


@pytest.fixture(scope="module")
def mels():
    return _mels()


def _rel_mae(got, want):
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def drift(mels, pkg, seed):
    """The package's bf16 mel against its own f32 mel, relative MAE."""
    return _rel_mae(mels[pkg, "bf16", seed], mels[pkg, "f32", seed])


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_mel_drift_within_the_reference(mels, seed):
    port, ref = drift(mels, "port", seed), drift(mels, "jax", seed)
    assert 0 < port <= RATIO_LIMIT * ref, (port, ref)
    # the f32 mels agree, so the two drifts measure the same thing
    np.testing.assert_allclose(mels["port", "f32", seed],
                               mels["jax", "f32", seed], atol=2e-4, rtol=0)


def test_bf16_mels_agree_with_the_reference(mels):
    """With the rounding points matched, the two packages' bf16 mels lie
    closer to each other than either lies to its f32 mel."""
    for seed in SEEDS:
        across = _rel_mae(mels["port", "bf16", seed],
                          mels["jax", "bf16", seed])
        assert across < drift(mels, "jax", seed), (seed, across)


@pytest.mark.parametrize("t", [0.0, 0.1, 0.3, 0.9])
def test_time_embedding_rounds_in_bf16_like_the_reference(t):
    """The sinusoidal time embedding in bf16: the same bf16 values as the
    JAX package's (argument and sin / cos rounded in bf16)."""
    tt = np.full((2,), t, np.float32)
    got = t_emb.SinusoidalPosEmb(20)(torch.from_numpy(tt).bfloat16())
    want = j_emb.SinusoidalPosEmb(20).apply(
        {}, jnp.asarray(tt).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=8e-3,
                               rtol=0)


if __name__ == "__main__":
    torch.set_num_threads(1)
    m = _mels()
    for seed in SEEDS:
        j, p = drift(m, "jax", seed), drift(m, "port", seed)
        print(f"seed {seed}: bf16 mel rel MAE vs own f32: JAX {j:.4%}, "
              f"port {p:.4%}, ratio {p / j:.3f}; port vs JAX bf16 "
              f"{_rel_mae(m['port', 'bf16', seed], m['jax', 'bf16', seed]):.4%}")
