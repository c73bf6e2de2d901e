"""Lane-sharded multi-stream KV decoding (``AudioDecoder.spmd_decoder``,
``pipeline/spmd_session.py``) against the JAX package's ``SPMDKVDecoder``,
f32 on the CPU, tiny configs, the same weights (seeded, and converted to
JAX's tree by inverting ``flow_state_from_jax`` / ``hift_state_from_jax``)
and NSF draws.  Mirrors ``tests/test_spmd_session.py``.

- two CPU replicas against JAX's decoder on a 2-device CPU mesh: batch 4,
  and batch 4 behind a shared 3-token prompt, 13 tokens: within 1e-5
  (atol and rtol);
- one replica equal to ``kv_stream_decoder(batch=4)``, sample for sample;
  two replicas against it within 1e-5 (each replica runs 2 of the 4
  streams: other row counts reorder no sum across streams, but the
  products' blocking may change last bits);
- ``output="int16"`` within 1 LSB of the lockstep session's;
- ``program_flops`` positive, stable, the sum of the replicas';
- every tensor of a replica on its device (JAX's test reads the flow
  program's HLO for collectives; the port has no program to read).

Torch runs on one thread."""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from moss_speech_decoder_cosy_tpu.models.flow import CausalMaskedDiffWithXvec
from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator
from moss_speech_decoder_cosy_tpu.pipeline import AudioDecoder as JDecoder
from moss_speech_decoder_cosy_tpu.utils import config as JC
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder as TDecoder
from moss_speech_decoder_cosy_torch.utils import config as TC
from moss_speech_decoder_cosy_torch.weights import (
    flow_state_from_jax, hift_state_from_jax, seeded_states)

from test_torch_kv_lockstep import jax_draws

N, HOP, CAP = 13, 2, 128


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(C):
    cfg = dataclasses.replace(C.tiny_flow_config(), cfm=C.CFMConfig(
        n_timesteps=3, max_noise_len=2048))
    pipe = C.PipelineConfig(block_size=HOP, mel_cache_len=2, max_token_len=9)
    return cfg, C.tiny_hift_config(), pipe


def jax_params(shapes, to_port, state):
    """The JAX param tree of ``shapes`` (``jax.eval_shape`` of an init)
    whose ``to_port`` conversion is ``state``: every leaf numbered, the
    numbers converted, each port value written back at its number (no
    JAX init is compiled)."""
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    idx, off = [], 0
    for leaf in leaves:
        n = int(np.prod(leaf.shape))
        idx.append(np.arange(off, off + n, dtype=np.float64).reshape(
            leaf.shape))
        off += n
    assert off < 2 ** 24                        # exact in float32
    flat = np.full(off, np.nan, np.float32)
    for k, num in to_port(jax.tree_util.tree_unflatten(tree, idx)).items():
        flat[num.numpy().astype(np.int64).ravel()] = state[k].numpy().ravel()
    assert not np.isnan(flat).any()
    return jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(flat[a.astype(np.int64)]) for a in idx])


@pytest.fixture(scope="module")
def decs():
    """The port's decoder from seeded weights and JAX's from the same
    weights."""
    tcfg, thcfg, tpipe = _configs(TC)
    flow_state, hift_state = seeded_states(tcfg, thcfg)
    tdec = TDecoder(tcfg, thcfg, flow_state, hift_state, tpipe,
                    device="cpu", nsf_draws=jax_draws)
    cfg, hcfg, pipe = _configs(JC)
    flow, hift = CausalMaskedDiffWithXvec(cfg), HiFTGenerator(hcfg)
    shapes = jax.eval_shape(
        flow.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), jnp.zeros((1, 0, cfg.output_size)),
        jnp.zeros((1, cfg.spk_embed_dim)))
    hshapes = jax.eval_shape(hift.init, jax.random.PRNGKey(1),
                             jnp.zeros((1, 8, cfg.output_size)))
    jdec = JDecoder(cfg, hcfg,
                    jax_params(shapes, flow_state_from_jax, flow_state),
                    jax_params(hshapes, hift_state_from_jax, hift_state),
                    pipe)
    return jdec, tdec


@pytest.fixture(scope="module")
def jax_decodes(decs):
    """JAX's SPMD decodes on a 2-device mesh, {n_prompt: wav}, compiled in
    threads."""
    jdec, _ = decs
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def run(n_prompt):
        ptok, pfeat, emb, toks = _inputs(jdec.flow_cfg, 4, n_prompt)
        return jdec.spmd_decoder(mesh, ptok, pfeat, emb, block_size=HOP,
                                 token_cap=CAP, batch=4).decode(toks)

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        return dict(zip((0, 3), ex.map(run, (0, 3))))


def _inputs(dec_cfg, batch, n_prompt, seed=11):
    rng = np.random.RandomState(seed)
    r = dec_cfg.token_mel_ratio
    ptok = rng.randint(0, dec_cfg.vocab_size, (1, n_prompt)).astype(np.int32)
    pfeat = rng.randn(1, n_prompt * r, dec_cfg.output_size).astype(
        np.float32)
    emb = rng.randn(1, dec_cfg.spk_embed_dim).astype(np.float32)
    toks = rng.randint(0, dec_cfg.vocab_size, (batch, N)).astype(np.int32)
    return ptok, pfeat, emb, toks


@pytest.mark.parametrize("n_prompt", [0, 3])
def test_spmd_decode_matches_jax(decs, jax_decodes, n_prompt):
    _, tdec = decs
    ptok, pfeat, emb, toks = _inputs(tdec.flow_cfg, 4, n_prompt)
    want = jax_decodes[n_prompt]
    spmd = tdec.spmd_decoder(["cpu", "cpu"], ptok, pfeat, emb,
                             block_size=HOP, token_cap=CAP, batch=4)
    got = spmd.decode(toks)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_spmd_equals_the_lockstep_session(decs):
    _, tdec = decs
    ptok, pfeat, emb, toks = _inputs(tdec.flow_cfg, 4, 3, seed=5)
    want = tdec.kv_stream_decoder(ptok, pfeat, emb, block_size=HOP,
                                  token_cap=CAP, batch=4).stream_decode(toks)
    one = tdec.spmd_decoder(["cpu"], ptok, pfeat, emb, block_size=HOP,
                            token_cap=CAP, batch=4)
    np.testing.assert_array_equal(one.decode(toks), want)
    two = tdec.spmd_decoder(["cpu", "cpu"], ptok, pfeat, emb,
                            block_size=HOP, token_cap=CAP, batch=4)
    assert [r.b for r in two.replicas] == [2, 2]
    np.testing.assert_allclose(two.decode(toks), want, atol=1e-5, rtol=0)


def test_spmd_int16_output(decs):
    _, tdec = decs
    toks = np.random.RandomState(3).randint(
        0, tdec.flow_cfg.vocab_size, (4, N)).astype(np.int32)
    spmd = tdec.spmd_decoder(["cpu", "cpu"], batch=4, block_size=HOP,
                             token_cap=CAP)
    pcm = spmd.decode(toks, output="int16")
    ref = tdec.kv_stream_decoder(block_size=HOP, token_cap=CAP,
                                 batch=4).stream_decode(toks, output="int16")
    assert pcm.dtype == np.int16 and pcm.shape == ref.shape
    np.testing.assert_allclose(pcm.astype(np.int32), ref.astype(np.int32),
                               atol=1)


def test_spmd_program_flops(decs):
    _, tdec = decs
    spmd = tdec.spmd_decoder(["cpu", "cpu"], batch=4, block_size=HOP,
                             token_cap=CAP)
    f1 = spmd.program_flops(N)
    assert f1 > 0 and spmd.program_flops(N) == f1
    assert f1 == sum(r.program_flops(N) for r in spmd.replicas)


def test_spmd_replicas_stay_on_their_device_and_raise(decs):
    _, tdec = decs
    spmd = tdec.spmd_decoder(["cpu", "cpu"], batch=4, block_size=HOP,
                             token_cap=CAP)
    spmd.decode(np.zeros((4, N), np.int32))
    assert spmd.replica_devices() == [{"cpu"}, {"cpu"}]
    assert all(r.dec is tdec for r in spmd.replicas)
    with pytest.raises(ValueError, match="split"):
        tdec.spmd_decoder(["cpu", "cpu"], batch=3)
    with pytest.raises(AssertionError, match="steady"):
        spmd.decode(np.zeros((4, 3), np.int32))
