"""The port's ``KVStreamDecoder.stream_decode`` against the JAX package's,
f32 on the CPU, tiny configs, same weights, with a 2-token prompt, hop 3 and
ring 6, so the shared write offset is not hop-aligned (align 8 of a 12-frame
chunk) as in tests/test_kv_stream.py:223-233.  The port's NSF source gets
the JAX draws.

On the CPU the session runs its device-scalar steps eagerly (no CUDA
graphs), on its persistent buffers.

Tolerances on the waveform:
- 1e-4: the port's default wavefront (kernel engine, plain version on the
  CPU) against the JAX default wavefront (its fused XLA engine) and against
  the JAX session's stepped wavefront (``wave_stepped=True``: one jitted
  iteration with device scalars, the loop the port mirrors), and the
  port's ``enc_kernel=True`` wavefront against the JAX session with both
  Pallas kernels (interpret mode);
- 2e-5: the port's kernel engine against its own unfused engine, and its
  kernel encoder hop against its per-layer encoder step (the tolerance the
  JAX package pins between its kernel and unfused engines);
- 1e-5: bulk vocoding against the per-hop vocoder chain;
- 0 (identical): one session decoding the same stream twice (its
  persistent buffers are reset in full), and the session's per-hop step at
  its device n_tok against ``kv_flow_step`` with a host-int cache;
- the concat dataflow (``fused=False``), the one-hot write
  (``write_mode="onehot"``) and a ring that is not a multiple of the hop:
  1e-4 against the JAX session with the same option, 1e-5 against the
  port's default (fused, shared-offset) session;
- the segmented wavefront (``segmented=True``) and ``stream_chunks``:
  equal to the unsegmented stream (1e-6 on a promptless session, whose
  reference is the JAX session), and the 16-bit PCM output
  (``output="int16"``) equal to ``_pcm16`` of the f32 stream and, segmented,
  to the unsegmented int16 stream.

Torch runs on one thread here: tiny CPU decodes run ~20x slower on its
default thread pool when the suite's workers load every core."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.flow import CausalMaskedDiffWithXvec
from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator
from moss_speech_decoder_cosy_tpu.pipeline import AudioDecoder as JDecoder
from moss_speech_decoder_cosy_tpu.utils.config import (
    PipelineConfig, tiny_flow_config, tiny_hift_config)
from moss_speech_decoder_cosy_torch.ops import fused_block as fb
from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder as TDecoder
from moss_speech_decoder_cosy_torch.pipeline.kv_session import _pcm16
from moss_speech_decoder_cosy_torch.utils import config as tcfg
from moss_speech_decoder_cosy_torch.weights import (
    flow_state_from_jax, hift_state_from_jax)

P, N, HOP, RING = 2, 34, 3, 6


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


@pytest.fixture(scope="module")
def setup():
    cfg, hcfg = tiny_flow_config(), tiny_hift_config()
    rng = np.random.RandomState(0)
    r = cfg.token_mel_ratio
    tokens = rng.randint(0, cfg.vocab_size, (1, P + N)).astype(np.int32)
    prompt_feat = rng.randn(1, P * r, cfg.output_size).astype(np.float32)
    emb = rng.randn(1, cfg.spk_embed_dim).astype(np.float32)
    fp = jax.jit(CausalMaskedDiffWithXvec(cfg).init)(
        jax.random.PRNGKey(1), jnp.asarray(tokens),
        jnp.ones(tokens.shape, bool), jnp.asarray(prompt_feat),
        jnp.asarray(emb))
    hp = jax.jit(HiFTGenerator(hcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 8, hcfg.in_channels)))
    # a louder vocoder head, so the waveform tolerances bite
    hp = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 200.0 if "conv_post" in str(path)
        and str(path[-1]) == "['g']" else a, hp)
    jdec = JDecoder(cfg, hcfg, fp, hp, PipelineConfig(
        block_size=HOP, mel_cache_len=2, max_token_len=9))
    jkv = jdec.kv_stream_decoder(tokens[:, :P], prompt_feat, emb,
                                 block_size=HOP, ring_tokens=RING,
                                 token_cap=64)
    want = np.asarray(jkv.stream_decode(tokens[:, P:], bulk_voc=True,
                                        wavefront=True))
    tdec = TDecoder(
        tcfg.tiny_flow_config(), tcfg.tiny_hift_config(),
        flow_state_from_jax(jax.tree.map(np.asarray, fp)),
        hift_state_from_jax(jax.tree.map(np.asarray, hp)),
        tcfg.PipelineConfig(block_size=HOP, mel_cache_len=2,
                            max_token_len=9),
        device="cpu", nsf_draws=jax_draws)

    def session(**kw):
        kw = dict(dict(block_size=HOP, ring_tokens=RING, token_cap=64), **kw)
        return tdec.kv_stream_decoder(tokens[:, :P], prompt_feat, emb, **kw)

    wavs = {}

    def decode(kernel="auto", bulk_voc=True, wavefront=True,
               enc_kernel=False):
        """The port's stream_decode of the stream, once per setting; on the
        CPU every engine leaves the kernels' launch counts alone."""
        key = (kernel, bulk_voc, wavefront, enc_kernel)
        if key not in wavs:
            before = (fb.launch_fused_tf_group.launches,
                      fc.launch_fused_conformer_group.launches)
            wavs[key] = session(kernel=kernel,
                                enc_kernel=enc_kernel).stream_decode(
                tokens[:, P:], bulk_voc=bulk_voc, wavefront=wavefront)
            assert (fb.launch_fused_tf_group.launches,
                    fc.launch_fused_conformer_group.launches) == before
        return wavs[key]

    def want_enc_kernel():
        """The JAX session with both Pallas kernels (interpret mode), as
        tests/test_kv_stream.py:307-315 builds it."""
        if "jax_enc" not in wavs:
            jkve = jdec.kv_stream_decoder(
                tokens[:, :P], prompt_feat, emb, block_size=HOP,
                ring_tokens=RING, token_cap=64, fused=True, kernel=True,
                enc_kernel=True)
            assert jkve._enc_kernel and jkve._kernel
            wavs["jax_enc"] = np.asarray(jkve.stream_decode(
                tokens[:, P:], bulk_voc=True, wavefront=True,
                wave_stepped=False))
        return wavs["jax_enc"]

    def want_option(**kw):
        """The JAX session's default decode with the option ``kw``."""
        key = ("jax",) + tuple(sorted(kw.items()))
        if key not in wavs:
            kw = dict(dict(block_size=HOP, ring_tokens=RING, token_cap=64),
                      **kw)
            wavs[key] = np.asarray(jdec.kv_stream_decoder(
                tokens[:, :P], prompt_feat, emb, **kw).stream_decode(
                    tokens[:, P:]))
        return wavs[key]

    def want_stepped():
        """The JAX session's stepped wavefront (one jitted iteration per
        step, device scalars), on the same session as ``want``."""
        if "jax_stepped" not in wavs:
            wavs["jax_stepped"] = np.asarray(jkv.stream_decode(
                tokens[:, P:], bulk_voc=True, wavefront=True,
                wave_stepped=True))
        return wavs["jax_stepped"]

    return dict(want=want, session=session, decode=decode,
                want_enc_kernel=want_enc_kernel, want_stepped=want_stepped,
                want_option=want_option, dec=tdec, tokens=tokens,
                jdec=jdec)


def test_wavefront_matches_jax_wavefront(setup):
    kv = setup["session"]()
    assert kv._kernel and kv._fused and kv._align == 8
    got = setup["decode"]()
    want = setup["want"]
    assert got.shape == want.shape == (
        1, N * 4 * tiny_hift_config().total_upsample) and \
        got.dtype == np.float32
    assert np.abs(want).max() > 0.05, "trivial waveform"
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_wavefront_matches_jax_stepped_wavefront(setup):
    """The port's wavefront (its device-scalar iteration, run eagerly on the
    CPU) against the JAX session's donated-buffer stepped loop."""
    got, want = setup["decode"](), setup["want_stepped"]()
    assert got.shape == want.shape and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kw", [dict(), dict(kernel=False),
                                dict(enc_kernel=True)],
                         ids=["kernel", "unfused", "enc_kernel"])
def test_decoding_twice_gives_identical_wavs(setup, kw):
    """One session, the same stream twice: ``init_state`` and
    ``stream_decode`` reset every persistent buffer (caches, rings, waves,
    positions), so nothing of the first stream reaches the second."""
    kv = setup["session"](**kw)
    stream = setup["tokens"][:, P:]
    first = kv.stream_decode(stream)
    rings = kv._ext["kv"][0]
    second = kv.stream_decode(stream)
    assert kv._ext["kv"][0] is rings            # the same buffers, reused
    np.testing.assert_array_equal(second, first)
    np.testing.assert_allclose(first, setup["decode"](**kw), atol=0, rtol=0)


def test_hop_with_device_n_tok_equals_int_path(setup):
    """The session's per-hop step (device n_tok, persistent buffers) after
    the prompt prefill, over two steady hops and the finalize tail, against
    ``kv_flow_step`` on a fresh cache with host-int positions."""
    from moss_speech_decoder_cosy_torch.models.flow import kv_stream as T
    kv = setup["session"]()
    stream = setup["tokens"][:, P:P + 2 * HOP + kv.la + 1]
    buf = kv._token_buf(stream)
    cache, _ = kv.init_state()
    kv._prefill(buf, cache)
    plan = kv.schedule(stream.shape[1])
    assert [f for _, f in plan] == [False, False, True]
    got = [kv._hop(buf, cache, e, f)[0] for e, f in plan]
    assert torch.is_tensor(cache["n_tok"]) and int(cache["n_tok"]) == \
        P + stream.shape[1]

    flow = kv.dec.flow
    icache = T.init_kv_cache(flow.cfg, RING)
    ptok = torch.from_numpy(setup["tokens"][:, :P]).long()
    toks = torch.from_numpy(stream).long()
    la, r = kv.la, kv.ratio
    with torch.inference_mode():
        _, icache = T.kv_flow_step(flow, kv._fw, ptok, toks[:, :la],
                                   kv._prompt_feat, kv._emb, icache,
                                   kv._pe_tok, kv._pe_mel)
        off = 0
        for (e, f), g in zip(plan, got):
            want, icache = T.kv_flow_step(
                flow, kv._fw, toks[:, off:off + e],
                toks[:, off + e:off + e + la],
                torch.zeros((1, e * r, kv.n_mel)), kv._emb, icache,
                kv._pe_tok, kv._pe_mel, finalize=f)
            off += e
            np.testing.assert_array_equal(g.numpy(), want.numpy())
    assert icache["n_tok"] == int(cache["n_tok"])


def test_kernel_engine_matches_unfused_engine(setup):
    assert setup["session"](kernel=False)._kernel is False
    np.testing.assert_allclose(setup["decode"](),
                               setup["decode"](kernel=False),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("wavefront", [False, True])
def test_bulk_vocode_matches_per_hop_chain(setup, wavefront):
    """Per-hop flow with bulk vocoding == the per-hop vocoder chain; the
    wavefront flow with bulk vocoding stays within the wavefront
    tolerance of it."""
    seq = setup["decode"](bulk_voc=False)
    bulk = setup["decode"](bulk_voc=True, wavefront=wavefront)
    assert bulk.shape == seq.shape
    np.testing.assert_allclose(bulk, seq, atol=1e-4 if wavefront else 1e-5,
                               rtol=0)


def test_enc_kernel_wavefront_matches_jax(setup):
    """The wavefront's encoder hop through fused_conformer_group (its plain
    version on the CPU) against the JAX session with the Pallas conformer
    and block kernels; the prefill and the finalize hop keep the per-layer
    encoder step in both."""
    kv = setup["session"](enc_kernel=True)
    assert kv._enc_kernel and kv._kernel and kv._align == 8
    got = setup["decode"](enc_kernel=True)
    want = setup["want_enc_kernel"]()
    assert got.shape == want.shape and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_enc_kernel_matches_per_layer_encoder(setup):
    """As the JAX package pins its enc_kernel session against its default
    (tests/test_kv_stream.py:305-315)."""
    assert setup["session"]()._enc_kernel is False
    np.testing.assert_allclose(setup["decode"](enc_kernel=True),
                               setup["decode"](), atol=2e-5, rtol=0)


@pytest.mark.parametrize("kw,item", [(dict(stacked=True), "stacked")])
def test_options_not_ported_raise(setup, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        setup["session"](**kw)


@pytest.mark.parametrize("hop,est_dtype,kernel_ok", [
    (8, torch.bfloat16, True), (9, torch.bfloat16, False),
    (9, torch.float32, True)])
def test_auto_engine_follows_the_kernel_limit(setup, monkeypatch, hop,
                                              est_dtype, kernel_ok):
    """The bf16 kernel holds a hop of at most 32 frames (8 tokens at ratio
    4): past it ``kernel="auto"`` takes the unfused engine and
    ``kernel=True`` raises a ValueError that names the limit.  The
    expectation is the one ``kernel_limit`` gives for the geometry of the
    session's down, mid and up groups."""
    monkeypatch.setattr(setup["dec"], "estimator_dtype", est_dtype)
    kw = dict(block_size=hop, ring_tokens=2 * hop)
    e = tcfg.tiny_flow_config().estimator
    ch, cf = e.channels[0], 4 * hop
    assert kernel_ok == all(
        fb.kernel_limit(cf, 4 * 2 * hop + cf, cin, ch, 4 * ch, 4 * ch,
                        e.num_heads, e.attention_head_dim, est_dtype) is None
        for cin in (e.in_channels, ch, 2 * ch))
    assert setup["session"](**kw)._kernel is kernel_ok
    if kernel_ok:
        assert setup["session"](kernel=True, **kw)._kernel
    else:
        with pytest.raises(ValueError, match="at most 32 frames, got 36"):
            setup["session"](kernel=True, **kw)


@pytest.mark.parametrize("est_dtype,ring", [(torch.bfloat16, 300),
                                            (torch.bfloat16, 480),
                                            (torch.float32, 480)])
def test_auto_engine_avoids_what_the_kernel_cannot_lay_out(setup, monkeypatch,
                                                           est_dtype, ring):
    """A ring whose slots do not fit the kernel's shared memory in a
    cluster of 4 or 8 CTAs: ``kernel="auto"`` takes the unfused engine and
    ``kernel=True`` raises a ValueError naming shared memory, exactly where
    ``cluster_size`` finds no cluster (the launcher would refuse it)."""
    monkeypatch.setattr(setup["dec"], "estimator_dtype", est_dtype)
    e = tcfg.tiny_flow_config().estimator
    ch, cf = e.channels[0], 4 * HOP
    fits = all(fb.cluster_size(cf, 4 * ring + cf, cin, ch, 4 * ch, 4 * ch,
                               e.num_heads, e.attention_head_dim, est_dtype)
               for cin in (e.in_channels, ch, 2 * ch))
    assert fits == (ring == 300)
    kw = dict(block_size=HOP, ring_tokens=ring)
    assert setup["session"](**kw)._kernel is fits
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            setup["session"](kernel=True, **kw)


OPTIONS = {"concat": dict(fused=False),
           "concat_onehot": dict(fused=False, write_mode="onehot"),
           "onehot": dict(write_mode="onehot"),
           "ring_7": dict(ring_tokens=7)}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_dataflow_options_match_jax_and_the_default(setup, name):
    """The concat dataflow (attention over [ring ++ chunk], the chunk
    written after the estimator: at one shared offset under rotated rings,
    or one-hot per row) and the fused one-hot write (``write_mode=
    "onehot"``, or a ring of 7 tokens at hop 3): each against the JAX
    session with the same option and against the port's default session.
    Each runs the unfused engine, as in the JAX package."""
    kw = OPTIONS[name]
    kv = setup["session"](**kw)
    assert not kv._kernel
    assert kv._dataflow == ("concat" if "fused" in kw else "fused")
    assert kv._write == ("dus" if name == "concat" else "onehot")
    got = kv.stream_decode(setup["tokens"][:, P:])
    want = setup["want_option"](**kw)
    assert got.shape == want.shape and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if name != "ring_7":
        np.testing.assert_allclose(got, setup["decode"](), atol=1e-5,
                                   rtol=0)


def test_kernel_engine_needs_the_fused_shared_offset_geometry(setup):
    for kw in OPTIONS.values():
        with pytest.raises(ValueError, match="kernel engine"):
            setup["session"](kernel=True, **kw)
    with pytest.raises(ValueError, match="write_mode"):
        setup["session"](write_mode="dus")


@pytest.fixture(scope="module")
def decoded(setup):
    """One session's unsegmented stream, f32 and int16."""
    kv = setup["session"]()
    stream = setup["tokens"][:, P:]
    return dict(kv=kv, stream=stream, f32=kv.stream_decode(stream),
                i16=kv.stream_decode(stream, output="int16"))


@pytest.mark.parametrize("path", ["wavefront", "per_hop", "segmented"])
def test_int16_output_is_pcm16_of_the_float_stream(setup, decoded, path):
    kw = {"wavefront": {}, "per_hop": dict(bulk_voc=False),
          "segmented": dict(segmented=True, seg_iters=3)}[path]
    kv, stream = decoded["kv"], decoded["stream"]
    f32 = kv.stream_decode(stream, **kw)
    i16 = kv.stream_decode(stream, output="int16", **kw)
    assert i16.dtype == np.int16 and i16.shape == f32.shape
    np.testing.assert_array_equal(i16, _pcm16(torch.from_numpy(f32)).numpy())
    with pytest.raises(ValueError, match="output"):
        kv.stream_decode(stream, output="int8")


@pytest.mark.parametrize("seg_iters", [2, 3, 5, 16])
def test_segmented_decode_matches_unsegmented(decoded, seg_iters):
    """The wavefront in segments, each vocoded with the carried tails:
    sizes that leave segments with no finished chunk, a first segment with
    one chunk, and one wider than the tail bucket.  The bulk vocoder runs
    its hop windows in batches of one shape, so the segmented stream is the
    unsegmented one bit for bit, in f32 and in int16."""
    kv, stream = decoded["kv"], decoded["stream"]
    sizes = kv._seg_sizes(10 + kv.s_steps - 1, seg_iters)
    assert sum(sizes) >= 13 and (len(sizes) > 1 or seg_iters == 16)
    got = kv.stream_decode(stream, segmented=True, seg_iters=seg_iters)
    np.testing.assert_array_equal(got, decoded["f32"])
    np.testing.assert_array_equal(
        kv.stream_decode(stream, output="int16", segmented=True,
                         seg_iters=seg_iters), decoded["i16"])


def test_segmented_decode_without_a_prompt(setup):
    tdec = setup["dec"]
    kv = tdec.kv_stream_decoder(block_size=HOP, ring_tokens=RING,
                                token_cap=64)
    stream = setup["tokens"][:, P:]
    want = kv.stream_decode(stream)
    np.testing.assert_allclose(
        kv.stream_decode(stream, segmented=True, seg_iters=3), want,
        atol=1e-6, rtol=0)
    jkv = setup["jdec"].kv_stream_decoder(block_size=HOP, ring_tokens=RING,
                                          token_cap=64)
    np.testing.assert_allclose(want, np.asarray(jkv.stream_decode(stream)),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("seg_iters", [4, 8])
def test_stream_chunks_wavefront_join_to_the_stream(decoded, seg_iters):
    """The growing segment schedule: a first segment of S iterations, so
    the first chunk holds one hop."""
    kv = decoded["kv"]
    sizes = kv._seg_sizes(10 + kv.s_steps - 1, seg_iters, grow=True)
    assert sizes[0] == min(kv.s_steps, seg_iters)
    chunks = list(kv.stream_chunks(decoded["stream"], wavefront=True,
                                   seg_iters=seg_iters))
    assert len(chunks) >= 2
    assert chunks[0].shape[1] == (kv.cf * kv.dec.hift_cfg.total_upsample
                                  - kv.scl)
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1),
                                  decoded["f32"])


def test_stream_chunks_per_hop_join_to_the_per_hop_stream(decoded):
    kv, stream = decoded["kv"], decoded["stream"]
    chunks = list(kv.stream_chunks(stream))
    assert len(chunks) == len(kv.schedule(stream.shape[1]))
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1),
                                  kv.stream_decode(stream, bulk_voc=False))


def test_warmup_runs_a_stream(setup):
    kv = setup["session"]()
    kv.warmup(12)
    assert kv._cache is not None and int(kv._w) == 12 // HOP - 1 + \
        kv.s_steps - 1
