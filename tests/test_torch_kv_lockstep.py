"""Lockstep multi-stream KV decoding and int8 estimator rings in the port
against the JAX package, f32 on the CPU, tiny configs, same weights
(``flow_state_from_jax`` / ``hift_state_from_jax``), the port's NSF source
given the JAX draws; 2-token prompts, hop 3, ring 6 (as
``test_torch_kv_session.py``).

- ``quantize_ring_chunk``: int8 values equal to the JAX package's, scales
  within 1 ulp; ``dequantize_ring`` within 1 ulp;
- ``write_ring_leaf`` over an int8 ring through each write primitive
  (``ring_write``, the per-row write against JAX ``ring_write_batched``,
  the shared-offset write against JAX ``ring_write_dus``): values and
  scales equal;
- ``init_kv_cache(est_quant=True)``: the JAX package's leaves, and
  ``est_cache_bytes`` equal to its count;
- ``kv_stream_decoder(batch=2)`` with per-stream prompts and with one
  shared prompt against the JAX session at ``batch=2``: wav within 1e-4
  (the kernel engine, its plain version on the CPU, and the unfused one);
  each row against the port's batch-1 session on that stream: within 1e-5;
- ``ring_quant=True`` against the JAX int8 session: wav within 1e-4; and
  within the JAX package's rel-L1 bound (5e-2) of the full-precision
  session;
- lockstep int16, segmented and chunked output equal to the unsegmented
  stream; ``program_flops`` at batch 2 above batch 1's and below twice it
  (the vocoder's padded batches of 16 windows hold both streams);
- the multi-stream ``BulkVocoder`` against one call per stream: 1e-6
  (measured equal: every HiFT call takes one batch shape);
- the options that raise: ``enc_kernel`` at batch 2, ``ring_quant`` with
  ``fused=True`` or ``kernel=True``, tokens or prompts of another batch.

Torch runs on one thread here: tiny CPU decodes run ~20x slower on its
default thread pool when the suite's workers load every core."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.flow import CausalMaskedDiffWithXvec
from moss_speech_decoder_cosy_tpu.models.flow import kv_stream as J
from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator
from moss_speech_decoder_cosy_tpu.pipeline import AudioDecoder as JDecoder
from moss_speech_decoder_cosy_tpu.utils.config import (
    PipelineConfig, tiny_flow_config, tiny_hift_config)
from moss_speech_decoder_cosy_torch.models.flow import kv_stream as T
from moss_speech_decoder_cosy_torch.ops import fused_block as fb
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder as TDecoder
from moss_speech_decoder_cosy_torch.pipeline.bulk_voc import BulkVocoder
from moss_speech_decoder_cosy_torch.pipeline.kv_session import _pcm16
from moss_speech_decoder_cosy_torch.utils import config as tcfg
from moss_speech_decoder_cosy_torch.weights import (
    flow_state_from_jax, hift_state_from_jax)

P, N, HOP, RING, B = 2, 34, 3, 6, 2


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
    tokens = rng.randint(0, cfg.vocab_size, (B, N)).astype(np.int32)
    prompts = (rng.randint(0, cfg.vocab_size, (B, P)).astype(np.int32),
               rng.randn(B, P * r, cfg.output_size).astype(np.float32),
               rng.randn(B, cfg.spk_embed_dim).astype(np.float32))
    fp = jax.jit(CausalMaskedDiffWithXvec(cfg).init)(
        jax.random.PRNGKey(1), jnp.asarray(tokens[:1]),
        jnp.ones((1, N), bool), jnp.asarray(prompts[1][:1]),
        jnp.asarray(prompts[2][:1]))
    hp = jax.jit(HiFTGenerator(hcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 8, hcfg.in_channels)))
    # a louder vocoder head, so the waveform tolerances bite
    hp = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 200.0 if "conv_post" in str(path)
        and str(path[-1]) == "['g']" else a, hp)
    pipe = dict(block_size=HOP, mel_cache_len=2, max_token_len=9)
    jdec = JDecoder(cfg, hcfg, fp, hp, PipelineConfig(**pipe))
    tdec = TDecoder(
        tcfg.tiny_flow_config(), tcfg.tiny_hift_config(),
        flow_state_from_jax(jax.tree.map(np.asarray, fp)),
        hift_state_from_jax(jax.tree.map(np.asarray, hp)),
        tcfg.PipelineConfig(**pipe), device="cpu", nsf_draws=jax_draws)
    geo = dict(block_size=HOP, ring_tokens=RING, token_cap=64)
    got = {}

    def prompt(shared):
        return tuple(a[:1] for a in prompts) if shared else prompts

    def want(shared=False, quant=False):
        """The JAX session (its default engine, or int8 rings) of the two
        streams, or of stream 0 alone with ``quant``."""
        key = ("jax", shared, quant)
        if key not in got:
            if quant:
                kv = jdec.kv_stream_decoder(*prompt(True), ring_quant=True,
                                            **geo)
                got[key] = np.asarray(kv.stream_decode(tokens[:1]))
            else:
                kv = jdec.kv_stream_decoder(*prompt(shared), batch=B, **geo)
                got[key] = np.asarray(kv.stream_decode(tokens))
        return got[key]

    def session(shared=False, rows=None, **kw):
        p = prompt(shared)
        if rows is not None:
            p = tuple(a[rows] for a in p)
        return tdec.kv_stream_decoder(*p, **dict(geo, **kw))

    def decode(shared=False, **kw):
        key = ("port", shared) + tuple(sorted(kw.items()))
        if key not in got:
            before = fb.launch_fused_tf_group.launches
            got[key] = session(shared, batch=B, **kw).stream_decode(tokens)
            assert fb.launch_fused_tf_group.launches == before
        return got[key]

    def single(i, shared=False, **kw):
        key = ("single", i, shared) + tuple(sorted(kw.items()))
        if key not in got:
            got[key] = session(shared, rows=slice(0 if shared else i,
                                                  1 if shared else i + 1),
                               **kw).stream_decode(tokens[i:i + 1])
        return got[key]

    return dict(want=want, session=session, decode=decode, single=single,
                tokens=tokens, prompts=prompts, tdec=tdec, cfg=cfg)


# ----------------------------------------------------------- ring leaves
def _ulp(a):
    return np.spacing(np.abs(a).astype(np.float32))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_quantize_ring_chunk_matches_jax(dtype):
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 3, 5, 16) * rng.rand(2, 3, 5, 1) * 4).astype(np.float32)
    x[0, 1, 2] = 0.0                       # a silent frame: scale 0
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    jq, tq = J.quantize_ring_chunk(jx), T.quantize_ring_chunk(tx)
    assert tq["v"].dtype == torch.int8 and tq["s"].dtype == torch.float32
    assert tq["s"].shape == (2, 3, 5, 1)
    np.testing.assert_array_equal(tq["v"].numpy(), np.asarray(jq["v"]))
    js = np.asarray(jq["s"])
    assert np.all(np.abs(tq["s"].numpy() - js) <= _ulp(js))
    deq = T.dequantize_ring(tq, torch.float32).numpy()
    jdeq = np.asarray(J.dequantize_ring(jq, jnp.float32))
    assert np.all(np.abs(deq - jdeq) <= _ulp(jdeq))
    assert np.abs(deq - np.asarray(jx.astype(jnp.float32))).max() <= \
        np.abs(x).max() / 127 / 2 * 1.01


@pytest.mark.parametrize("prim", ["shared", "rows", "dus"])
def test_write_ring_leaf_matches_jax(prim):
    """An int8 ring written through each write primitive: the values and
    scales the JAX package's ``write_ring_leaf`` gives, exactly."""
    rng = np.random.RandomState(4)
    rows, r, c, d = 4, 12, 4, 8
    ring = J.quantize_ring_chunk(jnp.asarray(
        rng.randn(rows, r, d).astype(np.float32)))
    chunk = rng.randn(rows, c, d).astype(np.float32)
    nd = np.array([0, 5, 10, 23], np.int32)
    en = np.array([True, False, True, True])
    tring = {k: torch.from_numpy(np.array(v)) for k, v in ring.items()}
    tchunk = torch.from_numpy(chunk)
    if prim == "shared":
        want = J.write_ring_leaf(J.ring_write, ring, jnp.asarray(chunk), 10)
        got = T.write_ring_leaf(T.ring_write, tring, tchunk, 10)
    elif prim == "rows":
        want = J.write_ring_leaf(J.ring_write_batched, ring,
                                 jnp.asarray(chunk), jnp.asarray(nd),
                                 enable=jnp.asarray(en))
        got = T.write_ring_leaf(T.ring_write_rows, tring, tchunk,
                                torch.from_numpy(nd).long(),
                                torch.from_numpy(en))
    else:
        want = J.write_ring_leaf(J.ring_write_dus, ring, jnp.asarray(chunk),
                                 jnp.asarray(10), jnp.asarray(en), 2)
        got = T.write_ring_leaf(T.ring_write_dus, tring, tchunk,
                                torch.tensor(10), torch.from_numpy(en))
    assert got is tring and got["v"].dtype == torch.int8
    for k in ("v", "s"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the disabled row kept its content
    if prim != "shared":
        np.testing.assert_array_equal(got["v"][1].numpy(),
                                      np.asarray(ring["v"][1]))


@pytest.mark.parametrize("quant", [False, True])
def test_int8_cache_layout_and_bytes_match_jax(quant):
    jc = J.init_kv_cache(tiny_flow_config(), RING, batch=B, est_quant=quant)
    tc = T.init_kv_cache(tcfg.tiny_flow_config(), RING, batch=B,
                         est_quant=quant)
    for jr, tr in zip(jc["est"]["kv"], tc["est"]["kv"]):
        assert isinstance(tr, dict) is quant
        pairs = ([(jr[k], tr[k]) for k in ("v", "s")] if quant
                 else [(jr, tr)])
        for a, t in pairs:
            assert tuple(a.shape) == tuple(t.shape)
            assert str(a.dtype) == str(t.dtype).split(".")[-1]
    assert T.est_cache_bytes(tc["est"]) == J.est_cache_bytes(jc["est"])


def test_rotate_rings_carries_both_leaves():
    rng = np.random.RandomState(5)
    ring = T.quantize_ring_chunk(torch.from_numpy(
        rng.randn(3, 8, 4).astype(np.float32)))
    want = {k: v.clone() for k, v in ring.items()}
    rot = torch.tensor([0, 3, 5])
    T.rotate_rings(ring, rot)
    for k in ("v", "s"):
        T.rotate_rings(want[k], rot)
        np.testing.assert_array_equal(ring[k].numpy(), want[k].numpy())
    T.rotate_rings(ring, rot, inverse=True)
    T.rotate_rings(want["v"], rot, inverse=True)
    np.testing.assert_array_equal(ring["v"].numpy(), want["v"].numpy())


# ------------------------------------------------------ lockstep sessions
@pytest.mark.parametrize("kernel", ["auto", False], ids=["kernel", "unfused"])
@pytest.mark.parametrize("shared", [False, True],
                         ids=["per_stream", "shared_prompt"])
def test_lockstep_matches_jax(setup, shared, kernel):
    kv = setup["session"](shared, batch=B, kernel=kernel)
    assert kv._kernel is (kernel == "auto") and kv.b == B
    kv.init_state()
    assert kv._ext["kv"][0].shape[0] == kv.s_steps * 2 * B
    assert kv._x_w.shape[1] == kv._mels.shape[1] == kv._tok.shape[0] == B
    got, want = setup["decode"](shared, kernel=kernel), setup["want"](shared)
    assert got.shape == want.shape == (
        B, N * 4 * tiny_hift_config().total_upsample)
    assert np.abs(want).max() > 0.05, "trivial waveform"
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shared", [False, True],
                         ids=["per_stream", "shared_prompt"])
def test_lockstep_rows_match_single_streams(setup, shared):
    got = setup["decode"](shared)
    for i in range(B):
        np.testing.assert_allclose(got[i:i + 1], setup["single"](i, shared),
                                   atol=1e-5, rtol=0)
    assert np.abs(got[0] - got[1]).max() > 0.05     # the rows differ


def test_int8_session_matches_jax(setup):
    kv = setup["session"](True, ring_quant=True)
    assert not kv._fused and not kv._kernel and kv._write == "onehot"
    got = kv.stream_decode(setup["tokens"][:1])
    assert isinstance(kv._cache["est"]["kv"][0], dict)
    assert kv._cache["est"]["kv"][0]["v"].dtype == torch.int8
    want = setup["want"](quant=True)
    assert got.shape == want.shape and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    full = setup["single"](0, True)
    rel = np.abs(got - full).sum() / np.abs(full).sum()
    assert 0 < rel < 5e-2, rel


def test_int8_lockstep_rows_match_int8_single_streams(setup):
    """1e-4, the JAX-parity bound: the batched products differ from the
    single stream's in the last bit, and that can move an int8 value by one
    step where it sits on a rounding boundary (measured 1.2e-5)."""
    got = setup["decode"](ring_quant=True)
    for i in range(B):
        np.testing.assert_allclose(
            got[i:i + 1], setup["single"](i, ring_quant=True),
            atol=1e-4, rtol=0)


def test_lockstep_outputs_agree(setup):
    """int16 == ``_pcm16`` of the f32 stream; segmented decoding and the
    wavefront chunks join to the unsegmented stream, row by row."""
    kv = setup["session"](batch=B)
    toks = setup["tokens"]
    f32 = setup["decode"]()
    pcm = kv.stream_decode(toks, output="int16")
    assert pcm.dtype == np.int16 and pcm.shape == f32.shape
    np.testing.assert_array_equal(pcm, _pcm16(torch.from_numpy(f32)).numpy())
    np.testing.assert_array_equal(
        kv.stream_decode(toks, segmented=True, seg_iters=3), f32)
    chunks = list(kv.stream_chunks(toks, wavefront=True, seg_iters=3))
    assert all(c.shape[0] == B for c in chunks) and len(chunks) >= 2
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), f32)


def test_program_flops_scale_with_the_streams(setup):
    one = setup["session"](True).program_flops(20)
    two = setup["session"](True, batch=B).program_flops(20)
    # every stream's products count; the vocoder's padded batches of 16
    # windows hold both streams' windows here, so its count stays
    assert one < two < B * one


def test_bulk_vocoder_streams_match_single_calls(setup):
    dec = setup["tdec"]
    rng = np.random.RandomState(6)
    cf = HOP * dec.ratio
    plan = [cf] * 5 + [7]
    mel = torch.from_numpy(rng.randn(3, sum(plan), dec.flow_cfg.output_size)
                           .astype(np.float32))
    bulk = BulkVocoder(dec, cf)
    got = bulk.vocode(mel, plan)
    assert got.shape == (3, sum(plan) * dec.hift_cfg.total_upsample)
    for i in range(3):
        np.testing.assert_allclose(got[i:i + 1].numpy(),
                                   bulk.vocode(mel[i:i + 1], plan).numpy(),
                                   atol=1e-6, rtol=0)
    # segments with their tails carried, per stream
    wav, s_t, w_t = bulk.vocode_first(mel[:, :3 * cf], 2, 0, hold=True)
    rest, _, _ = bulk.vocode_cont(mel[:, 3 * cf - 2:], s_t, w_t, 2, 7)
    np.testing.assert_array_equal(torch.cat([wav, rest], 1).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("kw,err", [
    (dict(batch=B, enc_kernel=True), "enc_kernel"),
    (dict(ring_quant=True, fused=True), "concat"),
    (dict(ring_quant=True, kernel=True), "kernel engine"),
    (dict(batch=3), "prompt of 2 rows")])
def test_options_that_raise(setup, kw, err):
    with pytest.raises(ValueError, match=err):
        setup["session"](**kw)


def test_tokens_of_another_batch_raise(setup):
    kv = setup["session"](batch=B)
    with pytest.raises(ValueError, match="lockstep"):
        kv.stream_decode(setup["tokens"][:1])
