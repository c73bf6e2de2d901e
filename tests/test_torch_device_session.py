"""The port's ``DeviceStreamDecoder`` (device-resident windowed streaming)
against the JAX package's, f32 on the CPU, tiny configs, same weights; the
port's NSF source gets the JAX draws.  The JAX sessions run as the JAX
package's own tests run them (tests/test_pipeline.py:199-296).

On the CPU the session runs its device-scalar steps eagerly (no CUDA
graphs), on its persistent buffers.

Tolerances on the waveform:
- 1e-4: the port against the JAX session (the port's ``stream_decode``
  parity elsewhere), on the split path with its buckets (batch 1: one
  batched flow forward per bucket; batch 2: flow scans), with and
  without a prompt;
- 2e-4: the port's device session against its own host-mediated
  ``stream_inference`` (the JAX package's bound between its two);
- 1e-5: the fused step against the split steps, and lockstep batch 2
  against each stream alone;
- 1e-4: 16-bit output / 32767 against the float output (quantization
  truncates, < 3.1e-5);
- 1e-6: ``stream_chunks`` concatenated against ``stream_decode``."""

from concurrent.futures import ThreadPoolExecutor

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
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder as TDecoder
from moss_speech_decoder_cosy_torch.pipeline.device_session import (
    stream_chunks)
from moss_speech_decoder_cosy_torch.utils import config as tcfg
from moss_speech_decoder_cosy_torch.weights import (
    flow_state_from_jax, hift_state_from_jax)

HOP, WINDOW, MEL_CACHE = 4, 16, 6
# the JAX runs the tests compare with: (tokens, prompted, block, window,
# batch)
JAX_RUNS = [(30, False, HOP, WINDOW, 1), (30, True, HOP, WINDOW, 1),
            (34, False, HOP, WINDOW, 1), (27, False, 5, 40, 1),
            (30, False, HOP, WINDOW, 2)]


def jax_draws(harmonics, length, device):
    k_ini, k_noise = jax.random.split(jax.random.PRNGKey(0))
    rand_ini = jax.random.uniform(k_ini, (1, harmonics), dtype=jnp.float32)
    noise = jax.random.normal(k_noise, (1, length, harmonics), jnp.float32)
    return (torch.from_numpy(np.array(rand_ini)).to(device),
            torch.from_numpy(np.array(noise)).to(device))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread while this module runs: its tensors are tiny,
    and where the suite's workers load every core, torch's thread pool
    makes each op wait on threads that get no core (measured ~20x
    slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """One JAX decoder and the port's on its weights (a louder vocoder
    head, peak ~0.5, so the tolerances bite and nothing clips), a prompt,
    and ``run(engine, n, prompted, block, window, batch, **kw)``: a
    stream's wav through the JAX or the port's device session, each
    computed once.  The JAX runs of ``JAX_RUNS`` are made up front, each
    in its own session and thread, so their compiles overlap."""
    cfg, hcfg = tiny_flow_config(), tiny_hift_config()
    rng = np.random.RandomState(0)
    r = cfg.token_mel_ratio
    prompt = (rng.randint(0, cfg.vocab_size, (1, 3)).astype(np.int32),
              rng.randn(1, 3 * r, cfg.output_size).astype(np.float32) * 0.1,
              rng.randn(1, cfg.spk_embed_dim).astype(np.float32))
    with ThreadPoolExecutor(2) as pool:
        fp = pool.submit(jax.jit(CausalMaskedDiffWithXvec(cfg).init),
                         jax.random.PRNGKey(1), jnp.zeros((1, 12), jnp.int32),
                         jnp.ones((1, 12), bool),
                         jnp.zeros((1, 0, cfg.output_size)),
                         jnp.zeros((1, cfg.spk_embed_dim)))
        hp = pool.submit(jax.jit(HiFTGenerator(hcfg).init),
                         jax.random.PRNGKey(2),
                         jnp.zeros((1, 8, hcfg.in_channels)))
        fp, hp = fp.result(), hp.result()
    hp = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 100.0 if "conv_post" in str(path)
        and str(path[-1]) == "['g']" else a, hp)
    pipe = dict(block_size=HOP, mel_cache_len=MEL_CACHE,
                max_token_len=WINDOW)
    jdec = JDecoder(cfg, hcfg, fp, hp, PipelineConfig(**pipe))
    tdec = TDecoder(
        tcfg.tiny_flow_config(), tcfg.tiny_hift_config(),
        flow_state_from_jax(jax.tree.map(np.asarray, fp)),
        hift_state_from_jax(jax.tree.map(np.asarray, hp)),
        tcfg.PipelineConfig(**pipe), device="cpu", nsf_draws=jax_draws)
    wavs, sessions = {}, {}

    def tokens(n, batch=1):
        return np.random.RandomState(n + 100 * batch).randint(
            0, cfg.vocab_size, (batch, n))

    def session(engine, prompted=False, block=HOP, window=WINDOW, batch=1):
        key = (engine, prompted, block, window, batch)
        if key not in sessions:
            dec = jdec if engine == "jax" else tdec
            sessions[key] = dec.device_stream_decoder(
                *(prompt if prompted else ()), block_size=block,
                max_token_len=window, batch=batch)
        return sessions[key]

    def run(engine, n, prompted=False, block=HOP, window=WINDOW, batch=1,
            **kw):
        key = (engine, n, prompted, block, window, batch,
               tuple(sorted(kw.items())))
        if key not in wavs:
            sess = session(engine, prompted, block, window, batch)
            wavs[key] = np.asarray(sess.stream_decode(tokens(n, batch),
                                                      **kw))
        return wavs[key]

    def jax_run(spec):
        n, prompted, block, window, batch = spec
        sess = jdec.device_stream_decoder(
            *(prompt if prompted else ()), block_size=block,
            max_token_len=window, batch=batch)
        return np.asarray(sess.stream_decode(tokens(n, batch)))

    with ThreadPoolExecutor(len(JAX_RUNS)) as pool:
        for spec, wav in zip(JAX_RUNS, pool.map(jax_run, JAX_RUNS)):
            wavs[("jax",) + spec + ((),)] = wav

    return dict(jdec=jdec, tdec=tdec, prompt=prompt, tokens=tokens,
                session=session, run=run)


def _close(got, want, atol):
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.05 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("prompted", [False, True],
                         ids=["no_prompt", "prompt3"])
def test_matches_jax(setup, prompted):
    """Block 4, window 16, 30 tokens: the first hop, a bucket of 4 steady
    windows (one batched flow forward) that straddles the point where the
    window fills, a single steady hop and the finalize tail."""
    run, sess = setup["run"], setup["session"]("torch", prompted)
    keys = sess.dispatches(30)
    assert ("fbatch", 4, HOP) in keys and ("vscan", 4) in keys
    _close(run("torch", 30, prompted), run("jax", 30, prompted), 1e-4)


def test_matches_jax_buckets_4_and_2(setup):
    """34 tokens: six steady hops go as buckets of 4 and 2; the first
    bucket's windows start at 0, 0, 3 and 7 (the window fills inside it),
    so their per-window offsets and padding differ."""
    run, sess = setup["run"], setup["session"]("torch")
    keys = sess.dispatches(34)
    assert [k for k in keys if k[0] == "fbatch"] == [("fbatch", 4, HOP),
                                                     ("fbatch", 2, HOP)]
    la = sess.la
    starts = [max(off + HOP + la - WINDOW, 0) for off in (4, 8, 12, 16)]
    assert starts == [0, 0, 3, 7]
    _close(run("torch", 34), run("jax", 34), 1e-4)


def test_production_knobs_match_jax(setup):
    """Block 5, window 40 (the reference's defaults), 27 tokens: every
    window shorter than the window bound, so every one is padded."""
    run = setup["run"]
    _close(run("torch", 27, block=5, window=40),
           run("jax", 27, block=5, window=40), 1e-4)


def test_batch2_matches_jax_and_single_streams(setup):
    """Lockstep batch 2 (the buckets as flow scans) against the JAX batch
    2, and against each stream through the batch-1 session."""
    run, tokens = setup["run"], setup["tokens"]
    sess = setup["session"]("torch", batch=2)
    assert ("fscan", 4, HOP) in sess.dispatches(30)
    got = run("torch", 30, batch=2)
    _close(got, run("jax", 30, batch=2), 1e-4)
    single = setup["session"]("torch")
    toks = tokens(30, batch=2)
    for i in range(2):
        _close(got[i:i + 1], single.stream_decode(toks[i:i + 1]), 1e-5)


def test_fused_matches_split(setup):
    run = setup["run"]
    _close(run("torch", 34, fused=True), run("torch", 34), 1e-5)


def test_int16_output(setup):
    run = setup["run"]
    wav_f = run("torch", 34)
    wav_i = run("torch", 34, output="int16")
    assert wav_i.dtype == np.int16 and np.abs(wav_f).max() < 1.0
    np.testing.assert_allclose(wav_i.astype(np.float32) / 32767.0, wav_f,
                               atol=1e-4, rtol=0)


def test_stream_chunks_match_stream_decode(setup):
    """One float32 chunk per hop, in order, concatenating to the decode."""
    sess, tokens = setup["session"]("torch", True), setup["tokens"]
    chunks = list(stream_chunks(sess, tokens(30)))
    n_hops = len([p for p in sess.schedule(30) if p[0] > 0])
    assert len(chunks) == n_hops
    assert all(c.dtype == np.float32 for c in chunks)
    _close(np.concatenate(chunks, axis=-1), setup["run"]("torch", 30, True),
           1e-6)


@pytest.mark.parametrize("prompted", [False, True],
                         ids=["no_prompt", "prompt3"])
def test_matches_own_stream_inference(setup, prompted):
    tdec, tokens = setup["tdec"], setup["tokens"]
    prompt = setup["prompt"] if prompted else ()
    want = tdec.stream_inference(tokens(34), *prompt, block_size=HOP,
                                 max_token_len=WINDOW)
    _close(setup["run"]("torch", 34, prompted), want, 2e-4)


def test_step_api_gives_the_first_hop(setup):
    """``_flow_step`` + ``_voc_step`` of the first hop from a fresh state
    (the first-hop latency's calls) give the decode's first samples, and
    the steps refuse buffers that are not the session's."""
    sess, tokens = setup["session"]("torch"), setup["tokens"]
    toks = tokens(34)
    want = sess.stream_decode(toks)
    buf = sess._token_buf(toks)
    state = sess.init_state()
    mel = sess._flow_step(buf, state, HOP, False)
    seg, state = sess._voc_step(mel, state, True, False)
    assert int(state.token_offset) == HOP
    _close(seg.numpy(), want[:, :seg.shape[1]], 0.0)
    with pytest.raises(ValueError, match="own buffers"):
        sess._flow_step(buf.clone(), state, HOP, False)


def test_one_session_decodes_streams_of_any_length(setup):
    """The token and audio buffers grow for a longer stream; a shorter one
    after it decodes as before."""
    tdec, tokens = setup["tdec"], setup["tokens"]
    sess = tdec.device_stream_decoder(block_size=HOP, max_token_len=WINDOW)
    short = sess.stream_decode(tokens(27))
    assert sess._tok.shape[1] == 256
    long_ = sess.stream_decode(tokens(300))
    assert sess._tok.shape[1] == 512
    assert long_.shape == (1, 300 * sess.ratio * sess.frame)
    assert ("fbatch", 64, HOP) in sess.dispatches(300)
    np.testing.assert_array_equal(sess.stream_decode(tokens(27)), short)


@pytest.mark.parametrize("hop", [3, 4, 5])
@pytest.mark.parametrize("p", [0, 3, 5])
@pytest.mark.parametrize("n", [0, 6, 7, 30, 61])
def test_schedule_matches_jax(setup, n, p, hop):
    jdec, tdec = setup["jdec"], setup["tdec"]
    cfg = tdec.flow_cfg
    prompt = (np.zeros((1, p), np.int32),
              np.zeros((1, p * cfg.token_mel_ratio, cfg.output_size),
                       np.float32))
    want = jdec.device_stream_decoder(*prompt, block_size=hop).schedule(n)
    got = tdec.device_stream_decoder(*prompt, block_size=hop).schedule(n)
    assert got == want


def test_batch_mismatch_raises(setup):
    sess = setup["session"]("torch")
    with pytest.raises(ValueError, match="batch"):
        sess.stream_decode(np.zeros((2, 10), np.int32))


def test_entry_point_needs_a_card_unless_told(setup, monkeypatch):
    """The decoder behind ``device_stream_decoder`` runs on CUDA by default
    and raises where there is none; ``device="cpu"`` runs here."""
    tdec = setup["tdec"]
    states = (tdec.flow.state_dict(), tdec.hift.state_dict())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TDecoder(tdec.flow_cfg, tdec.hift_cfg, *states, tdec.pipe_cfg)
    cpu = TDecoder(tdec.flow_cfg, tdec.hift_cfg, *states, tdec.pipe_cfg,
                   device="cpu")
    assert cpu.device_stream_decoder().dev.type == "cpu"
