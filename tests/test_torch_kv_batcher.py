"""The port's continuous batcher (``pipeline/kv_batcher.py``) and its lanes
wavefront (``models/flow/kv_stream.py::wave_lanes_step[_kernel]``) against
the JAX package's, f32 on the CPU, tiny configs (3 ODE steps, hop 2), same
weights (``weights.flow_state_from_jax`` / ``hift_state_from_jax``); the
port's NSF source gets the JAX draws.

- One lanes tick of three lanes (one stalled, one draining, one in ramp-up)
  of the unfused engine against JAX ``KVLaneWaveStep(fused=True)``, and of
  the kernel engine (the plain ``fused_tf_group`` in its per-row write mode
  on the CPU) against JAX ``wave_lanes_step_pallas`` in interpret mode:
  exit mel, x and mu waves, rings and conv caches within 2e-5 (f32,
  summation order only); ``w`` and the exit flags exactly.
- The staggered protocol of the JAX package's
  ``test_staggered_lanes_match_independent_sessions`` (ring 7 tokens,
  2 lanes, a stream admitted mid-stream of another, a freed lane reused)
  through the port's batcher with the unfused and the kernel engine,
  against the JAX batcher (its XLA engine): each stream's wav within 2e-5,
  the JAX test's bound.
- The concat lanes (``fused=False``: attention over [ring ++ chunk], the
  chunk written after the estimator, canonical-capacity rings): one tick
  against JAX ``KVLaneWaveStep(fused=False)`` and the staggered protocol
  against the JAX batcher with ``fused=False``, both within 2e-5.
- The int8 lanes (``ring_quant=True``, concat lanes with int8 rings and
  per-frame scales, each row's chunk written through ``write_ring_leaf``):
  one tick against JAX ``KVLaneWaveStep(fused=False)`` over the same int8
  rings (int8 values equal, scales and the rest within 2e-5) and the
  staggered protocol against the JAX batcher with ``ring_quant=True``,
  within 2e-5.
- The batched steady vocoder hop: three staggered lanes, each lane's audio
  against its chunks' mels vocoded lane by lane with ``vocode_hop`` within
  2e-5, the caches of the lanes a hop does not update bit for bit
  unchanged, and the ``batcher.voc_replays`` / ``batcher.voc_rows``
  counters.
- The dispatch meter: a second identical run doubles the dispatches and
  the FLOPs (the JAX package's ``test_dispatch_meter_aggregate_flops``).
- The kernel gate.

Torch runs on one thread here: tiny CPU decodes run ~20x slower on its
default thread pool when the suite's workers load every core."""

import dataclasses

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
    CFMConfig, PipelineConfig, tiny_flow_config, tiny_hift_config)
from moss_speech_decoder_cosy_torch.models.flow import kv_stream as T
from moss_speech_decoder_cosy_torch.ops import fused_block as fb
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder as TDecoder
from moss_speech_decoder_cosy_torch.utils import config as tcfg
from moss_speech_decoder_cosy_torch.weights import (
    flow_state_from_jax, hift_state_from_jax)

TOL = 2e-5
HOP, RING = 2, 7


def jax_draws(harmonics, length, device):
    """The NSF draws of the JAX vocoder step (PRNGKey(0))."""
    k_ini, k_noise = jax.random.split(jax.random.PRNGKey(0))
    rand_ini = jax.random.uniform(k_ini, (1, harmonics), dtype=jnp.float32)
    noise = jax.random.normal(k_noise, (1, length, harmonics), jnp.float32)
    return (torch.from_numpy(np.array(rand_ini)).to(device),
            torch.from_numpy(np.array(noise)).to(device))


def _mk_stream(cfg, rng, n_prompt, n_tokens):
    r = cfg.token_mel_ratio
    ptok = rng.randint(0, cfg.vocab_size, (1, n_prompt)).astype(np.int32)
    pfeat = rng.randn(1, n_prompt * r, cfg.output_size).astype(np.float32)
    emb = rng.randn(1, cfg.spk_embed_dim).astype(np.float32)
    toks = rng.randint(0, cfg.vocab_size, (1, n_tokens)).astype(np.int32)
    return ptok, pfeat, emb, toks


def _drain(b, lane, chunks):
    """Pumps until the lane frees, collecting every lane's chunks."""
    for _ in range(64):
        for k, v in b.pump(max_iters=4).items():
            chunks.setdefault(k, []).append(np.asarray(v))
        if not b._lanes[lane].active:
            return
    raise AssertionError("lane never drained")


def staggered(b, streams):
    """The JAX package's staggered protocol on batcher ``b`` (either
    package's): A admitted and pumped, B admitted mid-stream of A, both
    finished and drained, then C in a recycled lane.  Returns the three
    streams' wavs."""
    A, B, C = streams
    chunks = {}

    def pump(n):
        for k, v in b.pump(max_iters=n).items():
            chunks.setdefault(k, []).append(np.asarray(v))

    la = b.admit(A[0], A[1], A[2])
    b.push(la, A[3][0, :5])
    pump(2)
    lb = b.admit(B[0], B[1], B[2])
    b.push(lb, B[3][0, :4])
    b.push(la, A[3][0, 5:])
    b.finish(la)
    pump(3)
    b.push(lb, B[3][0, 4:])
    b.finish(lb)
    _drain(b, la, chunks)
    _drain(b, lb, chunks)
    assert b.free_lanes == 2
    lc = b.admit(C[0], C[1], C[2])
    assert lc in (la, lb)
    chunks_c = {}
    b.push(lc, C[3])
    b.finish(lc)
    _drain(b, lc, chunks_c)
    return [np.concatenate(got[lane], axis=1) for got, lane in
            ((chunks, la), (chunks, lb), (chunks_c, lc))]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny_flow_config(),
                              cfm=CFMConfig(n_timesteps=3, max_noise_len=2048))
    hcfg = tiny_hift_config()
    fp = jax.jit(CausalMaskedDiffWithXvec(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), jnp.zeros((1, 0, cfg.output_size)),
        jnp.zeros((1, cfg.spk_embed_dim)))
    hp = jax.jit(HiFTGenerator(hcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, cfg.output_size)))
    # a louder vocoder head, so the waveform tolerance bites
    hp = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 200.0 if "conv_post" in str(path)
        and str(path[-1]) == "['g']" else a, hp)
    jdec = JDecoder(cfg, hcfg, fp, hp, PipelineConfig(
        block_size=HOP, mel_cache_len=2, max_token_len=9))
    tflow_cfg = dataclasses.replace(
        tcfg.tiny_flow_config(),
        cfm=tcfg.CFMConfig(n_timesteps=3, max_noise_len=2048))
    tdec = TDecoder(tflow_cfg, tcfg.tiny_hift_config(),
                    flow_state_from_jax(jax.tree.map(np.asarray, fp)),
                    hift_state_from_jax(jax.tree.map(np.asarray, hp)),
                    tcfg.PipelineConfig(block_size=HOP, mel_cache_len=2,
                                        max_token_len=9),
                    device="cpu", nsf_draws=jax_draws)
    rng = np.random.RandomState(7)
    streams = [_mk_stream(cfg, rng, p, n) for p, n in ((3, 17), (2, 11),
                                                       (4, 9))]
    return dict(cfg=cfg, jdec=jdec, tdec=tdec, streams=streams)


def _batcher(dec, **kw):
    return dec.kv_batcher(n_lanes=2, block_size=HOP, ring_tokens=RING,
                          token_cap=64, **kw)


@pytest.fixture(scope="module")
def jax_staggered(setup):
    """The JAX batcher (XLA engine) through the staggered protocol, once per
    dataflow (``quant``: int8 rings, which the JAX package runs on concat
    lanes)."""
    got = {}

    def run(fused=True, quant=False):
        if (fused, quant) not in got:
            got[fused, quant] = staggered(
                _batcher(setup["jdec"], kernel=False, fused=fused,
                         ring_quant=quant), setup["streams"])
        return got[fused, quant]
    return run


# ------------------------------------------------------------- one tick
def _tick_inputs(cfg, seed, ring=RING + HOP):
    """Random lanes-tick inputs of three lanes: lane 0 stalled (w == avail),
    lane 1 draining (avail = k_total + S - 1, only its last slot valid),
    lane 2 in ramp-up (w = 1); flat rings of ``ring`` tokens (the fused
    dataflow's extended rp = (7 + 2) * 4 slots by default) with random
    contents, so every slot a row may attend counts."""
    s, lanes, cf, d = cfg.cfm.n_timesteps, 3, HOP * cfg.token_mel_ratio, \
        cfg.output_size
    rng = np.random.RandomState(seed)
    est = J.init_kv_cache(cfg, ring, batch=lanes)["est"]
    est = J.est_cache_to_flat(jax.tree.map(lambda a: jnp.asarray(
        rng.randn(*a.shape).astype(np.float32)), est))
    big = 1 << 30
    w = np.array([4, 6, 1], np.int32)
    scalars = dict(w=w, avail=np.array([4, 5 + s - 1, 3], np.int32),
                   k_total=np.array([big, 5, big], np.int32),
                   base=np.array([8, 0, 12], np.int32))
    waves = dict(x=rng.randn(s, lanes, cf, d), mu=rng.randn(s, lanes, cf, d),
                 mu_buf=rng.randn(lanes, 6, cf, d), spks=rng.randn(lanes, d))
    return est, {k: v.astype(np.float32) for k, v in waves.items()}, scalars


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, what):
    """``got`` (a tree of tensors) within TOL of ``want`` (the same tree of
    JAX arrays)."""
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=TOL, rtol=0, err_msg=what)


@pytest.mark.parametrize("kernel,fused,quant", [
    (False, True, False), (True, True, False), (False, False, False),
    (False, False, True)], ids=["unfused", "kernel", "concat", "int8"])
def test_lanes_tick_matches_jax(setup, kernel, fused, quant):
    """One tick: the unfused engine against JAX ``KVLaneWaveStep`` (fused or
    concat dataflow, canonical-capacity rings for the concat one; int8
    rings for ``quant``), the kernel engine against
    ``wave_lanes_step_pallas`` (interpret mode)."""
    cfg = setup["cfg"]
    est, waves, sc = _tick_inputs(cfg, 3 + kernel + 2 * (not fused)
                                  + quant, RING + HOP if fused else RING)
    if quant:
        est = dict(est, kv=tuple(J.quantize_ring_chunk(a)
                                 for a in est["kv"]))
    jargs = [jnp.asarray(waves[k]) for k in ("x", "mu", "mu_buf", "spks")]
    jsc = [jnp.asarray(sc[k]) for k in ("w", "avail", "k_total", "base")]
    fparams = J.fuse_qkv_params(setup["jdec"].flow_params)
    if kernel:
        gp = J.group_estimator_params(fparams, cfg.estimator)
        jout = J.wave_lanes_step_pallas(
            gp, cfg.cfm, cfg.estimator, *jargs,
            J.group_est_flat(est, cfg.estimator), *jsc, interpret=True)
        jout = jout[:4] + (J.ungroup_est_flat(jout[4], cfg.estimator),
                           jout[5])
    else:
        jout = J.KVLaneWaveStep(cfg, fused=fused).apply(
            fparams, jargs[0], jargs[1], jargs[2], jargs[3], est, *jsc)

    flow = setup["tdec"].flow
    ecfg = flow.decoder.estimator.cfg
    test = _to_torch(est)
    targs = [torch.from_numpy(waves[k]) for k in ("x", "mu", "mu_buf",
                                                  "spks")]
    tsc = [torch.from_numpy(sc[k]).long() for k in ("w", "avail", "k_total",
                                                     "base")]
    fw = T.fuse_qkv_params(flow)
    with torch.inference_mode():
        if kernel:
            est_g = T.group_est_flat(test, ecfg)
            tout = T.wave_lanes_step_kernel(
                T.group_estimator_params(flow, fw), flow.decoder, *targs,
                est_g, *tsc)
            test = T.ungroup_est_flat(est_g, ecfg)
        else:
            tout = T.wave_lanes_step(flow.decoder, fw, *targs, test, *tsc,
                                     dataflow="fused" if fused else "concat")
    mel, ok, x, mu, w = tout
    assert np.array_equal(ok.numpy(), np.asarray(jout[1]))
    assert ok.tolist() == [False, True, False]
    assert np.array_equal(w.numpy(), np.asarray(jout[5]))
    assert w.tolist() == [4, 7, 2]
    for got, want, what in ((mel, jout[0], "exit mel"), (x, jout[2], "x"),
                            (mu, jout[3], "mu")):
        _close(got, want, what)
    _close(test, jout[4], "est")
    # the stalled lane's rows (lane 0 of every (s, cfg)) keep their rings
    rows0 = np.arange(cfg.cfm.n_timesteps * 2) * 3
    leaves = (lambda kv: [a for r in kv for a in (
        (r["v"], r["s"]) if isinstance(r, dict) else (r,))])
    for g, before in zip(leaves(test["kv"]), leaves(est["kv"])):
        np.testing.assert_array_equal(g.numpy()[rows0],
                                      np.asarray(before)[rows0])


# ----------------------------------------------------------- the protocol
@pytest.mark.parametrize("kernel,fused,quant", [
    (False, True, False), (True, True, False), (False, False, False),
    (False, False, True)], ids=["unfused", "kernel", "concat", "int8"])
def test_staggered_lanes_match_jax_batcher(setup, jax_staggered, kernel,
                                           fused, quant):
    b = _batcher(setup["tdec"], kernel=kernel, fused=fused,
                 ring_quant=quant)
    assert b._kernel is kernel and not b._graphs
    assert b.rp == (RING + HOP * fused) * 4
    assert isinstance(b._est["kv"][0], dict) is quant
    before = fb.launch_fused_tf_group.launches
    got = staggered(b, setup["streams"])
    assert fb.launch_fused_tf_group.launches == before   # the CPU: plain
    for g, want, (_, _, _, toks) in zip(got, jax_staggered(fused, quant),
                                        setup["streams"]):
        assert g.shape == want.shape == (
            1, toks.shape[1] * 4 * tiny_hift_config().total_upsample)
        assert np.abs(want).max() > 0.05, "trivial waveform"
        np.testing.assert_allclose(g, want, atol=TOL, rtol=0)


def test_lane_recycled_after_drain_starts_clean(setup):
    """A stream decoded in a fresh pool equals the same stream in a lane
    that served another stream before (the lane's pools are cleared and
    re-scattered)."""
    streams = setup["streams"]
    b = _batcher(setup["tdec"])
    runs = []
    for first in (streams[1], streams[2]):
        lane = b.admit(*first[:3])
        b.push(lane, first[3])
        b.finish(lane)
        chunks = {}
        _drain(b, lane, chunks)
        runs.append(np.concatenate(chunks[lane], axis=1))
    fresh = _batcher(setup["tdec"])
    lane = fresh.admit(*streams[2][:3])
    fresh.push(lane, streams[2][3])
    fresh.finish(lane)
    chunks = {}
    _drain(fresh, lane, chunks)
    np.testing.assert_array_equal(runs[1], np.concatenate(chunks[lane], 1))


# ------------------------------------------------- the batched vocoder hop
def test_batched_steady_hop_matches_per_lane_hops(setup):
    """Three staggered lanes, so that one pump holds a tick where only some
    lanes emit, a stream's first hop beside another lane's steady hop in
    the same tick, and a finalize: each lane's audio equals its
    chunks' mels vocoded lane by lane with ``vocode_hop`` at batch 1 (to
    f32 rounding), every batched hop leaves the caches of the lanes it
    does not update bit for bit as they were, and ``batcher.voc_replays`` /
    ``batcher.voc_rows`` count the hops and the steady chunks that ran."""
    from moss_speech_decoder_cosy_torch.pipeline.kv_batcher import (
        _voc_fields)
    from moss_speech_decoder_cosy_torch.pipeline.kv_session import (
        vocode_hop)
    from moss_speech_decoder_cosy_torch.utils.profiling import TELEMETRY
    A, _, C = setup["streams"]
    # 6 chunks: its steady hops run on through the pump of C's first
    B = _mk_stream(setup["cfg"], np.random.RandomState(11), 2, 15)
    b = setup["tdec"].kv_batcher(n_lanes=3, block_size=HOP,
                                 ring_tokens=RING, token_cap=64)
    hops = {}          # lane -> [(kind, mel)] in the order the lane ran them
    events = []        # (pump, tick or None, lane, kind)
    replays, pump_no, fin_lane = [], [0], [None]
    emit, vocode, step = b._emit, b._vocode, b._voc_step_impl
    finalize = b._finalize_lane

    def rec_emit(lane, st, mel):
        kind = "first" if st.first_voc else "steady"
        hops.setdefault(lane, []).append((kind, mel.clone()))
        events.append((pump_no[0], b._emit_t, lane, kind))
        return emit(lane, st, mel)

    def rec_finalize(lane, st):
        fin_lane[0] = lane
        return finalize(lane, st)

    def rec_vocode(mel, voc, first, fin, draws=None):
        if fin:
            hops[fin_lane[0]].append(("fin", mel.clone()))
            events.append((pump_no[0], None, fin_lane[0], "fin"))
        return vocode(mel, voc, first, fin, draws)

    def checked_step():
        before = [a.clone() for a in _voc_fields(b._voc_pool)]
        step()
        keep = b._voc_keep.clone()
        assert keep.any()
        for a, was in zip(_voc_fields(b._voc_pool), before):
            assert torch.equal(a[~keep], was[~keep])
        replays.append((pump_no[0], keep))

    b._emit, b._vocode, b._voc_step_impl = rec_emit, rec_vocode, checked_step
    b._finalize_lane = rec_finalize
    got = {}

    def pump():
        pump_no[0] += 1
        for lane, wav in b.pump(max_iters=4).items():
            got.setdefault(lane, []).append(wav)

    TELEMETRY.clear()
    enabled = TELEMETRY.enabled
    TELEMETRY.enabled = True
    try:
        la = b.admit(*A[:3])
        b.push(la, A[3])
        pump()
        lb = b.admit(*B[:3])
        b.push(lb, B[3])
        b.finish(la)
        pump()
        lc = b.admit(*C[:3])
        b.push(lc, C[3])
        b.finish(lb)
        b.finish(lc)
        while b.free_lanes < 3:
            pump()
        counters = dict(TELEMETRY.counters)
    finally:
        TELEMETRY.enabled = enabled

    # one pump holds all four cases
    def has_all(p):
        ticks = {}
        for q, t, lane, kind in events:
            if q == p and t is not None:
                ticks.setdefault(t, {})[lane] = kind
        live = {lane for q, _, lane, _ in events if q == p}
        return (any(k == "fin" for q, _, _, k in events if q == p)
                and any(set(d) < live and "steady" in d.values()
                        for d in ticks.values())
                and any("first" in d.values() and "steady" in d.values()
                        for d in ticks.values()))
    assert any(has_all(p) for p in range(1, pump_no[0] + 1))

    fade_in, fade_out = b._fade_in, b._fade_out
    for lane in (la, lb, lc):
        wavs, voc = [], None
        for kind, mel in hops[lane]:
            with torch.inference_mode():
                wav, voc = vocode_hop(
                    b.dec.hift, fade_in, fade_out, b.mel_cache_len, b.dt,
                    mel, voc, kind == "first", kind == "fin",
                    b._voc_draws if kind == "steady" else None)
            wavs.append(wav)
        want = torch.cat(wavs, dim=1).numpy()
        have = np.concatenate(got[lane], axis=1)
        assert have.shape == want.shape and np.abs(want).max() > 0.05
        np.testing.assert_allclose(have, want, atol=TOL, rtol=0)

    n_steady = sum(kind == "steady" for q, _, _, kind in events)
    assert counters["batcher.voc_replays"] == len(replays)
    assert counters["batcher.voc_rows"] == n_steady == sum(
        int(k.sum()) for _, k in replays)
    per_pump = [sum(q == p for q, _ in replays)
                for p in range(1, pump_no[0] + 1)]
    assert max(per_pump) <= 4 and len(replays) < n_steady


# ------------------------------------------------------- gate and options
@pytest.mark.parametrize("est_dtype,hop,ring,limit", [
    (torch.bfloat16, 9, 9, "at most 32 frames, got 36"),
    (torch.float32, HOP, 480, "shared memory")])
def test_kernel_gate_asks_kernel_limit(setup, monkeypatch, est_dtype, hop,
                                       ring, limit):
    """Where ``fused_block.kernel_limit`` refuses a group at the pool's
    ring, ``kernel="auto"`` takes the unfused engine and ``kernel=True``
    raises a ValueError naming the limit."""
    dec = setup["tdec"]
    monkeypatch.setattr(dec, "estimator_dtype", est_dtype)
    e = dec.flow_cfg.estimator
    ch, cf = e.channels[0], 4 * hop
    assert any(fb.kernel_limit(cf, 4 * ring + cf, cin, ch, 4 * ch, 4 * ch,
                               e.num_heads, e.attention_head_dim, est_dtype)
               for cin in (e.in_channels, ch, 2 * ch))
    kw = dict(n_lanes=1, block_size=hop, ring_tokens=ring, token_cap=16)
    assert dec.kv_batcher(**kw)._kernel is False
    with pytest.raises(ValueError, match=limit):
        dec.kv_batcher(kernel=True, **kw)
    assert dec.kv_batcher(n_lanes=1, block_size=HOP, ring_tokens=RING,
                          token_cap=16)._kernel is True


def test_concat_lanes_refuse_the_kernel_engine(setup):
    assert _batcher(setup["tdec"], fused=False)._kernel is False
    with pytest.raises(ValueError, match="fused=True"):
        _batcher(setup["tdec"], fused=False, kernel=True)


@pytest.mark.parametrize("kernel", [False, True], ids=["unfused", "kernel"])
def test_dispatch_meter_doubles_over_two_runs(setup, kernel):
    """The meter counts every graphed step and eager call of a run; a
    second identical run doubles the dispatches and the FLOPs, and nothing
    is counted while it is off."""
    streams = setup["streams"]
    b = _batcher(setup["tdec"], kernel=kernel)

    def run():
        lane = b.admit(*streams[1][:3])
        b.push(lane, streams[1][3])
        b.finish(lane)
        _drain(b, lane, {})

    run()
    assert b.meter.dispatches() == 0 and b.measured_flops() == 0
    b.meter.enabled = True
    run()
    n1, f1 = b.meter.dispatches(), b.measured_flops()
    assert n1 > 0 and f1 > 0
    run()
    b.meter.enabled = False
    run()
    assert b.meter.dispatches() == 2 * n1
    assert b.measured_flops() == 2 * f1
