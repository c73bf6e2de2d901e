"""The port's KV streaming flow (``models/flow/kv_stream.py``) against the
JAX package's, f32 on the CPU, tiny config, same weights (``weights.py``):

- ``kv_flow_step`` over prompt prefill, steady hops and the finalize tail
  against JAX ``KVFlowStep`` (mel per hop), with and without a prompt;
- the ring extend / shrink of the fused layout, the per-row ring write and
  ``est_cache_from_flat`` against JAX;
- one wavefront iteration (fused write-then-attend, shared offset) of the
  unfused engine and of the kernel engine against JAX
  ``CausalConditionalCFMWave``;
- three consecutive kernel encoder hops (``encoder_hop_kernel``, the plain
  conformer group on the CPU) against JAX ``encoder_hop_pallas`` in
  interpret mode.

Tolerances: mel 2e-5, wave outputs 2e-5 and encoder hops 2e-5 (f32,
summation order only); the extend / shrink gathers are exact.  Each step
also runs with its positions (``n_tok``; ``w``, ``k_total``,
``base_frames``) held in tensors, as the KV session's captured steps pass
them, and must give the host-int path's outputs bit for bit."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.flow import CausalMaskedDiffWithXvec
from moss_speech_decoder_cosy_tpu.models.flow import kv_stream as J
from moss_speech_decoder_cosy_tpu.utils.config import tiny_flow_config
from moss_speech_decoder_cosy_torch.models.flow import (
    CausalMaskedDiffWithXvec as TFlow)
from moss_speech_decoder_cosy_torch.models.flow import kv_stream as T
from moss_speech_decoder_cosy_torch.utils import config as tcfg
from moss_speech_decoder_cosy_torch.weights import flow_state_from_jax

TOL = 2e-5


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(to_torch(v) for v in tree)
    if isinstance(tree, int):
        return tree
    return torch.from_numpy(np.array(tree))


def assert_tree_close(got, want, atol, what=""):
    if isinstance(want, dict):
        for k in want:
            assert_tree_close(got[k], want[k], atol, f"{what}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, atol, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=atol, rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_flow_config()
    p, n = 8, 24
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (1, p + n)).astype(np.int32)
    prompt_feat = rng.randn(1, p * cfg.token_mel_ratio,
                            cfg.output_size).astype(np.float32)
    emb = rng.randn(1, cfg.spk_embed_dim).astype(np.float32)
    params = jax.jit(CausalMaskedDiffWithXvec(cfg).init)(
        jax.random.PRNGKey(1), jnp.asarray(tokens),
        jnp.ones(tokens.shape, bool), jnp.asarray(prompt_feat),
        jnp.asarray(emb))
    flow = TFlow(tcfg.tiny_flow_config())
    flow.load_state_dict(flow_state_from_jax(jax.tree.map(np.asarray,
                                                          params)))
    flow.eval()
    return dict(cfg=cfg, params=params, fparams=J.fuse_qkv_params(params),
                flow=flow, fused=T.fuse_qkv_params(flow), tokens=tokens,
                prompt_feat=prompt_feat, emb=emb)


@pytest.mark.parametrize("p", [2, 0])
def test_kv_flow_step_matches_jax(models, p):
    """Prefill + steady hops + finalize tail, mel hop by hop (as
    tests/test_kv_stream.py:41-72 runs the JAX step)."""
    m = models
    cfg, hop, ring_t = m["cfg"], 4, 8
    la, r = cfg.pre_lookahead_len, cfg.token_mel_ratio
    tokens = m["tokens"][:, 8 - p:]
    n = tokens.shape[1] - p
    stream = tokens[:, p:]
    step = J.KVFlowStep(cfg)
    apply = jax.jit(step.apply, static_argnames=("finalize",))
    jcache = J.init_kv_cache(cfg, ring_t)
    pe_tok, pe_mel = J.pe_tables(cfg, 64)
    tcache = T.init_kv_cache(tcfg.tiny_flow_config(), ring_t)
    # the same step with n_tok held in a tensor
    dcache = dict(T.init_kv_cache(tcfg.tiny_flow_config(), ring_t),
                  n_tok=torch.tensor(0))
    tpe_tok, tpe_mel = T.pe_tables(tcfg.tiny_flow_config(), 64)
    emb = m["emb"]

    def both(chunk, ctx, cond, finalize):
        nonlocal jcache, tcache, dcache
        jm, jcache = apply(m["fparams"], chunk, ctx, cond, emb, jcache,
                           pe_tok, pe_mel, finalize=finalize)
        args = (torch.from_numpy(chunk).long(), torch.from_numpy(ctx).long(),
                torch.from_numpy(cond), torch.from_numpy(emb))
        with torch.inference_mode():
            tm, tcache = T.kv_flow_step(m["flow"], m["fused"], *args, tcache,
                                        tpe_tok, tpe_mel, finalize=finalize)
            dm, dcache = T.kv_flow_step(m["flow"], m["fused"], *args, dcache,
                                        tpe_tok, tpe_mel, finalize=finalize)
        assert torch.equal(dm, tm)
        return tm.numpy(), np.asarray(jm)

    pairs = []
    if p:
        pairs.append(both(tokens[:, :p], stream[:, :la],
                          m["prompt_feat"][:, :p * r], False))
    off = 0
    while n - off >= hop + la:
        pairs.append(both(stream[:, off:off + hop],
                          stream[:, off + hop:off + hop + la],
                          np.zeros((1, hop * r, cfg.output_size),
                                   np.float32), False))
        off += hop
    tail = stream[:, off:]
    pairs.append(both(tail, np.zeros((1, la), np.int32),
                      np.zeros((1, tail.shape[1] * r, cfg.output_size),
                               np.float32), True))
    assert len(pairs) >= 4
    for i, (got, want) in enumerate(pairs):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0,
                                   err_msg=f"hop {i}")
    assert tcache["n_tok"] == int(jcache["n_tok"]) == p + n
    assert_tree_close(tcache["est"], jcache["est"], TOL, "est")
    assert_tree_close(tcache["enc"], jcache["enc"], TOL, "enc")
    assert torch.is_tensor(dcache["n_tok"]) and int(dcache["n_tok"]) == p + n
    assert_tree_close(dcache["est"], tcache["est"], 0.0, "device n_tok est")
    assert_tree_close(dcache["enc"], tcache["enc"], 0.0, "device n_tok enc")


def _random_est(cfg, ring_t, seed):
    est = J.init_kv_cache(cfg, ring_t)["est"]
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        rng.randn(*a.shape).astype(np.float32)), est)


@pytest.mark.parametrize("c", [3, 9])
def test_ring_write_rows_matches_jax(c):
    """Per-row ring writes (the continuous batcher's lanes) against JAX
    ``ring_write_batched``: rows at their own positions, one wrapping, one
    disabled; a chunk that wraps (3) and one longer than the ring (9 > 7).
    Exact: an index write against a one-hot product."""
    rng = np.random.RandomState(c)
    ring = rng.randn(4, 7, 5).astype(np.float32)
    chunk = rng.randn(4, c, 5).astype(np.float32)
    nd = np.array([0, 5, 13, 6], np.int32)
    en = np.array([True, True, False, True])
    want = J.ring_write_batched(jnp.asarray(ring), jnp.asarray(chunk),
                                jnp.asarray(nd), enable=jnp.asarray(en))
    got = T.ring_write_rows(torch.from_numpy(ring.copy()),
                            torch.from_numpy(chunk),
                            torch.from_numpy(nd).long(), torch.from_numpy(en))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_est_cache_from_flat_matches_jax(models):
    cfg = models["cfg"]
    flat = J.est_cache_to_flat(_random_est(cfg, 6, 3))
    assert_tree_close(T.est_cache_from_flat(to_torch(flat),
                                            cfg.cfm.n_timesteps),
                      J.est_cache_from_flat(flat, cfg.cfm.n_timesteps), 0.0,
                      "est")


@pytest.mark.parametrize("n_frames", [10, 40])
def test_extend_shrink_rings_match_jax(models, n_frames):
    """Ramp-up (10 frames written) and a full ring (40 > R = 24)."""
    cfg, ring_t, cf = models["cfg"], 6, 12
    flat = J.est_cache_to_flat(_random_est(cfg, ring_t, n_frames))
    rows = flat["kv"][0].shape[0]
    rp = ring_t * cfg.token_mel_ratio + cf
    rot = [(s * cf) % rp for s in range(rows // 2) for _ in range(2)]
    jext = J.extend_rings_for_fused(flat, n_frames, cf, rot)
    text = T.extend_rings_for_fused(to_torch(flat), n_frames, cf, rot)
    assert_tree_close(text, jext, 0.0, "extend")
    n_total = n_frames + 2 * cf
    jsh = J.shrink_rings_from_fused(jext, n_total, cf, rot)
    tsh = T.shrink_rings_from_fused(text, n_total, cf, rot)
    assert_tree_close(tsh, jsh, 0.0, "shrink")


@pytest.mark.parametrize("kernel", [False, True], ids=["unfused", "kernel"])
@pytest.mark.parametrize("w", [1, 6])
def test_wave_iteration_matches_jax(models, kernel, w):
    """One CausalConditionalCFMWave iteration (fused, shared offset) with
    random rings and conv caches, p = 2 (align != 0), at a ramp-up
    iteration (w = 1) and one where the last slots drain (w = 6 of k = 5)."""
    m = models
    cfg, ring_t, hop = m["cfg"], 6, 3
    r, s_steps, d = cfg.token_mel_ratio, cfg.cfm.n_timesteps, cfg.output_size
    cf, base, k = hop * r, 2 * r, 5
    rp = ring_t * r + cf
    align = base % cf
    rot = [(s * cf) % rp for s in range(s_steps) for _ in range(2)]
    est = J.extend_rings_for_fused(
        J.est_cache_to_flat(_random_est(cfg, ring_t, 7)), base + 36, cf, rot)
    rng = np.random.RandomState(w)
    x_wave = rng.randn(s_steps, 1, cf, d).astype(np.float32)
    mu_wave = rng.randn(s_steps, 1, cf, d).astype(np.float32)
    mu_new = rng.randn(1, cf, d).astype(np.float32)
    spks = rng.randn(1, d).astype(np.float32)

    wave = J.KVFlowWaveStep(cfg, write_mode="dus", align=align, fused=True)
    jout = wave.apply(m["fparams"], x_wave, mu_wave, mu_new, spks, est,
                      jnp.asarray(w), jnp.asarray(k), jnp.asarray(base))

    dec = m["flow"].decoder

    def run(w, k, base):
        test = to_torch(est)
        with torch.inference_mode():
            args = (torch.from_numpy(x_wave), torch.from_numpy(mu_wave),
                    torch.from_numpy(mu_new), torch.from_numpy(spks))
            if kernel:
                gp = T.group_estimator_params(m["flow"], m["fused"])
                est_g = T.group_est_flat(test, dec.estimator.cfg)
                tout = T.wave_step_kernel(gp, dec, *args, est_g, w, k, base)
                test = T.ungroup_est_flat(est_g, dec.estimator.cfg)
            else:
                tout = T.wave_step(dec, m["fused"], *args, test, w, k, base)
        return tout, test

    tout, test = run(w, k, base)
    for got, want, what in zip(tout, jout[:3], ("exit", "x", "mu")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0, err_msg=what)
    assert_tree_close(test, jout[3], TOL, "est")
    dout, dtest = run(*(torch.tensor(v) for v in (w, k, base)))
    for got, want in zip(dout, tout):
        assert torch.equal(got, want)
    assert_tree_close(dtest, test, 0.0, "est, device scalars")


def test_encoder_hop_kernel_matches_jax(models):
    """Three steady hops from random rings after a 2-token prompt: hop 3,
    ring 6 (blocks group C 3, Rt 6) and the x4 upsample (up group C 12,
    Rt 24), so both groups see ramp-up, a full ring and a wrapping write.
    mu and every leaf of the enc cache after each hop."""
    m = models
    cfg, ring_t, hop, la = m["cfg"], 6, 3, m["cfg"].pre_lookahead_len
    rng = np.random.RandomState(11)
    jcache = jax.tree.map(lambda a: jnp.asarray(
        rng.randn(*a.shape).astype(np.float32)),
        J.init_kv_cache(cfg, ring_t)["enc"])
    tcache = to_torch(jcache)
    dcache = to_torch(jcache)           # the same hops with a device n_tok
    pe_tok, pe_mel = J.pe_tables(cfg, 64)
    tpe_tok, tpe_mel = T.pe_tables(tcfg.tiny_flow_config(), 64)
    egp = J.group_encoder_params(m["fparams"], cfg.encoder)
    tegp = T.group_encoder_params(m["flow"], m["fused"])
    stream = m["tokens"]
    for i, n_tok in enumerate((2, 5, 8)):
        chunk = stream[:, n_tok:n_tok + hop]
        ctx = stream[:, n_tok + hop:n_tok + hop + la]
        jmu, jcache = J.encoder_hop_pallas(
            egp, m["fparams"], cfg, jnp.asarray(chunk), jnp.asarray(ctx),
            jcache, n_tok, pe_tok, pe_mel, interpret=True)
        with torch.inference_mode():
            toks = (torch.from_numpy(chunk).long(),
                    torch.from_numpy(ctx).long())
            tmu, tcache = T.encoder_hop_kernel(
                tegp, m["flow"], *toks, tcache, n_tok, tpe_tok, tpe_mel)
            dmu, dcache = T.encoder_hop_kernel(
                tegp, m["flow"], *toks, dcache, torch.tensor(n_tok), tpe_tok,
                tpe_mel)
        assert torch.equal(dmu, tmu)
        assert_tree_close(dcache, tcache, 0.0, f"device n_tok, hop {i}")
        assert tmu.shape == (1, hop * cfg.token_mel_ratio, cfg.output_size)
        np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=TOL,
                                   rtol=0, err_msg=f"mu, hop {i}")
        assert_tree_close(tcache, jcache, TOL, f"enc, hop {i}")
