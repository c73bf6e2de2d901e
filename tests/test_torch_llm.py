"""The port's speech LM stack (``models/llm``, ``serving/lm_server.py``)
against the JAX package, f32 on the CPU, tiny configs, the same weights
(``*_state_from_jax``):

- Qwen2 prefill hidden states and K/V against JAX ``forward_embeds``
  (1e-4); the port's stepwise decode against its prefill (1e-5);
- ``prefill_slot`` + ``decode_step_slots`` (staggered slots, some held
  back by ``advance``), single-tier and two-tier with flushes, against
  JAX step by step (1e-4);
- the RAS pick fed JAX's own Gumbel noise (``jax.random.categorical`` is
  ``argmax(gumbel + logits)``) token-equal to JAX ``ras_sample`` over 240
  draws, with repetition fallbacks and min-length-masked ties;
- ``generate`` and ``BistreamSession`` fed the noise of JAX's key chains
  token-equal to JAX's (so the phase schedule, fills, eos and pending
  embeddings agree), the session's KV cache within 1e-4 of JAX's after
  the same tokens (teacher forcing); ``generate`` honours ``min_len``;
- ``TransformerLM`` (v1): ``encode_text`` and teacher-forced logits within
  1e-4 of JAX, and its generation with JAX's noise token-equal;
- ``ContinuousBatcher`` equal to the port's ``generate`` token for token
  (counter-based noise), under staggered admission, in any slot, with
  ``recent`` off and on.

Torch runs on one thread here, as in the other port test modules."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.llm import qwen2 as JQ
from moss_speech_decoder_cosy_tpu.models.llm import speech_lm as JS
from moss_speech_decoder_cosy_torch.models.llm import qwen2 as TQ
from moss_speech_decoder_cosy_torch.models.llm import speech_lm as TS
from moss_speech_decoder_cosy_torch.serving.lm_server import (
    ContinuousBatcher)
from moss_speech_decoder_cosy_torch.weights import (
    qwen2_state_from_jax, speech_lm_state_from_jax)

ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _module(cls, cfg, state):
    return TS.load_lm(cls, cfg, state, device="cpu")


@pytest.fixture(scope="module")
def lm():
    """(JAX model, params, port model) of the tiny speech LM."""
    cfg = JS.tiny_speech_lm_config()
    jm = JS.Qwen2SpeechLM(cfg)
    text = jnp.zeros((1, 4), jnp.int32)
    ps = jnp.zeros((1, 0), jnp.int32)
    params = _np(jm.init(jax.random.PRNGKey(0), text, ps,
                         jax.random.PRNGKey(1), max_len=4))
    tm = _module(TS.Qwen2SpeechLM, TS.tiny_speech_lm_config(),
                 speech_lm_state_from_jax(params))
    return jm, params, tm


@functools.partial(jax.jit, static_argnums=(1, 2))
def chain_noise(key, n, v):
    """The Gumbel noise of draws 0..n-1 of a JAX key chain as the JAX
    generate, batcher and bistream phases split it: draw 0 from
    ``split(key)[1]``, draw j from the j-th split of the chain after; each
    draw's (k1, k2) = split as ``ras_sample`` does.  (n, 2, v)."""
    key, k0 = jax.random.split(key)

    def body(key, _):
        key, ks = jax.random.split(key)
        return key, ks
    _, ks = jax.lax.scan(body, key, None, length=n - 1)
    keys = jnp.concatenate([k0[None], ks])

    def draw(kd):
        k1, k2 = jax.random.split(kd)
        return jnp.stack([jax.random.gumbel(k1, (v,), jnp.float32),
                          jax.random.gumbel(k2, (v,), jnp.float32)])
    return jax.vmap(draw)(keys)


def table_noise(tables):
    """A port noise function reading ``tables[seed][idx]`` (a sequence or a
    dict of (2, v) draws); zeros for a draw the table lacks (a masked step
    the JAX loop never runs)."""
    tables = {s: dict(enumerate(t)) if not isinstance(t, dict) else t
              for s, t in tables.items()}

    def noise(seeds, idx, n):
        return torch.stack([torch.tensor(np.array(
            tables[s].get(i, np.zeros((2, n), np.float32))))[:, :n]
            for s, i in zip(seeds.tolist(), idx.tolist())])
    return noise


# ------------------------------------------------------------------ qwen2
def test_qwen2_prefill_and_kv_match_jax():
    cfg = JQ.tiny_qwen2_config()
    jm = JQ.Qwen2Model(cfg)
    emb = np.random.RandomState(0).randn(2, 12, cfg.hidden_size).astype(
        np.float32)

    def prefill(mdl, e):
        return mdl.forward_embeds(e, mdl.init_cache(2))
    params = _np(jm.init(jax.random.PRNGKey(0), emb, method=prefill))
    h_j, cache_j = jm.apply(params, emb, method=prefill)
    tm = _module(TQ.Qwen2Model, TQ.tiny_qwen2_config(),
                 qwen2_state_from_jax(params))
    with torch.inference_mode():
        h_t, cache_t = tm.forward_embeds(_t(emb), tm.init_cache(2))
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)
        for got, want in ((cache_t.k, cache_j.k), (cache_t.v, cache_j.v)):
            np.testing.assert_allclose(got[..., :12, :].numpy(),
                                       np.asarray(want)[..., :12, :],
                                       atol=ATOL)
        assert int(cache_t.length) == int(cache_j.length) == 12
        # stepwise against the prefill (the port alone)
        cache = tm.init_cache(2)
        steps = [tm.forward_embeds(_t(emb[:, i:i + 1]), cache)[0]
                 for i in range(12)]
        np.testing.assert_allclose(torch.cat(steps, 1).numpy(),
                                   h_t.numpy(), atol=1e-5)
        np.testing.assert_allclose(cache.k.numpy(), cache_t.k.numpy(),
                                   atol=1e-5)


def test_rope_matches_jax():
    rng = np.random.RandomState(8)
    x = rng.randn(2, 3, 5, 8).astype(np.float32)
    pos = rng.randint(0, 4000, 5)
    pos_b = rng.randint(0, 4000, (2, 5))
    np.testing.assert_allclose(
        TQ._rope(_t(x), _t(pos), 1e6).numpy(),
        np.asarray(JQ._rope(x, pos, 1e6)), atol=1e-5)
    np.testing.assert_allclose(
        TQ._rope_b(_t(x), _t(pos_b), 1e6).numpy(),
        np.asarray(JQ._rope_b(x, pos_b, 1e6)), atol=1e-5)


@pytest.mark.parametrize("recent", [0, 6])
def test_slot_prefill_and_decode_match_jax(recent):
    cfg = JQ.tiny_qwen2_config()
    jm = JQ.Qwen2Model(cfg)
    rng = np.random.RandomState(1)
    d = cfg.hidden_size
    emb = rng.randn(1, 8, d).astype(np.float32)

    def prefill(mdl, e):
        return mdl.forward_embeds(e, mdl.init_cache(1))
    params = _np(jm.init(jax.random.PRNGKey(2), emb, method=prefill))
    tm = _module(TQ.Qwen2Model, TQ.tiny_qwen2_config(),
                 qwen2_state_from_jax(params))

    cj = jm.apply(params, 3, method=lambda m, b: m.init_slot_cache(
        b, recent=recent))
    prefill_j = jax.jit(lambda p, c, s, e, n: jm.apply(
        p, c, s, e, n, method=jm.prefill_slot))
    step_j = jax.jit(lambda p, e, c, a: jm.apply(
        p, e, c, a, method=jm.decode_step_slots))
    flush_j = jax.jit(lambda p, c: jm.apply(p, c, method=jm.flush_slots))
    with torch.inference_mode():
        ct = tm.init_slot_cache(3, recent=recent)
        since = 0
        for t in range(7):
            if t in (0, 2):                   # staggered admission
                slot, n = (1, 5) if t == 0 else (0, 7)
                e = rng.randn(1, 8, d).astype(np.float32)   # bucket 8
                hj, cj = prefill_j(params, cj, jnp.asarray(slot), e,
                                   jnp.asarray(n))
                ht, _ = tm.prefill_slot(ct, slot, _t(e), n)
                np.testing.assert_allclose(ht.numpy(), np.asarray(hj),
                                           atol=ATOL)
            if recent and since >= recent - 2:
                cj = flush_j(params, cj)
                tm.flush_slots(ct)
                since = 0
            e = rng.randn(3, 1, d).astype(np.float32)
            adv = np.array([t % 3 != 2, True, t != 4])
            hj, cj = step_j(params, e, cj, jnp.asarray(adv))
            ht, _ = tm.decode_step_slots(_t(e), ct, torch.from_numpy(adv))
            since += 1
            rows = [1] if t < 2 else [0, 1]   # slot 2 never admitted
            np.testing.assert_allclose(ht.numpy()[rows],
                                       np.asarray(hj)[rows], atol=ATOL)
            np.testing.assert_array_equal(ct.lengths.numpy(),
                                          np.asarray(cj.lengths))
        if recent:
            cj = flush_j(params, cj)
            tm.flush_slots(ct)
        for slot in (0, 1):
            n = int(ct.lengths[slot])
            np.testing.assert_allclose(ct.k[:, slot, :, :n].numpy(),
                                       np.asarray(cj.k)[:, slot, :, :n],
                                       atol=ATOL)
            np.testing.assert_allclose(ct.v[:, slot, :, :n].numpy(),
                                       np.asarray(cj.v)[:, slot, :, :n],
                                       atol=ATOL)


# --------------------------------------------------------------- sampling
def test_ras_pick_matches_jax_with_its_noise():
    cfg = JS.tiny_speech_lm_config()
    tcfg = TS.tiny_speech_lm_config()
    v = cfg.speech_token_size + 3
    rng = np.random.RandomState(3)
    ras_j = jax.jit(lambda k, lp, h: JS.ras_sample(k, lp, h, cfg))
    n_fallback = n_masked = 0
    for i in range(240):
        logp = np.log(np.asarray(jax.nn.softmax(
            rng.randn(v).astype(np.float32) * (1 + i % 4))))
        if i % 3 == 0:                       # min-length mask: ties at 0
            logp[cfg.speech_token_size:] = -1e10
            n_masked += 1
        top = int(np.argmax(logp))
        hist = rng.randint(0, v, cfg.win_size)
        if i % 2 == 0:                       # repeats of the likely token
            hist[: 1 + i % cfg.win_size] = top
        key = jax.random.PRNGKey(i)
        k1, k2 = jax.random.split(key)
        noise = np.stack([jax.random.gumbel(k1, (v,), jnp.float32),
                          jax.random.gumbel(k2, (v,), jnp.float32)])
        want = int(ras_j(key, jnp.asarray(logp), jnp.asarray(hist)))
        got = int(TS.ras_pick(_t(logp)[None], _t(hist).long()[None],
                              _t(noise)[None], tcfg)[0])
        assert got == want, (i, got, want)
        n_fallback += int((hist == want).sum() >= 1 and want != top)
    assert n_masked >= 80 and n_fallback > 0


def test_lm_loads_on_the_card_unless_told_cpu(lm):
    _, params, tm = lm
    state = speech_lm_state_from_jax(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.load_lm(TS.Qwen2SpeechLM, tm.cfg, state)
    got = TS.load_lm(TS.Qwen2SpeechLM, tm.cfg, state, device="cpu",
                     dtype=torch.bfloat16)
    assert not got.training and got.device.type == "cpu"
    assert got.llm_decoder.weight.dtype == torch.bfloat16


def test_counter_noise_is_a_function_of_seed_and_draw():
    seeds = torch.tensor([7, 7, 8])
    idx = torch.tensor([3, 3, 3])
    g = TS.counter_gumbel(seeds, idx, 500)
    assert g.shape == (3, 2, 500) and torch.isfinite(g).all()
    assert torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert not torch.equal(g[0, 0], g[0, 1])
    again = TS.counter_gumbel(torch.tensor([8]), torch.tensor([3]), 500)
    assert torch.equal(again[0], g[2])
    # Gumbel(0, 1): mean ~0.577, variance ~pi^2 / 6
    big = TS.counter_gumbel(torch.arange(64), torch.zeros(64).long(), 4096)
    assert abs(float(big.mean()) - 0.5772) < 0.02
    assert abs(float(big.var()) - np.pi ** 2 / 6) < 0.05


# --------------------------------------------------------------- generate
def test_generate_matches_jax_with_its_noise(lm):
    jm, params, tm = lm
    cfg = jm.cfg
    v = cfg.speech_token_size + 3
    text = np.random.RandomState(4).randint(0, 100, (1, 6))
    ps = np.zeros((1, 0), np.int32)
    embeds = jm.apply(params, jnp.asarray(text), jnp.asarray(ps),
                      method=jm.prompt_embeds)
    for seed, min_len in ((5, 0), (6, 10)):
        key = jax.random.PRNGKey(seed)
        toks_j, n_j = jm.apply(params, embeds, key, jnp.asarray(min_len),
                               16, method=jm.generate)
        tm.noise = table_noise({seed: np.asarray(chain_noise(key, 16, v))})
        try:
            e = tm.prompt_embeds(text, ps)
            np.testing.assert_allclose(e.detach().numpy(),
                                       np.asarray(embeds), atol=1e-6)
            toks_t, n_t = tm.generate(e, seed, min_len, 16)
        finally:
            tm.noise = TS.counter_gumbel
        assert n_t == int(n_j) and n_t >= min_len
        np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))


def test_generate_honours_min_len(lm):
    _, _, tm = lm
    text = np.random.RandomState(5).randint(0, 100, (1, 4))
    e = tm.prompt_embeds(text, np.zeros((1, 0), np.int64))
    eos = tm.cfg.speech_token_size
    for seed in range(4):
        free, n_free = tm.generate(e, seed, 0, 12)
        toks, n = tm.generate(e, seed, 9, 12)
        assert n >= 9
        assert (toks[:n] < eos).all() and (toks[n:] == eos).all()
        if n_free < 9:                       # eos came early, then masked
            assert n > n_free
    toks, n = tm(text, np.zeros((1, 0), np.int64), seed=1, max_len=12)
    assert n >= int(4 * tm.cfg.min_token_text_ratio)


def test_generate_shares_one_state_across_max_len(lm):
    """Every ``max_len`` decodes on the same state, token buffer and graph
    runner (a server passing its clients' ``max_len`` allocates nothing
    more); a shorter cap gives the longer run's first tokens."""
    _, _, tm = lm
    text = np.random.RandomState(6).randint(0, 100, (1, 4))
    e = tm.prompt_embeds(text, np.zeros((1, 0), np.int64))
    long, n_long = tm.generate(e, 2, 20, 20)
    gen = tm._generator()
    for cap in (7, 13, 20):
        toks, n = tm.generate(e, 2, cap, cap)
        assert toks.shape == (cap,) and n == cap
        assert torch.equal(toks, long[:cap])
        assert tm._generator() is gen and tm.graphs() is gen[2]
    assert n_long == 20 and gen[1].shape == (tm.cfg.backbone.max_seq_len,)


def test_bistream_session_matches_jax_with_its_noise(lm):
    jm, params, tm = lm
    v = jm.cfg.speech_token_size + 3
    key = jax.random.PRNGKey(9)
    js = JS.BistreamSession(jm, params, key)
    want = js.push_text(list(range(17))) + js.flush(n_final=24)
    # the phase keys of the JAX session: one split of its key a phase
    tables, k = {}, key
    for c in range(5):
        k, kc = jax.random.split(k)
        for j, g in enumerate(np.asarray(chain_noise(kc, 24, v))):
            tables[(c << 16) + j] = g
    tm.noise = table_noise({0: tables})
    try:
        ts = TS.BistreamSession(tm, seed=0)
        got = ts.push_text(list(range(17))) + ts.flush(n_final=24)
    finally:
        tm.noise = TS.counter_gumbel
    assert [len(c) for c in got] == [len(c) for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    n = int(js.cache.length)
    assert int(ts.cache.length) == n
    np.testing.assert_allclose(ts.cache.k[..., :n, :].numpy(),
                               np.asarray(js.cache.k)[..., :n, :],
                               atol=ATOL)
    assert (js._pending_emb is None) == (ts._pending_emb is None)


# ----------------------------------------------------------------- batcher
@pytest.mark.parametrize("recent", [0, 20])
def test_batcher_equals_generate(lm, recent):
    _, _, tm = lm
    rng = np.random.RandomState(6)
    reqs = [dict(text=rng.randint(0, 100, n), seed=s, max_len=m)
            for n, s, m in ((5, 11, 14), (3, 12, 9), (7, 13, 20), (4, 14, 6),
                            (6, 15, 17))]
    want = []
    for r in reqs:
        toks, n = tm(r["text"][None], np.zeros((1, 0), np.int64),
                     seed=r["seed"], max_len=r["max_len"])
        want.append(list(toks[:n].numpy()))
    b = ContinuousBatcher(tm, slots=3, step_chunk=4,
                          text_buckets=(4, 8), recent=recent)
    ids = {}
    pending = list(range(len(reqs)))
    for it in range(200):
        # admit one request a step while a slot is free (staggered)
        if pending:
            r = reqs[pending[0]]
            got = b.submit(r["text"], seed=r["seed"], max_len=r["max_len"])
            if got is not None:
                ids[pending.pop(0)] = got
        b.step()
        if not pending and all(b.finished(q) for q in ids.values()):
            break
    assert not pending
    for i, q in ids.items():
        assert b.result(q) == want[i], (i, b.result(q), want[i])
    with pytest.raises(ValueError):
        b.submit(np.zeros(9, np.int64))


# ---------------------------------------------------------- TransformerLM
def test_transformer_lm_matches_jax():
    from moss_speech_decoder_cosy_tpu.models.llm import transformer_lm as JT
    from moss_speech_decoder_cosy_torch.models.llm import transformer_lm as TT
    from moss_speech_decoder_cosy_torch.weights import (
        transformer_lm_state_from_jax)
    cfg = JT.tiny_transformer_lm_config()
    tcfg = TT.tiny_transformer_lm_config()
    jm = JT.TransformerLM(cfg)
    rng = np.random.RandomState(7)
    text = rng.randint(0, cfg.text_token_size, (2, 5))
    text_valid = np.array([[1] * 5, [1] * 3 + [0] * 2], bool)
    speech = rng.randint(0, cfg.speech_token_size + 1, (2, 7))
    speech_valid = np.array([[1] * 7, [1] * 4 + [0] * 3], bool)
    spk = rng.randn(2, tcfg.spk_embed_dim).astype(np.float32)
    params = _np(jm.init(jax.random.PRNGKey(0), text, text_valid, speech,
                         speech_valid, spk))
    tm = _module(TT.TransformerLM, tcfg,
                 transformer_lm_state_from_jax(params))
    with torch.inference_mode():
        enc_j = jm.apply(params, text, text_valid, method=jm.encode_text)
        enc_t = tm.encode_text(_t(text).long(), _t(text_valid))
        np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j),
                                   atol=ATOL)
        for s in (None, spk):
            lj, vj = jm.apply(params, text, text_valid, speech, speech_valid,
                              s)
            lt, vt = tm(_t(text).long(), _t(text_valid), _t(speech).long(),
                        _t(speech_valid), None if s is None else _t(s))
            np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                       atol=ATOL)
    # generation: JAX splits its key once a step, draw j from the j-th
    v = cfg.speech_token_size + 1
    gen_j = jax.jit(lambda p, k: jm.apply(p, text[:1], text_valid[:1], k, 10,
                                          method=jm.generate))
    for seed in (1, 2):
        key = jax.random.PRNGKey(seed)
        toks_j, n_j = gen_j(params, key)
        keys, k = [], key
        for _ in range(10):
            k, ks = jax.random.split(k)
            keys.append(ks)
        table = [np.stack([jax.random.gumbel(k1, (v,), jnp.float32),
                           jax.random.gumbel(k2, (v,), jnp.float32)])
                 for k1, k2 in (jax.random.split(kd) for kd in keys)]
        tm.noise = table_noise({seed: table})
        toks_t, n_t = tm.generate(_t(text[:1]).long(), _t(text_valid[:1]),
                                  seed, 10)
        assert n_t == int(n_j)
        np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
