"""The port's Whisper ASR head and the tokenizer's training forward
(``tokenizer/asr_decoder.py``, ``WhisperVQEncoder.encode_train``) against
the JAX package at the tiny tokenizer config: the same seeded numpy inputs,
the JAX parameters carried across.  Mirrors ``tests/test_tokenizer.py``'s
ASR tests.  The JAX references are computed once for the module; torch
runs on one thread here, as in the other port test modules."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.tokenizer import asr_decoder as JA
from moss_speech_decoder_cosy_tpu.tokenizer import model as JT
from moss_speech_decoder_cosy_tpu.tokenizer import tiny_tokenizer_config
from moss_speech_decoder_cosy_torch.models.llm.speech_lm import load_lm
from moss_speech_decoder_cosy_torch.tokenizer import asr_decoder as TA
from moss_speech_decoder_cosy_torch.tokenizer import config as TC
from moss_speech_decoder_cosy_torch.tokenizer.model import WhisperVQEncoder
from moss_speech_decoder_cosy_torch.weights import (
    audio_classifier_state_from_jax, post_vq_state_from_jax,
    tokenizer_state_from_jax, whisper_decoder_state_from_jax)

ATOL = 1e-5
GRAD_ATOL = 1e-4
BOS, EOS, MAX_LEN = 1, 2, 8
LADDER = (0.0, 0.5, 1.0)           # a shorter fallback ladder: fewer compiles


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    return torch.from_numpy(np.asarray(a)) if dtype is None else \
        torch.from_numpy(np.asarray(a)).to(dtype)


def _load(cls, state, *args):
    return load_lm(lambda _: cls(*args), None, state, "cpu")


def test_port_config_equals_jax():
    """Every field the port reads equals JAX's, in the tiny and the full
    config (the port keeps no field that nothing of it reads)."""
    pairs = [(TC.tiny_tokenizer_config(), tiny_tokenizer_config()),
             (TC.glm4_voice_tokenizer_config(),
              type(tiny_tokenizer_config())())]
    for tc, jc in pairs:
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name


@pytest.fixture(scope="module")
def head():
    """The tiny decoder (JAX params and the port module), seeded encoder
    states for two rows, and the JAX decodes over them."""
    cfg = tiny_tokenizer_config()
    rng = np.random.RandomState(3)
    enc = rng.randn(2, 6, cfg.d_model).astype(np.float32)
    ev = np.ones((2, 6), bool)
    ev[1, 4:] = False
    jdec = JA.WhisperVQDecoder(cfg)
    params = _np(jax.jit(jdec.init)(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32),
                           jnp.ones((2, 8), bool), enc, ev))
    tdec = _load(TA.WhisperVQDecoder, whisper_decoder_state_from_jax(params),
                 TC.tiny_tokenizer_config())
    ts_begin = cfg.vocab_size - 16
    ref = {}
    ref["sample0"] = _np(jax.jit(lambda e, v: JA.sample_decode(
        jdec, params, e, v, BOS, EOS, jax.random.PRNGKey(0),
        temperature=0.0, max_len=MAX_LEN))(enc, ev))
    ref["sample07"] = _np(jax.jit(lambda e, v: JA.sample_decode(
        jdec, params, e, v, BOS, EOS, jax.random.PRNGKey(4),
        temperature=0.7, max_len=MAX_LEN))(enc, ev))
    for k in (1, 4):
        ref[f"beam{k}"] = _np(jax.jit(lambda e, v, k=k: JA.beam_decode(
            jdec, params, e, v, BOS, EOS, beam_size=k, max_len=MAX_LEN,
            length_penalty=0.0))(enc, ev))
    ref["beam4_lp1"] = _np(jax.jit(lambda e, v: JA.beam_decode(
        jdec, params, e, v, BOS, EOS, beam_size=4, max_len=MAX_LEN))(enc, ev))
    ref["ts"] = _np(jax.jit(lambda e, v: JA.timestamp_decode(
        jdec, params, e, v, BOS, EOS, timestamp_begin=ts_begin,
        max_initial_timestamp_index=3, max_len=12))(enc, ev))
    return dict(cfg=cfg, enc=enc, ev=ev, jdec=jdec, params=params,
                tdec=tdec, ts_begin=ts_begin, ref=ref)


def gumbel_table(key, steps: int, rows: int, v: int):
    """JAX ``sample_decode``'s Gumbel draws under ``key``: (steps, rows,
    v), step j from the j-th of ``split(key, steps)``."""
    keys = jax.random.split(key, steps)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (rows, v), jnp.float32))(keys))


def jax_noise(tables):
    """A ``counter_gumbel`` stand-in reading JAX's draws: ``tables[seed]``
    maps a draw index to (rows, v) noise; row r reads its own row."""
    def noise(seeds, idx, n):
        rows = [tables[int(s)][int(i)][r] for r, (s, i) in enumerate(
            zip(seeds.tolist(), idx.tolist()))]
        out = torch.from_numpy(np.stack(rows)[:, :n].astype(np.float32))
        return torch.stack([out, out], dim=1)
    return noise


# ------------------------------------------------------------- modules
@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "block_causal"])
def test_post_vq_states_match_jax(causal):
    cfg = dataclasses.replace(tiny_tokenizer_config(), causal_attention=causal,
                              quantize_causal_block_size=8)
    rng = np.random.RandomState(1)
    q = rng.randn(2, 7, cfg.d_model).astype(np.float32)
    tv = np.ones((2, 7), bool)
    tv[1, 5:] = False
    jm = JA.PostVQEncoder(cfg)
    p = _np(jax.jit(jm.init)(jax.random.PRNGKey(1), q, tv))
    want = np.asarray(jm.apply(p, q, tv))
    tm = _load(TA.PostVQEncoder, post_vq_state_from_jax(p),
               dataclasses.replace(TC.tiny_tokenizer_config(),
                                   causal_attention=causal,
                                   quantize_causal_block_size=8))
    with torch.no_grad():
        got = tm(_t(q), _t(tv)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_decoder_logits_and_cross_attention_match_jax(head):
    jdec, params, tdec = head["jdec"], head["params"], head["tdec"]
    rng = np.random.RandomState(2)
    toks = rng.randint(0, head["cfg"].vocab_size, (2, 8)).astype(np.int32)
    tv = np.ones((2, 8), bool)
    tv[0, 6:] = False
    want, want_a = jdec.apply(params, toks, tv, head["enc"], head["ev"],
                              return_cross_attn=True)
    with torch.no_grad():
        got, got_a = tdec(_t(toks, torch.long), _t(tv), _t(head["enc"]),
                          _t(head["ev"]), return_cross_attn=True)
        last = tdec(_t(toks, torch.long), _t(tv), _t(head["enc"]),
                    _t(head["ev"]), last=torch.tensor([5, 7]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert got_a.shape == (2, 2, 2, 8, 6)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=ATOL)
    np.testing.assert_allclose(got_a.sum(-1).numpy(), 1.0, atol=ATOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[[0, 1], [5, 7]],
                               atol=ATOL)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["mean_pool", "weighted_layer_sum"])
def test_audio_classifier_matches_jax(weighted):
    cfg = tiny_tokenizer_config()
    rng = np.random.RandomState(0)
    shape = (2, 3, 12, cfg.d_model) if weighted else (2, 12, cfg.d_model)
    states = rng.randn(*shape).astype(np.float32)
    valid = np.ones((2, 12), bool)
    valid[1, 5:] = False
    jm = JA.WhisperAudioClassifier(cfg, num_labels=5, classifier_proj_size=16,
                                   use_weighted_layer_sum=weighted)
    p = _np(jax.jit(jm.init)(jax.random.PRNGKey(1), states))
    if weighted:                               # a non-uniform layer mix
        p["params"]["layer_weights"] = np.asarray([0.3, -0.2, 0.5],
                                                  np.float32)
    tm = _load(TA.WhisperAudioClassifier, audio_classifier_state_from_jax(p),
               TC.tiny_tokenizer_config(), 5, 16, weighted, 3)
    with torch.no_grad():
        for v in (None, valid):
            want = np.asarray(jm.apply(p, states, v))
            got = tm(_t(states), None if v is None else _t(v)).numpy()
            np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.fixture(scope="module")
def train_setup():
    """Tiny tokenizer, post-VQ encoder and decoder with JAX params, a
    seeded mel and transcript, and JAX's loss and gradients through
    ``encode_train`` (w.r.t. the codebook passed in and every parameter)
    and through the ASR's token path (``codebook[ids]``)."""
    cfg = tiny_tokenizer_config()
    rng = np.random.RandomState(0)
    mel = rng.randn(2, 32, cfg.num_mel_bins).astype(np.float32)
    valid = np.ones((2, 32), bool)
    valid[1, 24:] = False
    text = rng.randint(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    text_valid = np.ones((2, 6), bool)
    text_valid[1, 4:] = False
    jt, jp, jd = JT.WhisperVQEncoder(cfg), JA.PostVQEncoder(cfg), \
        JA.WhisperVQDecoder(cfg)
    tp = _np(jax.jit(jt.init)(jax.random.PRNGKey(0), mel, valid))
    codebook = rng.randn(cfg.quantize_vocab_size, cfg.d_model).astype(
        np.float32) * 0.3
    q0 = np.zeros((2, 4, cfg.d_model), np.float32)
    pp = _np(jax.jit(jp.init)(jax.random.PRNGKey(1), q0, np.ones((2, 4), bool)))
    dp = _np(jax.jit(jd.init)(jax.random.PRNGKey(2), text, text_valid, q0,
                     np.ones((2, 4), bool)))

    def loss_train(tp, pp, dp, cb):
        _, q_st, _, tv = jt.apply(tp, mel, valid, cb, method=jt.encode_train)
        enc = jp.apply(pp, q_st, tv)
        logits = jd.apply(dp, text, text_valid, enc, tv)
        return JA.asr_ce_loss(logits[:, :-1], text[:, 1:], text_valid[:, 1:])

    ids = rng.randint(0, cfg.quantize_vocab_size, (2, 5))
    ids_valid = np.ones((2, 5), bool)
    ids_valid[0, 4:] = False

    def loss_tokens(pp, dp, cb):
        q = cb[ids] * ids_valid[..., None]
        enc = jp.apply(pp, q, ids_valid)
        logits = jd.apply(dp, text, text_valid, enc, ids_valid)
        return JA.asr_ce_loss(logits[:, :-1], text[:, 1:], text_valid[:, 1:])

    outs = _np(jax.jit(lambda p, cb: jt.apply(
        p, mel, valid, cb, method=jt.encode_train))(tp, codebook))
    lt, gt = jax.jit(jax.value_and_grad(loss_train, argnums=(0, 1, 2, 3)))(
        tp, pp, dp, codebook)
    lk, gk = jax.jit(jax.value_and_grad(loss_tokens, argnums=(0, 1, 2)))(
        pp, dp, codebook)
    return dict(cfg=cfg, mel=mel, valid=valid, text=text,
                text_valid=text_valid, codebook=codebook, ids=ids,
                ids_valid=ids_valid, tp=tp, pp=pp, dp=dp, outs=outs,
                loss_train=float(lt), grads_train=_np(gt),
                loss_tokens=float(lk), grads_tokens=_np(gk))


def _port_modules(s):
    tcfg = TC.tiny_tokenizer_config()
    mods = []
    for cls, state in ((WhisperVQEncoder, tokenizer_state_from_jax(s["tp"])),
                       (TA.PostVQEncoder, post_vq_state_from_jax(s["pp"])),
                       (TA.WhisperVQDecoder,
                        whisper_decoder_state_from_jax(s["dp"]))):
        m = cls(tcfg)
        m.load_state_dict(state, strict=True)
        mods.append(m)
    return mods


def _assert_grads(module, grads, from_jax):
    want = from_jax(grads)
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        g = torch.zeros_like(want[k]) if got[k] is None else got[k]
        np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                   atol=GRAD_ATOL, err_msg=k)


def test_encode_train_matches_jax(train_setup):
    s = train_setup
    tok, _, _ = _port_modules(s)
    with torch.no_grad():
        got = tok.encode_train(_t(s["mel"]), _t(s["valid"]),
                               _t(s["codebook"]))
    hidden, q_st, ids, tv = s["outs"]
    np.testing.assert_allclose(got[0].numpy(), hidden, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), q_st, atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), ids)
    np.testing.assert_array_equal(got[3].numpy(), tv)
    # the straight-through output is the codebook row itself
    np.testing.assert_allclose(got[1].numpy(), s["codebook"][ids], atol=ATOL)


def test_ce_loss_gradients_through_encode_train_match_jax(train_setup):
    """asr_ce_loss through ``encode_train`` -> ``PostVQEncoder`` -> the
    decoder: the loss at 1e-5, and the gradients w.r.t. the codebook passed
    in (zero: the straight-through estimator stops it) and every
    parameter of the three modules against ``jax.grad`` at 1e-4."""
    s = train_setup
    tok, post, dec = _port_modules(s)
    cb = _t(s["codebook"]).requires_grad_(True)
    _, q_st, _, tv = tok.encode_train(_t(s["mel"]), _t(s["valid"]), cb)
    text = _t(s["text"], torch.long)
    tvalid = _t(s["text_valid"])
    logits = dec(text, tvalid, post(q_st, tv), tv)
    loss = TA.asr_ce_loss(logits[:, :-1], text[:, 1:], tvalid[:, 1:])
    loss.backward()
    assert abs(loss.item() - s["loss_train"]) <= ATOL
    g_tok, g_post, g_dec, g_cb = s["grads_train"]
    np.testing.assert_allclose(
        np.zeros_like(g_cb) if cb.grad is None else cb.grad.numpy(), g_cb,
        atol=GRAD_ATOL)
    _assert_grads(tok, g_tok, tokenizer_state_from_jax)
    _assert_grads(post, g_post, post_vq_state_from_jax)
    _assert_grads(dec, g_dec, whisper_decoder_state_from_jax)


def test_ce_loss_gradients_through_the_codebook_match_jax(train_setup):
    """The ASR's token path: ``codebook[ids]`` -> ``PostVQEncoder`` -> the
    decoder; the codebook's gradient (nonzero here) and the parameters'
    against ``jax.grad`` at 1e-4."""
    s = train_setup
    _, post, dec = _port_modules(s)
    cb = _t(s["codebook"]).requires_grad_(True)
    iv = _t(s["ids_valid"])
    q = cb[_t(s["ids"], torch.long)] * iv[..., None].float()
    text = _t(s["text"], torch.long)
    tvalid = _t(s["text_valid"])
    logits = dec(text, tvalid, post(q, iv), iv)
    loss = TA.asr_ce_loss(logits[:, :-1], text[:, 1:], tvalid[:, 1:])
    loss.backward()
    assert abs(loss.item() - s["loss_tokens"]) <= ATOL
    g_post, g_dec, g_cb = s["grads_tokens"]
    assert np.abs(g_cb).max() > 0
    np.testing.assert_allclose(cb.grad.numpy(), g_cb, atol=GRAD_ATOL)
    _assert_grads(post, g_post, post_vq_state_from_jax)
    _assert_grads(dec, g_dec, whisper_decoder_state_from_jax)


def test_ce_loss_matches_jax():
    rng = np.random.RandomState(9)
    logits = rng.randn(2, 5, 11).astype(np.float32) * 3
    labels = rng.randint(-1, 11, (2, 5))
    valid = rng.rand(2, 5) > 0.3
    want = float(JA.asr_ce_loss(logits, labels, valid))
    got = float(TA.asr_ce_loss(_t(logits), _t(labels, torch.long),
                               _t(valid)))
    assert abs(got - want) <= ATOL
    assert float(TA.asr_ce_loss(_t(logits), _t(labels, torch.long),
                                torch.zeros(2, 5, dtype=torch.bool))) == 0.0


# ------------------------------------------------------------- decodes
def _enc(head):
    return _t(head["enc"]), _t(head["ev"])


def test_greedy_decode_matches_jax(head):
    toks, n = TA.greedy_decode(head["tdec"], *_enc(head), BOS, EOS,
                               max_len=MAX_LEN)
    # JAX's greedy_decode is its sample_decode at temperature 0
    want_t, want_n, _ = head["ref"]["sample0"]
    np.testing.assert_array_equal(toks.numpy(), want_t)
    np.testing.assert_array_equal(n.numpy(), want_n)
    assert (toks[:, 0] == BOS).all()


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_sample_decode_matches_jax(head, temperature, monkeypatch):
    """Temperature 0 is greedy with the summed log-probs; at 0.7 the port
    is fed JAX's Gumbel draws (its own are counter-based) and picks JAX's
    tokens with JAX's log-probs."""
    if temperature > 0:
        v = head["cfg"].vocab_size
        table = gumbel_table(jax.random.PRNGKey(4), MAX_LEN - 1, 2, v)
        monkeypatch.setattr(TA, "counter_gumbel",
                            jax_noise({5: dict(enumerate(table))}))
    toks, n, lp = TA.sample_decode(head["tdec"], *_enc(head), BOS, EOS,
                                   seed=5, temperature=temperature,
                                   max_len=MAX_LEN)
    want_t, want_n, want_lp = head["ref"][
        "sample0" if temperature == 0 else "sample07"]
    np.testing.assert_array_equal(toks.numpy(), want_t)
    np.testing.assert_array_equal(n.numpy(), want_n)
    np.testing.assert_allclose(lp.numpy(), want_lp, atol=ATOL)
    assert (lp.numpy() <= 0).all()


def test_sampling_noise_is_keyed_by_seed_and_draw(head):
    """The port's own draws: the same (seed, draw) gives the same tokens,
    eager or not; another seed moves them; a sample's summed log-prob is
    that of its own tokens."""
    enc = _enc(head)
    steps = TA.DecodeSteps(head["tdec"], MAX_LEN, graphs=False)
    a = steps.sample(*enc, BOS, EOS, temperature=1.0, seed=3)
    b = TA.sample_decode(head["tdec"], *enc, BOS, EOS, seed=3,
                         temperature=1.0, max_len=MAX_LEN)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    others = [steps.sample(*enc, BOS, EOS, temperature=1.0, seed=s)[0]
              for s in range(4, 8)]
    assert any(not torch.equal(o, a[0]) for o in others)
    toks, n, lp = a
    with torch.no_grad():
        tv = torch.arange(MAX_LEN)[None] < n[:, None]
        logp = torch.log_softmax(head["tdec"](toks, tv, *enc), -1)
    for r in range(2):
        # the picks up to and with eos, or all max_len - 1 without one
        nr = int(n[r])
        m = nr if nr < MAX_LEN and int(toks[r, nr]) == EOS else nr - 1
        want = sum(float(logp[r, j - 1, toks[r, j]]) for j in range(1, m + 1))
        assert abs(float(lp[r]) - want) <= 1e-4


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_decode_matches_jax(head, beam):
    toks, n, score = TA.beam_decode(head["tdec"], *_enc(head), BOS, EOS,
                                    beam_size=beam, max_len=MAX_LEN,
                                    length_penalty=0.0)
    want_t, want_n, want_s = head["ref"][f"beam{beam}"]
    np.testing.assert_array_equal(toks.numpy(), want_t)
    np.testing.assert_array_equal(n.numpy(), want_n)
    np.testing.assert_allclose(score.numpy(), want_s, atol=ATOL)
    if beam == 1:                                 # beam 1 is greedy
        np.testing.assert_array_equal(toks.numpy(), head["ref"]["sample0"][0])
    else:                                         # a wider beam never loses
        assert (score.numpy() >= head["ref"]["beam1"][2] - ATOL).all()
        toks, n, score = TA.beam_decode(head["tdec"], *_enc(head), BOS, EOS,
                                        beam_size=4, max_len=MAX_LEN)
        want_t, want_n, want_s = head["ref"]["beam4_lp1"]
        np.testing.assert_array_equal(toks.numpy(), want_t)
        np.testing.assert_allclose(score.numpy(), want_s, atol=ATOL)


def test_timestamp_decode_matches_jax(head):
    ts = head["ts_begin"]
    toks, n = TA.timestamp_decode(head["tdec"], *_enc(head), BOS, EOS,
                                  timestamp_begin=ts,
                                  max_initial_timestamp_index=3, max_len=12)
    want_t, want_n = head["ref"]["ts"]
    np.testing.assert_array_equal(toks.numpy(), want_t)
    np.testing.assert_array_equal(n.numpy(), want_n)
    for b in range(2):
        seq = toks[b, 1:n[b]].numpy()
        seq = seq[seq != EOS]
        if seq.size:
            assert ts <= seq[0] <= ts + 3
            assert np.all(np.diff(seq[seq >= ts]) >= 0)


def test_decode_steps_reuse_buffers_across_calls(head):
    """One ``DecodeSteps`` serves every call of a shape: a second decode of
    other inputs on the same buffers equals a fresh decode."""
    steps = TA.DecodeSteps(head["tdec"], MAX_LEN)
    enc, ev = _enc(head)
    steps.sample(enc, ev, BOS, EOS)
    steps.beam(enc, ev, BOS, EOS, 4)
    enc2 = enc.flip(0).contiguous()
    ev2 = ev.flip(0).contiguous()
    for got, want in ((steps.sample(enc2, ev2, BOS, EOS),
                       TA.sample_decode(head["tdec"], enc2, ev2, BOS, EOS,
                                        max_len=MAX_LEN)),
                      (steps.beam(enc2, ev2, BOS, EOS, 4),
                       TA.beam_decode(head["tdec"], enc2, ev2, BOS, EOS,
                                      max_len=MAX_LEN))):
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert len(steps._bufs) == 2


# --------------------------------------------------------- host helpers
def test_host_helpers_equal_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 17).astype(np.float32)
    for w in (1, 3, 7):
        np.testing.assert_array_equal(TA.median_filter(x, w),
                                      JA.median_filter(x, w))
    with pytest.raises(ValueError):
        TA.median_filter(x, 4)
    m = rng.rand(6, 11)
    for got, want in zip(TA.dynamic_time_warping(m),
                         JA.dynamic_time_warping(m)):
        np.testing.assert_array_equal(got, want)
    for ids in (np.zeros(64, np.int32), np.arange(64, dtype=np.int32),
                rng.randint(0, 5, 40), []):
        assert TA.compression_ratio(ids) == JA.compression_ratio(ids)
    assert TA.compression_ratio(np.zeros(64, np.int32)) > \
        TA.compression_ratio(np.arange(64, dtype=np.int32))
    ts = 100
    seq = np.asarray([1, ts + 0, 7, 8, ts + 5, ts + 5, 9, ts + 8, 11])
    got = TA.extract_timestamp_segments(seq, len(seq), ts, 0.02, 1.0)
    want = JA.extract_timestamp_segments(seq, len(seq), ts, 0.02, 1.0)
    assert len(got) == len(want) == 3             # the last one unclosed
    for (s0, e0, t0), (s1, e1, t1) in zip(got, want):
        assert (s0, e0) == (s1, e1) and t0.tolist() == t1.tolist()
    attn = rng.rand(2, 2, 2, 5, 9).astype(np.float32)
    heads = [(0, 0), (1, 1)]
    for npos in (None, 7, [7, 7], [6, 9]):
        np.testing.assert_array_equal(
            TA.extract_token_timestamps(attn, heads, 3, 0.08, npos),
            JA.extract_token_timestamps(attn, heads, 3, 0.08, npos))


# ------------------------------------------------------------ long form
@pytest.fixture(scope="module")
def asr_pair():
    """JAX and port ``WhisperASR`` over the same tiny weights (segments of
    6 tokens, max_len 8), and 14 seeded tokens (3 segments)."""
    cfg = tiny_tokenizer_config()
    rng = np.random.RandomState(5)
    codebook = rng.randn(cfg.quantize_vocab_size, cfg.d_model).astype(
        np.float32)
    seg_t = 6
    z = jnp.zeros((1, seg_t, cfg.d_model))
    tv0 = jnp.ones((1, seg_t), bool)
    pp = _np(jax.jit(JA.PostVQEncoder(cfg).init)(jax.random.PRNGKey(0), z, tv0))
    dp = _np(jax.jit(JA.WhisperVQDecoder(cfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), z, tv0))
    kw = dict(bos_id=BOS, eos_id=EOS, max_len=MAX_LEN, segment_tokens=seg_t,
              timestamp_begin=cfg.vocab_size - 16,
              alignment_heads=[(0, 0), (1, 1)])
    jasr = JA.WhisperASR(cfg, pp, dp, codebook, **kw)
    tasr = TA.WhisperASR(TC.tiny_tokenizer_config(),
                         post_vq_state_from_jax(pp),
                         whisper_decoder_state_from_jax(dp), codebook,
                         device="cpu", **kw)
    ids = rng.randint(0, cfg.quantize_vocab_size, (1, 14)).astype(np.int32)
    return jasr, tasr, ids


def ladder_noise(key, segments, rungs, v):
    """JAX ``transcribe``'s Gumbel draws as the port's seeds and draws index
    them: segment s is seed s, rung r's step j draw ``(r << 16) + j``."""
    tables = {}
    for s in range(segments):
        rk = key
        table = {}
        for r in range(rungs):
            for j, g in enumerate(gumbel_table(rk, MAX_LEN - 1, 1, v)):
                table[(r << 16) + j] = g
            rk, _ = jax.random.split(rk)
        tables[s] = table
        key, _ = jax.random.split(key)
    return jax_noise(tables)


@pytest.mark.parametrize("mode", ["ladder", "beam", "timestamps",
                                  "word_timestamps"])
def test_transcribe_equals_jax(asr_pair, mode, monkeypatch):
    """Each segment's transcript equal to JAX's: the greedy -> sampling
    ladder (the port fed JAX's draws; these random weights fail the
    log-prob gate, so the ladder climbs), beam 4, the timestamp grammar's
    segments and times, the DTW word times (1e-5) over the ladder's
    tokens."""
    jasr, tasr, ids = asr_pair
    monkeypatch.setattr(TA, "counter_gumbel", ladder_noise(
        jax.random.PRNGKey(0), 3, len(LADDER), tasr.cfg.vocab_size))
    if mode == "ladder":
        got, want = (tasr.transcribe(ids, temperatures=LADDER),
                     jasr.transcribe(ids, temperatures=LADDER))
    elif mode == "beam":
        # the JAX transcriber runs 4 beams whatever beam_size > 1 says
        got, want = (tasr.transcribe(ids, beam_size=4),
                     jasr.transcribe(ids, beam_size=4))
    elif mode == "timestamps":
        got, want = (tasr.transcribe(ids, return_timestamps=True),
                     jasr.transcribe(ids, return_timestamps=True))
        assert len(got) == len(want)
        for (s0, e0, t0), (s1, e1, t1) in zip(got, want):
            assert abs(s0 - s1) < 1e-9 and abs(e0 - e1) < 1e-9
            assert t0.tolist() == t1.tolist()
        return
    else:
        got, want = (tasr.transcribe(ids, word_timestamps=True,
                                     temperatures=LADDER),
                     jasr.transcribe(ids, word_timestamps=True,
                                     temperatures=LADDER))
        assert len(got) == len(want) == 3
        for (gt, gs), (wt, ws) in zip(got, want):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_allclose(gs, ws, atol=ATOL)
            assert gs.dtype == np.float32
        return
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_segment_states_match_jax(asr_pair):
    jasr, tasr, ids = asr_pair
    want_e, want_v = jasr._segment_states(jnp.asarray(ids))
    got_e, got_v = tasr.encode_segments(ids)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=ATOL)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
