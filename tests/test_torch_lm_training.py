"""The port's speech-LM training (``training/lm.py``,
``Qwen2Model.forward_causal``) against the JAX package at the tiny LM
config, f32 on the CPU.  Mirrors ``tests/test_lm_training.py``: the packed
batch equal; the label-smoothing loss and accuracy within 1e-6; the cache-
free causal forward against JAX's ``forward_embeds`` on a fresh cache (what
JAX's ``lm_loss`` runs); ``lm_loss`` and its gradients, ``sequence_logp``
and ``dpo_loss`` within 1e-5; the CE step lowers the loss and the DPO step
widens the reward margin.  The JAX parameters carry across through
``weights.speech_lm_state_from_jax``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.llm.speech_lm import (
    Qwen2SpeechLM as JLM, tiny_speech_lm_config as j_cfg)
from moss_speech_decoder_cosy_tpu.training import lm as JL
from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
    Qwen2SpeechLM as TLM, tiny_speech_lm_config as t_cfg)
from moss_speech_decoder_cosy_torch.training import lm as TL
from moss_speech_decoder_cosy_torch.training.train_step import (
    AdamW, TrainState, constant_lr)
from moss_speech_decoder_cosy_torch.weights import speech_lm_state_from_jax

from test_torch_training import GRAD_NOISE, assert_close_to_peak

TOL = 1e-5
LS_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def lm():
    cfg = j_cfg()
    jm = JLM(cfg)
    params = _np(jax.jit(lambda k: jm.init(
        k, jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 0), jnp.int32),
        jax.random.PRNGKey(1), max_len=4))(jax.random.PRNGKey(0)))
    return cfg, jm, params


def _port(params) -> TLM:
    m = TLM(t_cfg())
    m.load_state_dict(speech_lm_state_from_jax(params), strict=True)
    return m


def _batch(cfg, seed, b=2, tt=5, ts=6, which=("speech",)):
    rng = np.random.RandomState(seed)
    out = {"text_token": rng.randint(0, 100, (b, tt)).astype(np.int32),
           "text_token_len": np.asarray([tt, tt - 2][:b], np.int32)}
    for w in which:
        out[f"{w}_token"] = rng.randint(0, cfg.speech_token_size,
                                        (b, ts)).astype(np.int32)
        out[f"{w}_token_len"] = np.asarray([ts, ts - 2][:b], np.int32)
    return out


def test_pack_lm_batch_matches_jax(lm):
    cfg, jm, params = lm
    b = _batch(cfg, 0)
    b["text_token_len"] = np.asarray([3, 5], np.int32)
    b["speech_token_len"] = np.asarray([6, 4], np.int32)
    args = [b[k] for k in ("text_token", "text_token_len", "speech_token",
                           "speech_token_len")]
    want = jax.jit(lambda p, *a: JL.pack_lm_batch(jm, p, *a))(params, *args)
    with torch.no_grad():
        got = TL.pack_lm_batch(_port(params), *(_t(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    t, msk = got[1].numpy(), got[2].numpy()
    eos = cfg.speech_token_size
    assert msk[0, 4:11].all() and not msk[0, :4].any() \
        and not msk[0, 11:].any()
    np.testing.assert_array_equal(t[0, 4:10], b["speech_token"][0, :6])
    assert t[0, 10] == eos and t[1, 10] == eos


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smoothing_loss_matches_jax(smoothing):
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 7, 11) * 3).astype(np.float32)
    targets = rng.randint(-1, 11, (2, 7)).astype(np.int32)
    mask = targets >= 0
    want = JL.label_smoothing_loss(jnp.asarray(logits), jnp.asarray(targets),
                                   jnp.asarray(mask), smoothing)
    got = TL.label_smoothing_loss(_t(logits), _t(targets).long(), _t(mask),
                                  smoothing)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=LS_TOL)


def test_label_smoothing_loss_perfect_prediction():
    targets = torch.tensor([[1, 2, 3]])
    mask = torch.ones((1, 3), dtype=torch.bool)
    logits = torch.nn.functional.one_hot(targets, 8).float() * 100.0
    loss, acc = TL.label_smoothing_loss(logits, targets, mask, 0.0)
    assert float(loss) < 1e-3 and float(acc) == 1.0
    loss_s, _ = TL.label_smoothing_loss(logits, targets, mask, 0.1)
    assert float(loss_s) > float(loss)


def test_forward_causal_matches_forward_embeds(lm):
    """The cache-free forward against JAX's ``forward_embeds`` on a fresh
    cache, and against the port's own cached forward."""
    cfg, jm, params = lm
    e = np.random.RandomState(2).randn(2, 9, cfg.backbone.hidden_size) \
        .astype(np.float32)

    def fwd(m, e):
        return m.llm.forward_embeds(e, m.llm.init_cache(e.shape[0]))[0]
    want = jax.jit(lambda p, e: jm.apply(p, e, method=fwd))(params, e)
    m = _port(params)
    with torch.no_grad():
        got = m.llm.forward_causal(_t(e))
        cached, _ = m.llm.forward_embeds(_t(e), m.llm.init_cache(2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), cached.numpy(), atol=TOL,
                               rtol=0)


def test_lm_loss_and_grads_match_jax(lm):
    cfg, jm, params = lm
    b = _batch(cfg, 3)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JL.lm_loss(jm, p, b, 0.1), has_aux=True))(params, b)
    m = _port(params)
    got, gm = TL.lm_loss(m, {k: _t(v) for k, v in b.items()}, 0.1)
    np.testing.assert_allclose(float(got), float(loss), rtol=TOL)
    np.testing.assert_allclose(float(gm["acc"]), float(metrics["acc"]),
                               rtol=TOL)
    got.backward()
    assert_close_to_peak({k: p.grad for k, p in m.named_parameters()},
                         speech_lm_state_from_jax(_np(grads)), TOL,
                         "lm grads", noise=GRAD_NOISE)


def test_sequence_logp_matches_jax(lm):
    cfg, jm, params = lm
    b = _batch(cfg, 4, tt=3, ts=4)
    want = jax.jit(lambda p, b: JL.sequence_logp(jm, p, b))(params, b)
    with torch.no_grad():
        got = TL.sequence_logp(_port(params),
                               {k: _t(v) for k, v in b.items()})
    assert got.shape == (2,) and (got.numpy() <= 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)


@pytest.mark.parametrize("ipo,smoothing", [(False, 0.0), (False, 0.2),
                                           (True, 0.0)],
                         ids=["sigmoid", "sigmoid_smoothed", "ipo"])
def test_dpo_loss_matches_jax(ipo, smoothing):
    rng = np.random.RandomState(5)
    args = [(rng.randn(4) * 3).astype(np.float32) for _ in range(4)]
    want = JL.dpo_loss(*(jnp.asarray(a) for a in args), beta=0.3,
                       label_smoothing=smoothing, ipo=ipo)
    got = TL.dpo_loss(*(_t(a) for a in args), beta=0.3,
                      label_smoothing=smoothing, ipo=ipo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL)


def test_dpo_loss_prefers_chosen():
    z = torch.zeros(1)
    better = TL.dpo_loss(z, z - 5, z, z, beta=1.0)[0]
    worse = TL.dpo_loss(z - 5, z, z, z, beta=1.0)[0]
    assert float(better) < float(worse)


def _adam_state(m, lr):
    """``optax.adam(lr)``: AdamW without weight decay or clip."""
    return TrainState(0, m, AdamW(m.parameters(), constant_lr(lr),
                                  weight_decay=0.0))


def test_lm_train_step_reduces_loss(lm):
    cfg, _, params = lm
    b = {k: _t(v) for k, v in _batch(cfg, 1, tt=4, ts=5).items()}
    state = _adam_state(_port(params), 1e-2)
    step = TL.make_lm_train_step()
    losses = []
    for _ in range(5):
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    assert state.step == 5 and losses[-1] < losses[0]
    assert 0.0 <= float(metrics["acc"]) <= 1.0


def test_dpo_train_step_improves_margin(lm):
    """The chosen / rejected reward margin grows over a few steps on a
    fixed pair (the policy moves toward the chosen completion)."""
    cfg, _, params = lm
    b = {k: _t(v) for k, v in _batch(cfg, 2, tt=4, ts=5,
                                      which=("chosen", "rejected")).items()}
    ref = _port(params).requires_grad_(False)
    state = _adam_state(_port(params), 5e-3)
    step = TL.make_dpo_train_step(ref, beta=0.5)
    margins = []
    for _ in range(5):
        state, metrics = step(state, b)
        margins.append(float(metrics["reward_margin"]))
    assert np.isfinite(margins).all() and margins[-1] > margins[0]
    assert float(metrics["reward_acc"]) >= 0.5
