"""The port's GAN training (``training/gan.py``, ``ops/convs.Conv2d``,
``HiFTGenerator.forward_train``) and VQ codebook training
(``training/vq.py``) against the JAX package, f32 on the CPU.  Mirrors
``tests/test_gan_vq.py``.  The JAX parameters carry across through
``weights.discriminator_state_from_jax`` / ``hift_state_from_jax``, and
the port is fed JAX's own random draws (the NSF source's, the dead-code
restart's candidates).  Tolerances: Conv2d, the discriminators and the
GAN losses 1e-5 of each output's peak; the train steps' gradients 1e-4 of
each parameter's peak (``test_torch_training.assert_grads_close``) and
their parameters as ``test_torch_training.assert_params_close``; the VQ
state 1e-6."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator as JHiFT
from moss_speech_decoder_cosy_tpu.ops import convs as JCV
from moss_speech_decoder_cosy_tpu.ops.melspec import (
    matcha_mel_spectrogram as j_mel)
from moss_speech_decoder_cosy_tpu.tokenizer import (
    WhisperVQEncoder as JEnc, tiny_tokenizer_config as j_tok_cfg)
from moss_speech_decoder_cosy_tpu.training import gan as JG
from moss_speech_decoder_cosy_tpu.training import vq as JQ
from moss_speech_decoder_cosy_tpu.utils.config import tiny_hift_config
from moss_speech_decoder_cosy_torch.models.hift import HiFTGenerator as THiFT
from moss_speech_decoder_cosy_torch.ops import convs as TCV
from moss_speech_decoder_cosy_torch.ops.melspec import (
    matcha_mel_spectrogram as t_mel)
from moss_speech_decoder_cosy_torch.tokenizer import config as TK
from moss_speech_decoder_cosy_torch.tokenizer.model import WhisperVQEncoder
from moss_speech_decoder_cosy_torch.training import gan as TG
from moss_speech_decoder_cosy_torch.training import vq as TQ
from moss_speech_decoder_cosy_torch.training.train_step import (
    AdamW, constant_lr, global_norm)
from moss_speech_decoder_cosy_torch.utils import config as TC
from moss_speech_decoder_cosy_torch.weights import (
    discriminator_state_from_jax, hift_state_from_jax,
    tokenizer_state_from_jax)

from test_torch_training import (
    assert_grads_close, assert_params_close, capture_grads, captured,
    noise_floor, port_grads)

TOL = 1e-5
VQ_TOL = 1e-6


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


def close(got, want, rel=TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * peak, (what, err, peak)


# -------------------------------------------------------------------- Conv2d
@pytest.mark.parametrize("weight_norm", [False, True],
                         ids=["plain", "weight_norm"])
def test_conv2d_matches_jax(weight_norm):
    """Forward and the gradients of the input and every parameter, with
    a stride and padding on both axes; the converter maps HWIO to OIHW."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 11, 9, 3).astype(np.float32)
    w = rng.randn(2, 6, 10, 5).astype(np.float32)    # the output cotangent
    jm = JCV.Conv2d(5, (3, 4), (2, 1), (1, 2), weight_norm=weight_norm)
    params = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    params = jax.tree.map(lambda a: a + 0.1, params)  # a nonzero bias

    def f(p, x):
        return jnp.sum(jm.apply(p, x) * w)
    out = jm.apply(params, jnp.asarray(x))
    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    tm = TCV.Conv2d(3, 5, (3, 4), (2, 1), (1, 2), weight_norm=weight_norm)
    tm.load_state_dict(discriminator_state_from_jax(params), strict=True)
    xt = _t(x).requires_grad_(True)
    y = tm(xt)
    close(y, out, what="forward")
    (y * _t(w)).sum().backward()
    close(xt.grad, gx, what="input grad")
    want = discriminator_state_from_jax(_np(gp))
    for k, p in tm.named_parameters():
        close(p.grad, want[k], what=k)


# ------------------------------------------------------------ discriminators
@pytest.fixture(scope="module")
def disc():
    rng = np.random.RandomState(0)
    y = (rng.randn(2, 4096) * 0.3).astype(np.float32)
    yh = (rng.randn(2, 4096) * 0.3).astype(np.float32)
    jd = JG.MultipleDiscriminator()
    params = _np(jax.jit(jd.init)(jax.random.PRNGKey(0), y, yh))
    want = _np(jax.jit(jd.apply)(params, y, yh))
    td = TG.MultipleDiscriminator()
    td.load_state_dict(discriminator_state_from_jax(params), strict=True)
    return y, yh, params, want, td


def test_discriminators_match_jax(disc):
    """MPD ++ MRD: every output and feature map (5 + 3 discriminators; an
    odd length exercises the period padding)."""
    y, yh, _, want, td = disc
    with torch.no_grad():
        got = td(_t(y), _t(yh))
    r, g, fr, fg = want
    assert len(got[0]) == len(got[1]) == 5 + 3
    for i, (a, b) in enumerate(zip(got[0] + got[1], r + g)):
        close(a, b, what=f"output {i}")
    for i, (fa, fb) in enumerate(zip(got[2] + got[3], fr + fg)):
        assert len(fa) == len(fb)
        for j, (a, b) in enumerate(zip(fa, fb)):
            close(a, b, what=f"fmap {i}.{j}")


def test_period_padding_matches_jax():
    rng = np.random.RandomState(3)
    y = (rng.randn(1, 101) * 0.3).astype(np.float32)
    jd = JG.DiscriminatorP(3, channels=(4, 8))
    params = _np(jax.jit(jd.init)(jax.random.PRNGKey(2), y))
    want, _ = jax.jit(jd.apply)(params, y)
    td = TG.DiscriminatorP(3, channels=(4, 8))
    td.load_state_dict(discriminator_state_from_jax(params), strict=True)
    with torch.no_grad():
        got, _ = td(_t(y))
    close(got, want, what="period 3 of 101 samples")


def test_gan_losses_match_jax(disc):
    """The five losses on the discriminators' outputs (an even element
    count, where the TPR median is the mean of the middle two), the mel
    L1 through each package's matcha mel."""
    y, yh, _, (r, g, fr, fg), _ = disc
    tr, tg = [_t(a) for a in r], [_t(a) for a in g]
    tfr = [[_t(a) for a in f] for f in fr]
    tfg = [[_t(a) for a in f] for f in fg]
    want = jax.jit(lambda r, g, fr, fg, y, yh: (
        JG.generator_loss(g), JG.discriminator_loss(r, g),
        JG.feature_loss(fr, fg), JG.tpr_loss(r, g, 0.04),
        JG.tpr_loss(r, g, 10.0),
        JG.mel_l1_loss(y, yh, [j_mel])))(r, g, fr, fg, y, yh)
    got = (TG.generator_loss(tg), TG.discriminator_loss(tr, tg),
           TG.feature_loss(tfr, tfg), TG.tpr_loss(tr, tg, 0.04),
           TG.tpr_loss(tr, tg, 10.0),
           TG.mel_l1_loss(_t(y), _t(yh), [t_mel]))
    for name, a, b in zip(("gen", "disc", "fm", "tpr", "tpr_10", "mel_l1"),
                          got, want):
        close(a, b, what=name)
    assert any(a.size % 2 == 0 for a in r)


def test_spectrogram_of_audio_shorter_than_the_window():
    """384 samples through the fft-2048 discriminator's spectrogram: the
    centre padding (1024) reflects more than once, as numpy's does."""
    x = (np.random.RandomState(5).randn(2, 384) * 0.3).astype(np.float32)
    jd = JG.DiscriminatorR(2048)
    want = jax.jit(lambda x: jd._spectrogram(x))(x)
    got = TG.DiscriminatorR(2048).spectrogram(_t(x))
    close(got, want, what="spectrogram")


def jax_nsf_draws(key, harmonics, length):
    """The JAX source's draws under ``key`` (``m_source(s, key)``)."""
    k_ini, k_noise = jax.random.split(key)
    return (_t(jax.random.uniform(k_ini, (1, harmonics), jnp.float32)),
            _t(jax.random.normal(k_noise, (1, length, harmonics),
                                 jnp.float32)))


def test_forward_train_matches_jax():
    cfg = tiny_hift_config()
    jm = JHiFT(cfg)
    mel = np.random.RandomState(4).randn(2, 10, cfg.in_channels).astype(
        np.float32)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(mel)))
    key = jax.random.PRNGKey(5)
    wav, f0 = jax.jit(lambda p, m: jm.apply(p, m, key,
                                            method=jm.forward_train))(
        params, mel)
    tm = THiFT(TC.tiny_hift_config())
    tm.load_state_dict(hift_state_from_jax(params), strict=True)
    with torch.no_grad():
        got_wav, got_f0 = tm.forward_train(_t(mel), jax_nsf_draws(
            key, cfg.nb_harmonics + 1, 10 * cfg.total_upsample))
    close(got_f0, f0, what="f0")
    close(got_wav, wav, rel=1e-4, what="wav")


def test_gan_train_steps_match_jax():
    """One discriminator turn and one generator turn at the tiny HiFT
    (the NSF draws fed) against JAX's: each turn's gradient against the
    one JAX's step took (``jax.grad`` of its objective), then both
    modules' parameters after.  The generator's turn runs on JAX's
    discriminator after its turn, so both gradients are taken on the same
    inputs.  The discriminator is one resolution discriminator (fft 512):
    the steps' code is the same for any, and MPD's 1024-channel convs
    would cost this file a minute."""
    cfg = tiny_hift_config()
    genm = JHiFT(cfg)
    t_mel_len = 8
    gp = _np(jax.jit(genm.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, t_mel_len, cfg.in_channels))))
    jd = JG.MultiResolutionDiscriminator(fft_sizes=(512,))
    wav_len = t_mel_len * cfg.total_upsample
    dp = _np(jax.jit(jd.init)(jax.random.PRNGKey(1), jnp.zeros((1, wav_len)),
                              jnp.zeros((1, wav_len))))
    lr = 1e-4
    gen_tx, disc_tx = capture_grads(optax.adam(lr)), \
        capture_grads(optax.adam(lr))

    def toy_mel(w, np_=jnp):
        return w.reshape(w.shape[0], -1, 16).mean(-1)
    disc_step, gen_step = JG.make_gan_train_step(genm, jd, [toy_mel],
                                                 gen_tx, disc_tx)
    state = JG.GanTrainState(step=jnp.zeros((), jnp.int32), gen_params=gp,
                             disc_params=dp, gen_opt=gen_tx.init(gp),
                             disc_opt=disc_tx.init(dp))
    rng = np.random.RandomState(2)
    batch = {
        "speech": (rng.randn(1, wav_len) * .3).astype(np.float32),
        "speech_feat": rng.randn(1, t_mel_len, cfg.in_channels).astype(
            np.float32),
        "pitch_feat": (np.abs(rng.randn(1, t_mel_len)) * 100).astype(
            np.float32)}
    k1, k2 = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    state, dm = disc_step(state, batch, k1)
    disc_params = discriminator_state_from_jax(_np(state.disc_params))
    disc_grads = discriminator_state_from_jax(captured(state.disc_opt))
    state, gm = gen_step(state, batch, k2)
    gen_grads = hift_state_from_jax(captured(state.gen_opt))

    gen = THiFT(TC.tiny_hift_config())
    gen.load_state_dict(hift_state_from_jax(gp), strict=True)
    d = TG.MultiResolutionDiscriminator(fft_sizes=(512,))
    d.load_state_dict(discriminator_state_from_jax(dp), strict=True)

    def adam(m):
        return AdamW(m.parameters(), constant_lr(lr), weight_decay=0.0)
    ts = TG.GanTrainState(0, gen, d, adam(gen), adam(d))
    tdisc, tgen = TG.make_gan_train_step([lambda w: w.reshape(
        w.shape[0], -1, 16).mean(-1)])
    tb = {k: _t(v) for k, v in batch.items()}
    h = cfg.nb_harmonics + 1
    ts, tdm = tdisc(ts, tb, jax_nsf_draws(k1, h, wav_len))
    np.testing.assert_allclose(float(tdm["loss_disc"]),
                               float(dm["loss_disc"]), rtol=TOL)
    assert_grads_close(port_grads(d), disc_grads, "discriminator grads")
    assert_params_close(d, disc_params, noise_floor(disc_grads, {}), [lr],
                        "discriminator")
    d.load_state_dict(disc_params, strict=True)
    ts, tgm = tgen(ts, tb, jax_nsf_draws(k2, h, wav_len))
    assert ts.step == 1
    for k in ("loss", "loss_gen", "loss_fm", "loss_mel", "loss_f0"):
        np.testing.assert_allclose(float(tgm[k]), float(gm[k]), rtol=TOL,
                                   err_msg=k)
    assert_grads_close(port_grads(gen), gen_grads, "generator grads")
    assert_params_close(gen, hift_state_from_jax(_np(state.gen_params)),
                        noise_floor(gen_grads, {}), [lr], "generator")


# ------------------------------------------------------------------------ VQ
def _vq_inputs(cfg, seed=0, b=2, t=16):
    rng = np.random.RandomState(seed)
    codebook = rng.randn(cfg.quantize_vocab_size, cfg.d_model).astype(
        np.float32)
    hidden = rng.randn(b, t, cfg.d_model).astype(np.float32)
    valid = np.ones((b, t), bool)
    valid[1, t - 5:] = False
    return codebook, hidden, valid


def test_vq_config_fields_equal_jax():
    for f in ("quantize_ema_decay", "quantize_commit_coefficient",
              "quantize_loss_scale", "quantize_restart_interval"):
        assert getattr(TK.tiny_tokenizer_config(), f) == \
            getattr(j_tok_cfg(), f), f
        assert getattr(TK.glm4_voice_tokenizer_config(), f) == \
            getattr(type(j_tok_cfg())(), f), f


def test_quantize_and_commit_loss_match_jax():
    cfg = j_tok_cfg()
    codebook, hidden, valid = _vq_inputs(cfg)
    jq, jids = JQ.quantize(jnp.asarray(hidden), jnp.asarray(codebook))
    tq, tids = TQ.quantize(_t(hidden), _t(codebook))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    close(tq, jq, rel=VQ_TOL, what="quantized")
    jl = JQ.commit_loss(jnp.asarray(hidden), jq, jnp.asarray(valid), cfg)
    tl = TQ.commit_loss(_t(hidden), tq, _t(valid), TK.tiny_tokenizer_config())
    np.testing.assert_allclose(float(tl), float(jl), rtol=VQ_TOL)


def test_straight_through_gradient_is_identity():
    cfg = TK.tiny_tokenizer_config()
    codebook, hidden, _ = _vq_inputs(cfg, seed=1)
    h = _t(hidden).requires_grad_(True)
    q, _ = TQ.quantize(h.detach(), _t(codebook))
    st = TQ.straight_through(h, q)
    assert torch.allclose(st, q, atol=1e-6)
    w = torch.randn(st.shape, generator=torch.Generator().manual_seed(0))
    (st * w).sum().backward()
    assert torch.equal(h.grad, w)


def _state_close(t_state, j_state, what):
    for f in ("codebook", "ema_count", "ema_weight"):
        close(getattr(t_state, f), getattr(j_state, f), rel=VQ_TOL,
              what=f"{what} {f}")
    assert t_state.steps == int(j_state.steps)


def test_ema_update_and_restart_match_jax():
    """Two EMA steps at restart interval 2: the first plain, the second
    restarts the dead codes from JAX's candidate rows (its categorical
    draw over the valid positions, fed).  Half the codes start with an EMA
    count of 0.01, so they are dead by the restart."""
    jcfg = dataclasses.replace(j_tok_cfg(), quantize_restart_interval=2)
    tcfg = dataclasses.replace(TK.tiny_tokenizer_config(),
                               quantize_restart_interval=2)
    codebook, hidden, valid = _vq_inputs(jcfg, seed=2)
    jh, jv = jnp.asarray(hidden), jnp.asarray(valid)
    _, jids = JQ.quantize(jh, jnp.asarray(codebook))
    v = jcfg.quantize_vocab_size
    count = np.where(np.arange(v) < v // 2, 1.0, 0.01).astype(np.float32)
    js = JQ.init_vq_state(jnp.asarray(codebook)).replace(
        ema_count=jnp.asarray(count))
    ts = TQ.init_vq_state(_t(codebook))
    ts.ema_count = _t(count)
    keys = [jax.random.PRNGKey(0), jax.random.PRNGKey(1)]
    for i, key in enumerate(keys):
        js = JQ.ema_update(js, jh, jids, jv, jcfg, rng=key)
        mask = jnp.asarray(valid.reshape(-1), jnp.float32)
        probs = mask / jnp.maximum(jnp.sum(mask), 1.0)
        cand = jax.random.categorical(key, jnp.log(probs + 1e-20)[None, :],
                                      shape=(jcfg.quantize_vocab_size,))
        ts = TQ.ema_update(ts, _t(hidden), _t(jids), _t(valid), tcfg,
                           candidates=_t(cand))
        _state_close(ts, js, f"step {i + 1}")
    low = torch.arange(v) >= v // 2
    dead = low & (ts.ema_count == 1.0)
    assert int(dead.sum()) >= v // 4
    flat = hidden.reshape(-1, hidden.shape[-1])
    rows = {tuple(r) for r in flat[valid.reshape(-1)]}
    assert all(tuple(r) in rows for r in ts.codebook[dead].numpy())
    # a generator's candidates come from valid rows too
    gs = TQ.init_vq_state(_t(codebook))
    gs.ema_count = _t(count)
    gs = TQ.ema_update(gs, _t(hidden), _t(jids), _t(valid), tcfg)
    gs = TQ.ema_update(gs, _t(hidden), _t(jids), _t(valid), tcfg,
                       generator=torch.Generator().manual_seed(0))
    gdead = low & (gs.ema_count == 1.0)
    assert int(gdead.sum()) >= v // 4
    assert all(tuple(r) in rows for r in gs.codebook[gdead].numpy())


def test_tokenizer_vq_training_roundtrip():
    """``encode_train`` + commit loss + EMA update (mirrors the JAX
    test): the gradient flows through the straight-through estimator into
    the encoder, and the EMA codebook moves; the hidden states and ids
    equal JAX's."""
    cfg = j_tok_cfg()
    m = JEnc(cfg)
    rng = np.random.RandomState(0)
    mel = rng.randn(2, 16, cfg.num_mel_bins).astype(np.float32)
    valid = np.ones((2, 16), bool)
    params = _np(jax.jit(m.init)(jax.random.PRNGKey(0), jnp.asarray(mel),
                                 jnp.asarray(valid)))
    jstate = JQ.init_vq_state(jnp.asarray(params["params"]["codebook"]))
    jh, _, jids, jtv = jax.jit(lambda p, x, v, c: m.apply(
        p, x, v, c, method=m.encode_train))(params, jnp.asarray(mel),
                                            jnp.asarray(valid),
                                            jstate.codebook)
    tcfg = TK.tiny_tokenizer_config()
    enc = WhisperVQEncoder(tcfg)
    enc.load_state_dict(tokenizer_state_from_jax(params), strict=True)
    state = TQ.init_vq_state(enc.codebook)
    hidden, q_st, ids, tv = enc.encode_train(_t(mel), _t(valid),
                                             state.codebook)
    close(hidden, jh, rel=1e-5, what="hidden")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jtv))
    loss = torch.mean(q_st ** 2) + TQ.commit_loss(
        hidden, state.codebook[ids], tv, tcfg)
    loss.backward()
    assert np.isfinite(float(loss))
    assert float(global_norm([p.grad for p in enc.parameters()
                              if p.grad is not None])) > 0
    new = TQ.ema_update(state, hidden, ids, tv, tcfg)
    assert not torch.allclose(new.codebook, state.codebook)
