"""The port's flow training (``training/train_step.py``, the flow and
v-diffusion losses, the encoder's dropout) against the JAX package at the
tiny configs, f32 on the CPU; and the autograd guard on the three CUDA
entries.  Mirrors ``tests/test_training.py``.

The port draws from ``torch.Generator``s; here it is fed JAX's own draws,
reproduced by splitting the same keys as the JAX losses split them.  The
JAX references are computed once for the module; torch runs on one thread,
as in the other port test modules.  Tolerances: losses 1e-5 relative;
each parameter's gradient and each parameter after three train steps
within 1e-4 / 1e-5 of its peak (``assert_grads_close``,
``assert_params_close`` say where f32 noise is held otherwise); the
schedules 1e-7 relative; the optimizer 1e-6."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from moss_speech_decoder_cosy_tpu.models.flow import vdiff as JV
from moss_speech_decoder_cosy_tpu.models.flow import dit as JD
from moss_speech_decoder_cosy_tpu.training import train_step as JT
from moss_speech_decoder_cosy_tpu.utils import config as JC
from moss_speech_decoder_cosy_torch.models.flow import (
    CausalMaskedDiffWithXvec as TFlow)
from moss_speech_decoder_cosy_torch.models.flow import dit as TD
from moss_speech_decoder_cosy_torch.models.flow import vdiff as TV
from moss_speech_decoder_cosy_torch.models.flow.cfm import CFMDraws
from moss_speech_decoder_cosy_torch.models.flow.flow import FlowLossDraws
from moss_speech_decoder_cosy_torch.ops import flash_attention as fa
from moss_speech_decoder_cosy_torch.ops import fused_block as fb
from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
from moss_speech_decoder_cosy_torch.ops.dropout import Dropout
from moss_speech_decoder_cosy_torch.training import train_step as TT
from moss_speech_decoder_cosy_torch.utils import config as TC
from moss_speech_decoder_cosy_torch.weights import (
    flow_state_from_jax, gradtts_state_from_jax)

from test_torch_flow_v1 import N_MEL, SPK, tiny_v1_config

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4          # of each parameter's gradient peak
PARAM_REL = 1e-5         # of each parameter's peak after the steps
SCHED_RTOL = 1e-7
OPT_ATOL = 1e-6
PEAK_LR, WARMUP, CLIP = 1e-2, 2, 1.0


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


# a gradient zero in exact arithmetic (the key projections' biases: the
# softmax ignores them) is f32 noise in both packages: such entries are held
# within this share of the largest gradient of the model
GRAD_NOISE = 1e-7


def assert_close_to_peak(got: dict, want: dict, rel: float, what: str,
                         noise: float = 0.0):
    """Every entry of ``want`` within ``rel`` of its own peak in ``got``
    (plus ``noise`` x the largest peak of all)."""
    assert set(got) == set(want), what
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].detach().numpy()
        peak = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= rel * peak + noise * top, (what, k, err, peak)


def assert_grads_close(got: dict, want: dict, what: str):
    assert_close_to_peak(got, want, GRAD_REL, what, noise=GRAD_NOISE)


def assert_params_close(model, want: dict, floor: dict, lrs, what: str):
    """The parameters after train steps within ``PARAM_REL`` of each peak,
    plus ``GRAD_REL`` of the summed rates (Adam divides each gradient by
    its own RMS, so gradients within ``GRAD_REL`` give updates within about
    that share of the rate), except the elements ``floor`` marks: JAX's
    gradient there was within the gradient tolerance of 0 at some step,
    where that division turns the two packages' f32 noise into updates of
    the order of the rate.  Those are held within 4 x the summed rates;
    the ones whose JAX gradient was not exactly 0 may be at most 5% of the
    elements (3.3% of the tiny HiFT's after one step).  An element where
    the port's gradient is 0 and JAX's is not small is outside the floor,
    so a dropped gradient path fails the tight bound."""
    got = dict(model.named_parameters())
    assert set(got) == set(want), what
    n_floor = n_all = 0
    for k, w in want.items():
        w = np.asarray(w)
        d = np.abs(got[k].detach().numpy() - w)
        m, nonzero = floor[k]
        n_floor += int(nonzero.sum())
        n_all += m.size
        assert float(np.where(m, 0.0, d).max()) <= \
            PARAM_REL * float(np.abs(w).max()) + GRAD_REL * sum(lrs), \
            (what, k)
        assert float(np.where(m, d, 0.0).max()) <= 4 * sum(lrs), (what, k)
    assert n_floor <= 0.05 * n_all, (what, n_floor, n_all)


def noise_floor(grads: dict, floor: dict) -> dict:
    """``floor`` updated with the elements whose gradient in ``grads``
    (JAX's, under the port's names) is within the gradient tolerance of 0:
    a pair of masks, all of them and those not exactly 0."""
    grads = {k: np.abs(np.asarray(g)) for k, g in grads.items()}
    top = max(float(g.max()) for g in grads.values())
    out = {}
    for k, g in grads.items():
        m = g <= GRAD_REL * float(g.max()) + GRAD_NOISE * top
        nz = m & (g > 0)
        out[k] = (m | floor[k][0], nz | floor[k][1]) if k in floor \
            else (m, nz)
    return out


def capture_grads(tx):
    """``tx`` behind a transformation that keeps the gradients it is given
    in its state: after a JAX step, ``captured(opt_state)`` is that step's
    gradient (the mean over microbatches, before the clip)."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, tx)


def captured(opt_state):
    return jax.tree.map(np.asarray, opt_state[0])


def port_grads(model) -> dict:
    return {k: p.grad for k, p in model.named_parameters()}


# ----------------------------------------------------------------- schedules
SCHEDULES = {
    "warmup": (lambda m: m.warmup_lr(1e-3, 2500)),
    "noam": (lambda m: m.noam_hold_annealing(1e-3, 500, 1000, 5000,
                                             min_lr=1e-5)),
    "cosine": (lambda m: m.cosine_annealing(1e-3, 500, 4000, min_lr=1e-5)),
    "constant": (lambda m: m.constant_lr(3e-4)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    """Steps 0-5000 within 1e-7 relative.  The cosine's values may also
    differ by one f32 ulp of the peak rate: XLA's f32 cos and numpy's
    differ by an ulp, and the schedule carries it."""
    steps = np.arange(5001)
    want = np.asarray(jax.jit(jax.vmap(SCHEDULES[name](JT)))(
        jnp.asarray(steps, jnp.int32)))
    sched = SCHEDULES[name](TT)
    got = np.asarray([sched(int(s)) for s in steps], np.float64)
    ulp = float(np.spacing(np.float32(want.max()))) if name == "cosine" \
        else 0.0
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL, atol=ulp)


# ----------------------------------------------------------------- optimizer
@pytest.mark.parametrize("clip", [0.05, 1e6], ids=["clipped", "unclipped"])
def test_optimizer_matches_optax(clip):
    """Three updates of ``make_optimizer`` from the same params and grads
    against optax's chain: the clip triggered on every update, and not."""
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 3, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = JT.make_optimizer(PEAK_LR, WARMUP, clip)
    jp = jax.tree.map(jnp.asarray, params)
    opt = tx.init(jp)
    for g in grads:
        upd, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    topt = TT.make_optimizer(PEAK_LR, WARMUP, clip)(tp.values())
    for g in grads:
        for k, p in tp.items():
            p.grad = _t(g[k])
        topt.step()
    assert topt.count == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=OPT_ATOL, rtol=0)
    if clip < 1:
        assert float(optax.global_norm(grads[0])) > clip


# ---------------------------------------------------------------------- flow
def _batch(cfg, b=4, tt=8, seed=0):
    rng = np.random.RandomState(seed)
    tm = tt * cfg.token_mel_ratio
    valid = np.ones((b, tt), bool)
    valid[-1, tt - 2:] = False
    fvalid = np.repeat(valid, cfg.token_mel_ratio, axis=1)
    return {
        "speech_token": rng.randint(0, cfg.vocab_size, (b, tt)).astype(
            np.int32),
        "token_valid": valid,
        "speech_feat": rng.randn(b, tm, cfg.output_size).astype(np.float32),
        "feat_valid": fvalid,
        "embedding": rng.randn(b, cfg.spk_embed_dim).astype(np.float32),
    }


def jax_flow_draws(rng, feat_shape) -> FlowLossDraws:
    """The draws of JAX ``CausalMaskedDiffWithXvec.loss(..., rng)``."""
    b = feat_shape[0]
    k_cond, k_keep, k_cfm, _ = jax.random.split(rng, 4)
    k_t, k_z, k_cfg = jax.random.split(k_cfm, 3)
    return FlowLossDraws(
        prompt=_t(jax.random.uniform(k_cond, (b,))),
        keep=_t(jax.random.bernoulli(k_keep, 0.5, (b,))),
        cfm=CFMDraws(
            t=_t(jax.random.uniform(k_t, (b, 1, 1), jnp.float32)).reshape(b),
            z=_t(jax.random.normal(k_z, feat_shape, jnp.float32)),
            cfg=_t(jax.random.uniform(k_cfg, (b,)))))


def jax_step_draws(rng, accum_steps):
    """The port step's ``draws`` for JAX's step under ``rng``: each
    microbatch's loss key as ``make_flow_train_step`` derives it."""
    def draws(i, mb):
        key = jax.random.fold_in(rng, i) if accum_steps > 1 else rng
        _, cfm = jax.random.split(key)
        return jax_flow_draws(cfm, tuple(mb["speech_feat"].shape)), None
    return draws


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _port_flow(params):
    tm = TFlow(TC.tiny_flow_config())
    tm.load_state_dict(flow_state_from_jax(_np(params)), strict=True)
    return tm.train()


@pytest.fixture(scope="module")
def flow():
    """JAX at the tiny config: one loss and its gradient, one
    ``accum_steps=2`` step and three plain steps, all from one init."""
    cfg = JC.tiny_flow_config()
    tx = JT.make_optimizer(PEAK_LR, WARMUP, CLIP)
    model, state, _ = JT.create_flow_train_state(cfg, jax.random.PRNGKey(0),
                                                 tx)
    batch = _batch(cfg)
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(params, rng):
        drop, cfm = jax.random.split(rng)
        return model.apply(params, jb["speech_token"], jb["token_valid"],
                           jb["speech_feat"], jb["feat_valid"],
                           jb["embedding"], cfm, method=model.loss,
                           rngs={"dropout": drop})

    rng = jax.random.PRNGKey(7)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params, rng)
    ctx = capture_grads(tx)
    cstate = state.replace(opt_state=ctx.init(state.params))
    step1 = JT.make_flow_train_step(model, ctx, donate=False)
    step2 = JT.make_flow_train_step(model, ctx, accum_steps=2, donate=False)
    acc_state, acc_m = step2(cstate, jb, rng)
    keys = [jax.random.PRNGKey(10 + i) for i in range(3)]
    s, metrics, step_grads = cstate, [], []
    for k in keys:
        s, m = step1(s, jb, k)
        metrics.append(_np(m))
        step_grads.append(flow_state_from_jax(captured(s.opt_state)))
    return dict(cfg=cfg, params=state.params, batch=batch, rng=rng,
                loss=float(loss), grads=flow_state_from_jax(_np(grads)),
                acc_params=flow_state_from_jax(_np(acc_state.params)),
                acc_grads=flow_state_from_jax(captured(acc_state.opt_state)),
                acc_metrics=_np(acc_m), keys=keys,
                step_params=flow_state_from_jax(_np(s.params)),
                step_grads=step_grads, step_metrics=metrics)


def test_config_dropout_rates_equal_jax():
    assert TC.moss_flow_config().encoder.dropout_rate == \
        JC.moss_flow_config().encoder.dropout_rate == 0.1
    assert TC.tiny_flow_config().encoder.dropout_rate == 0.0


def test_flow_loss_and_grads_match_jax(flow):
    tm = _port_flow(flow["params"])
    b = _tbatch(flow["batch"])
    _, cfm = jax.random.split(flow["rng"])
    loss = tm.loss(b["speech_token"], b["token_valid"], b["speech_feat"],
                   b["feat_valid"], b["embedding"],
                   jax_flow_draws(cfm, tuple(b["speech_feat"].shape)))
    np.testing.assert_allclose(float(loss), flow["loss"], rtol=LOSS_RTOL)
    loss.backward()
    assert_grads_close(port_grads(tm), flow["grads"], "flow grads")


def test_accum_steps_2_matches_jax(flow):
    tm = _port_flow(flow["params"])
    state = TT.TrainState(0, tm, TT.make_optimizer(PEAK_LR, WARMUP, CLIP)(
        tm.parameters()))
    step = TT.make_flow_train_step(tm, accum_steps=2)
    state, m = step(state, _tbatch(flow["batch"]),
                    draws=jax_step_draws(flow["rng"], 2))
    want = flow["acc_metrics"]
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), want["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"],
                               rtol=GRAD_REL)
    assert_grads_close(port_grads(tm), flow["acc_grads"], "accum grads")
    assert_params_close(tm, flow["acc_params"],
                        noise_floor(flow["acc_grads"], {}),
                        [state.optimizer.schedule(0)], "accum_steps=2")


def test_three_train_steps_match_jax(flow):
    """Three steps of ``make_flow_train_step`` (the clip triggered) against
    JAX's params: each within 1e-5 of its peak; loss and grad_norm
    metrics."""
    tm = _port_flow(flow["params"])
    state = TT.TrainState(0, tm, TT.make_optimizer(PEAK_LR, WARMUP, CLIP)(
        tm.parameters()))
    step = TT.make_flow_train_step(tm)
    b = _tbatch(flow["batch"])
    floor = {}
    for k, want, grads in zip(flow["keys"], flow["step_metrics"],
                              flow["step_grads"]):
        state, m = step(state, b, draws=jax_step_draws(k, 1))
        floor = noise_floor(grads, floor)
        np.testing.assert_allclose(float(m["loss"]), want["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"],
                                   rtol=GRAD_REL)
    assert state.step == 3 and state.optimizer.count == 3
    assert float(flow["step_metrics"][0]["grad_norm"]) > CLIP
    assert_params_close(tm, flow["step_params"], floor,
                        [state.optimizer.schedule(i) for i in range(3)],
                        "params after 3 steps")


def test_train_step_from_a_generator():
    """``create_flow_train_state`` + ``make_flow_train_step`` with the
    draws from a generator (the default path): finite loss, the step count,
    parameters moved; the same seed repeats the step exactly."""
    cfg = TC.tiny_flow_config()
    batch = _tbatch(_batch(cfg, b=2))
    out = []
    for _ in range(2):
        state = TT.create_flow_train_state(cfg, seed=3, device="cpu")
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        step = TT.make_flow_train_step(state.model)
        g = torch.Generator().manual_seed(4)
        state, m = step(state, batch, generator=g)
        state, m2 = step(state, batch, generator=g)
        assert state.step == 2 and np.isfinite(float(m2["loss"]))
        moved = [not torch.equal(before[k], v)
                 for k, v in state.model.state_dict().items()]
        assert all(moved)
        out.append(float(m2["loss"]))
    assert out[0] == out[1]


# ------------------------------------------------------------------- dropout
def test_dropout_statistics():
    """Keep share within 3 sigma of 0.9, kept values scaled by 1 / 0.9, the
    same generator seed the same masks."""
    n = 200_000
    x = torch.ones(n)
    y = Dropout(0.1, torch.Generator().manual_seed(0))(x)
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - 0.9) <= 3 * np.sqrt(0.9 * 0.1 / n)
    assert torch.allclose(y[kept], torch.full((int(kept.sum()),), 1 / 0.9))
    again = Dropout(0.1, torch.Generator().manual_seed(0))(x)
    assert torch.equal(y, again)
    assert Dropout(0.0, None)(x) is x


def test_dropout_only_in_the_loss_path():
    """At dropout 0.1 the inference forward is bit-identical to the same
    weights at rate 0 (no inference path passes a dropout), while the
    loss with the encoder's dropout differs from the loss without."""
    cfg = TC.tiny_flow_config()
    cfg01 = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, dropout_rate=0.1))
    state = TT.create_flow_train_state(cfg, seed=1, device="cpu")
    m0 = state.model.eval()
    m1 = TFlow(cfg01)
    m1.load_state_dict(m0.state_dict())
    m1.eval()
    b = _tbatch(_batch(cfg, b=2))
    pf = torch.zeros((2, 0, cfg.output_size))
    with torch.no_grad():
        for streaming in (False, True):
            want = m0(b["speech_token"], b["token_valid"], pf, b["embedding"],
                      streaming=streaming)
            got = m1(b["speech_token"], b["token_valid"], pf, b["embedding"],
                     streaming=streaming)
            assert torch.equal(got, want)
        draws = FlowLossDraws.draw(tuple(b["speech_feat"].shape),
                                   torch.Generator().manual_seed(2), "cpu")
        args = (b["speech_token"], b["token_valid"], b["speech_feat"],
                b["feat_valid"], b["embedding"], draws)
        plain = m1.loss(*args)
        dropped = m1.loss(*args, drop=Dropout(
            0.1, torch.Generator().manual_seed(3)))
        assert torch.equal(m1.loss(*args), plain)
        assert float(plain) != float(dropped)


def test_dropout_is_off_in_every_decode_path():
    """A decoder built at dropout 0.1 decodes bit for bit as the same
    weights at rate 0: offline ``token2wav``, the KV session (kernel engine
    and concat dataflow) and the windowed device session, on the CPU."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.weights import seeded_states
    cfg = TC.tiny_flow_config()
    hcfg = TC.tiny_hift_config()
    flow_state, hift_state = seeded_states(cfg, hcfg, seed=3)
    tokens = np.random.RandomState(4).randint(0, cfg.vocab_size, (1, 14))
    wavs = []
    for rate in (0.0, 0.1):
        c = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, dropout_rate=rate))
        dec = AudioDecoder(c, hcfg, flow_state, hift_state,
                           TC.PipelineConfig(block_size=3, mel_cache_len=2,
                                             max_token_len=9), device="cpu")
        wavs.append([
            dec.token2wav(tokens),
            dec.kv_stream_decoder(block_size=3, ring_tokens=6,
                                  token_cap=32).stream_decode(tokens),
            dec.kv_stream_decoder(block_size=3, ring_tokens=6, token_cap=32,
                                  fused=False).stream_decode(tokens),
            dec.device_stream_decoder(block_size=3, max_token_len=9)
            .stream_decode(tokens)])
    for got, want in zip(wavs[1], wavs[0]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --------------------------------------------------------------- v-diffusion
def test_sobol_times_equal_jax():
    for n, seed in ((8, 0), (16, 3)):
        np.testing.assert_array_equal(TV.sobol_times(n, seed),
                                      JV.sobol_times(n, seed))


def jax_vdiff_draws(rng, shape, t=None) -> TV.VDiffDraws:
    b = shape[0]
    k_t, k_eps, k_drop = jax.random.split(rng, 3)
    if t is None:
        t = jax.random.uniform(k_t, (b,), jnp.float32)
    return TV.VDiffDraws(t=_t(t), eps=_t(jax.random.normal(
        k_eps, shape, jnp.float32)), cfg=_t(jax.random.uniform(k_drop, (b,))))


def test_vdiffusion_loss_and_grads_match_jax():
    cfg = JD.tiny_dit_config()
    rng = np.random.RandomState(3)
    b, t, d = 2, 21, cfg.io_channels
    x0 = rng.randn(b, t, d).astype(np.float32)
    valid = np.ones((b, t), bool)
    valid[1, 15:] = False
    mu = rng.randn(b, t, d).astype(np.float32)
    spks = rng.randn(b, cfg.spk_embed_dim).astype(np.float32)
    cond = rng.randn(b, t, d).astype(np.float32)
    jm = JV.VDiffusion(cfg)
    args = tuple(jnp.asarray(a) for a in (x0, valid, mu, spks, cond))
    key = jax.random.PRNGKey(4)
    params = _np(jax.jit(lambda k: jm.init(k, *args, key,
                                           method=jm.compute_loss))(
        jax.random.PRNGKey(0)))
    params = jax.tree.map(lambda a: a + 0.05 * np.random.RandomState(1)
                          .randn(*a.shape).astype(np.float32), params)
    # a row with its condition dropped (cfg uniform below 0.1) and one kept
    for key, cfg_p in ((jax.random.PRNGKey(4), 0.1),
                       (jax.random.PRNGKey(4), 0.9)):
        fn = jax.jit(jax.value_and_grad(lambda p: jm.apply(
            p, *args, key, cfg_dropout_prob=cfg_p,
            method=jm.compute_loss)[0]))
        loss, grads = fn(params)
        tm = TV.VDiffusion(TD.tiny_dit_config())
        tm.load_state_dict(gradtts_state_from_jax(params), strict=True)
        got, _ = tm.compute_loss(*(_t(a) for a in (x0, valid, mu, spks,
                                                    cond)),
                                 jax_vdiff_draws(key, (b, t, d)),
                                 cfg_dropout_prob=cfg_p)
        np.testing.assert_allclose(float(got), float(loss), rtol=LOSS_RTOL)
        got.backward()
        assert_grads_close({k: p.grad for k, p in tm.named_parameters()},
                           gradtts_state_from_jax(_np(grads)),
                           "vdiffusion grads")


def test_gradtts_loss_and_grads_match_jax():
    """``GradTTSDiffWithXvec.loss`` with Sobol timesteps fed as ``t``."""
    fj = tiny_v1_config(JC)
    dj = dataclasses.replace(JD.tiny_dit_config(), io_channels=N_MEL,
                             spk_embed_dim=N_MEL)
    jm = JV.GradTTSDiffWithXvec(fj, dj)
    rng = np.random.RandomState(9)
    b, n_tok, tm_len = 2, 12, 30
    tok = rng.randint(0, 64, (b, n_tok)).astype(np.int32)
    valid = np.ones((b, n_tok), bool)
    valid[1, 9:] = False
    feat = rng.randn(b, tm_len, N_MEL).astype(np.float32)
    fvalid = np.ones((b, tm_len), bool)
    fvalid[1, 24:] = False
    emb = rng.randn(b, SPK).astype(np.float32)
    t = JV.sobol_times(b, seed=1)
    args = tuple(jnp.asarray(a) for a in (tok, valid, feat, fvalid, emb))
    key = jax.random.PRNGKey(11)
    params = _np(jax.jit(lambda k: jm.init(k, *args, key, t=t,
                                           method=jm.loss))(
        jax.random.PRNGKey(8)))
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.random.RandomState(2).randn(*a.shape) * 0.05)
        .astype(np.float32) if ("preprocess" in str(p)
                                or "postprocess" in str(p)) else a, params)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.apply(
        p, *args, key, t=jnp.asarray(t), method=jm.loss)))(params)
    tmod = TV.GradTTSDiffWithXvec(
        tiny_v1_config(TC), dataclasses.replace(
            TD.tiny_dit_config(), io_channels=N_MEL, spk_embed_dim=N_MEL))
    tmod.load_state_dict(gradtts_state_from_jax(params), strict=True)
    got = tmod.loss(*(_t(a) for a in (tok, valid, feat, fvalid, emb)),
                    jax_vdiff_draws(key, feat.shape, t=t))
    np.testing.assert_allclose(float(got), float(loss), rtol=LOSS_RTOL)
    got.backward()
    assert_grads_close({k: p.grad for k, p in tmod.named_parameters()},
                       gradtts_state_from_jax(_np(grads)), "gradtts grads")


# -------------------------------------------------------------- the guard
def _flash_inputs():
    g = torch.Generator().manual_seed(0)
    return [torch.randn((1, 2, 8, 64), generator=g) for _ in range(3)]


@pytest.mark.parametrize("entry", ["flash_chunk_attention",
                                   "flash_chunk_attention_fl",
                                   "fused_tf_group",
                                   "fused_conformer_group"])
def test_cuda_entries_raise_under_autograd(entry):
    """Each CUDA entry refuses an input that requires grad, on the CPU
    too (the check runs before the device dispatch), naming the switch;
    under ``torch.no_grad()`` the same call runs its plain version."""
    if entry.startswith("flash"):
        q, k, v = _flash_inputs()
        if entry.endswith("_fl"):
            q, k, v = (x.transpose(1, 2).reshape(1, 8, 128) for x in (q, k, v))

            def call(q):
                return fa.flash_chunk_attention_fl(q, k, v, heads=2)
        else:
            def call(q):
                return fa.flash_chunk_attention(q, k, v)
        switch = "use_flash_attention"
        ref = fa.flash_chunk_attention_plain
    elif entry == "fused_tf_group":
        p, rp_, mt, cc1, cc2, x, rings = fb.make_group_inputs(
            6, 6, 16, 8, 2, 4, 2, 24, torch.float32, "cpu", seed=5)
        scal = fb.group_scalars([6] * 6, [0] * 6, [1] * 6, "cpu")

        def call(x):
            return fb.fused_tf_group(p, rp_, mt, cc1, cc2, x, rings.clone(),
                                     scal, 0, heads=2, head_dim=4)[0]
        q, switch = x, "kernel"
    else:
        p, x, pe, kv, pk = fc.make_conformer_inputs(
            2, 3, 16, 2, 32, 6, torch.float32, "cpu", seed=3)

        def call(x):
            return fc.fused_conformer_group(p, x, pe, kv.clone(), pk.clone(),
                                            0, heads=2, head_dim=8)[0]
        q, switch = x, "enc_kernel"
    want = call(q)
    q_grad = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match=switch):
        call(q_grad)
    with torch.no_grad():
        assert torch.equal(call(q_grad), want)
    if entry.startswith("flash") and not entry.endswith("_fl"):
        assert torch.equal(want, ref(q, k, v, 0, 8))
