"""The port's op modules against their JAX twins on the CPU, f32, to 1e-5.

Inputs come from a seeded numpy RandomState; each flax module's params go
through ``weights.state_from_jax_tree`` into the port's module.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from moss_speech_decoder_cosy_tpu.ops import activations as j_act
from moss_speech_decoder_cosy_tpu.ops import attention as j_attn
from moss_speech_decoder_cosy_tpu.ops import convs as j_convs
from moss_speech_decoder_cosy_tpu.ops import embeddings as j_emb
from moss_speech_decoder_cosy_tpu.ops import masks as j_masks
from moss_speech_decoder_cosy_tpu.ops import stft as j_stft
from moss_speech_decoder_cosy_torch.ops import activations as t_act
from moss_speech_decoder_cosy_torch.ops import attention as t_attn
from moss_speech_decoder_cosy_torch.ops import convs as t_convs
from moss_speech_decoder_cosy_torch.ops import embeddings as t_emb
from moss_speech_decoder_cosy_torch.ops import masks as t_masks
from moss_speech_decoder_cosy_torch.ops import norms as t_norms
from moss_speech_decoder_cosy_torch.ops import stft as t_stft
from moss_speech_decoder_cosy_torch.weights import state_from_jax_tree

ATOL = 1e-5


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _port(module, flax_params, transpose=False):
    params = jax.tree.map(np.asarray, flax_params)
    module.load_state_dict(state_from_jax_tree(
        params, lambda mod: transpose), strict=True)
    return module.eval()


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


# ------------------------------------------------------------------ masks
@pytest.mark.parametrize("size,chunk,left", [(10, 3, -1), (10, 3, 1),
                                             (9, 4, 0)])
def test_subsequent_chunk_mask(size, chunk, left):
    _close(t_masks.subsequent_chunk_mask(size, chunk, left),
           j_masks.subsequent_chunk_mask(size, chunk, left))


@pytest.mark.parametrize("chunk", [0, 4])
def test_chunk_attention_mask_and_bias(chunk):
    valid = np.ones((2, 11), bool)
    valid[1, 7:] = False
    got = t_masks.chunk_attention_mask(torch.from_numpy(valid), chunk)
    want = j_masks.chunk_attention_mask(jnp.asarray(valid), chunk)
    _close(got, want)
    _close(t_masks.mask_to_bias(got), j_masks.mask_to_bias(want))


# ------------------------------------------------------------ activations
@pytest.mark.parametrize("name", ["relu", "gelu", "swish", "silu", "mish",
                                  "tanh", "elu"])
def test_activation_registry(name):
    x = _rand(3, 40, scale=3.0)
    _close(t_act.get_activation(name)(torch.from_numpy(x)),
           j_act.get_activation(name)(jnp.asarray(x)))


def test_snake():
    x = _rand(2, 9, 6, scale=2.0)
    alpha = np.abs(_rand(6, seed=1)) + 0.2
    _close(t_act.snake(torch.from_numpy(x), torch.from_numpy(alpha)),
           j_act.snake(jnp.asarray(x), jnp.asarray(alpha)))


# ------------------------------------------------------------------ norms
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm_flax_fast_variance(eps):
    """flax LayerNorm statistics: f32, E[x^2]-E[x]^2 clipped at 0; an
    offset input makes the fast-variance formula matter."""
    x = _rand(2, 7, 24, scale=3.0) + 5.0
    ln = fnn.LayerNorm(epsilon=eps)
    p = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(lambda a: a + jnp.asarray(
        _rand(*a.shape, seed=3, scale=0.1)), p)
    want = ln.apply(p, jnp.asarray(x))
    got = _port(t_norms.LayerNorm(24, eps), p["params"])(torch.from_numpy(x))
    _close(got, want)


def test_group_norm():
    x = _rand(2, 9, 16, scale=2.0) + 1.0
    gn = fnn.GroupNorm(num_groups=8, epsilon=1e-5)
    p = gn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = gn.apply(p, jnp.asarray(x))
    got = _port(t_norms.GroupNorm(8, 16), p["params"])(torch.from_numpy(x))
    _close(got, want)


# ------------------------------------------------------------------ convs
@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, padding=1),
    dict(kernel_size=4, stride=2, padding=1),
    dict(kernel_size=5, dilation=3, padding=6),
    dict(kernel_size=3, groups=4, padding=1),
    dict(kernel_size=7, padding=3, weight_norm=True),
])
def test_conv1d(kw):
    x = _rand(2, 13, 8)
    jm = j_convs.Conv1d(12, **kw)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jm.apply(p, jnp.asarray(x))
    got = _port(t_convs.Conv1d(8, 12, **kw), p["params"])(torch.from_numpy(x))
    _close(got, want)


def test_causal_conv1d_with_and_without_cache():
    x = _rand(2, 10, 6)
    cache = _rand(2, 4, 6, seed=2)
    jm = j_convs.CausalConv1d(5, 3, dilation=2)
    p = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tm = _port(t_convs.CausalConv1d(6, 5, 3, dilation=2), p["params"])
    _close(tm(torch.from_numpy(x)), jm.apply(p, jnp.asarray(x)))
    got_y, got_c = tm(torch.from_numpy(x), torch.from_numpy(cache))
    want_y, want_c = jm.apply(p, jnp.asarray(x), jnp.asarray(cache))
    _close(got_y, want_y)
    _close(got_c, want_c)


@pytest.mark.parametrize("k,s,pad,wn", [(4, 2, 1, False), (16, 8, 4, True),
                                        (5, 3, 1, True), (3, 2, 0, False)])
def test_conv_transpose1d(k, s, pad, wn):
    """torch output-length semantics, padding, weight-norm over (O, K)."""
    x = _rand(2, 7, 6)
    jm = j_convs.ConvTranspose1d(4, k, s, padding=pad, weight_norm=wn)
    p = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = jm.apply(p, jnp.asarray(x))
    tm = _port(t_convs.ConvTranspose1d(6, 4, k, s, padding=pad,
                                       weight_norm=wn), p["params"], True)
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (2, (7 - 1) * s - 2 * pad + k, 4)
    _close(got, want)


# ------------------------------------------------------------- embeddings
@pytest.mark.parametrize("size,offset", [(7, 0), (40, 3)])
def test_rel_pos_tables(size, offset):
    _close(t_emb.wenet_rel_pos(size, 16, offset),
           j_emb.wenet_rel_pos(size, 16, offset))
    _close(t_emb.espnet_rel_pos(size, 16), j_emb.espnet_rel_pos(size, 16))


def test_timestep_embedding():
    t = np.array([0.0, 0.3, 0.97], np.float32)
    _close(t_emb.SinusoidalPosEmb(20)(torch.from_numpy(t)),
           j_emb.SinusoidalPosEmb(20)(jnp.asarray(t)))
    e = _rand(3, 20)
    jm = j_emb.TimestepEmbedding(32)
    p = jm.init(jax.random.PRNGKey(4), jnp.asarray(e))
    tm = _port(t_emb.TimestepEmbedding(20, 32), p["params"])
    _close(tm(torch.from_numpy(e)), jm.apply(p, jnp.asarray(e)))


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("flavor", ["rel_pos", "rel_pos_espnet"])
def test_rel_position_attention(flavor):
    """wenet table (no rel-shift) and espnet table (rel-shift), with a
    chunk mask over a right-padded row."""
    b, t, d, h = 2, 7, 16, 2
    x = _rand(b, t, d)
    pos = (j_emb.wenet_rel_pos(t, d) if flavor == "rel_pos"
           else j_emb.espnet_rel_pos(t, d))
    valid = np.ones((b, t), bool)
    valid[1, 5:] = False
    mask = j_masks.chunk_attention_mask(jnp.asarray(valid), 3)
    jm = j_attn.RelPositionMultiHeadedAttention(h, d)
    p = jm.init(jax.random.PRNGKey(5), jnp.asarray(x), pos, mask)
    want = jm.apply(p, jnp.asarray(x), pos, mask)
    tm = _port(t_attn.RelPositionMultiHeadedAttention(h, d), p["params"])
    got = tm(torch.from_numpy(x), torch.from_numpy(np.array(pos)),
             torch.from_numpy(np.array(mask)))
    _close(got, want)


@pytest.mark.parametrize("mode", ["bias_full", "bias_chunk", "flash_full",
                                  "flash_chunk"])
def test_unet_attention(mode):
    """Additive-bias path, and the flash path (JAX: the Pallas kernel in
    interpret mode; port: the kernel's plain version on the CPU).  The port
    runs under ``torch.no_grad()``, as inference does: the flash entry
    refuses inputs that autograd would record."""
    b, t, d = 2, 12, 24
    x = _rand(b, t, d)
    chunk = 4 if mode.endswith("chunk") else 0
    jm = j_attn.UNetAttention(2, 8)
    p = jm.init(jax.random.PRNGKey(6), jnp.asarray(x))
    tm = _port(t_attn.UNetAttention(d, 2, 8), p["params"])
    with torch.no_grad():
        if mode.startswith("bias"):
            m = j_masks.chunk_attention_mask(jnp.ones((b, t), bool), chunk)
            bias = j_masks.mask_to_bias(m)
            want = jm.apply(p, jnp.asarray(x), bias)
            got = tm(torch.from_numpy(x), torch.from_numpy(np.array(bias)))
        else:
            want = jm.apply(p, jnp.asarray(x), None, chunk)
            got = tm(torch.from_numpy(x), None, chunk)
    _close(got, want)


# ------------------------------------------------------------------- stft
def test_stft_matches_jax():
    x = _rand(2, 203)
    win = j_stft.hann_window(16)
    jr, ji = j_stft.stft(jnp.asarray(x), 16, 4, win)
    tr, ti = t_stft.stft(torch.from_numpy(x), 16, 4, t_stft.hann_window(16))
    _close(tr, jr)
    _close(ti, ji)


@pytest.mark.parametrize("n_fft,hop", [(16, 4), (10, 4)])
def test_istft_matches_jax_and_round_trips(n_fft, hop):
    """hop | n_fft takes the stride-decomposed overlap-add, else the
    scatter-add one."""
    f = n_fft // 2 + 1
    re_, im_ = _rand(2, 30, f), _rand(2, 30, f, seed=1)
    win = j_stft.hann_window(n_fft)
    want = j_stft.istft(jnp.asarray(re_), jnp.asarray(im_), n_fft, hop, win)
    got = t_stft.istft(torch.from_numpy(re_), torch.from_numpy(im_), n_fft,
                       hop, t_stft.hann_window(n_fft))
    _close(got, want)
    x = torch.from_numpy(_rand(1, 160, seed=2))
    r, i = t_stft.stft(x, 16, 4, t_stft.hann_window(16))
    back = t_stft.istft(r, i, 16, 4, t_stft.hann_window(16))
    _close(back, x.numpy()[:, :back.shape[1]])
