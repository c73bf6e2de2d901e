"""The flash chunk-attention wrapper of the port against the JAX Pallas kernel
(interpret mode on the CPU).  On the CPU the wrapper runs the kernel's plain
version; the CUDA kernel itself is checked on the card by
``test_torch_cuda.py``."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.ops.pallas_attention import (
    flash_chunk_attention as j_flash, flash_chunk_attention_fl as j_flash_fl,
    xla_chunk_attention)
from moss_speech_decoder_cosy_torch.ops import flash_attention as fa
from moss_speech_decoder_cosy_torch.utils.device import resolve_device


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q = rng.randn(*shape).astype(np.float32) * 0.3
    k = rng.randn(*shape).astype(np.float32) * 0.3
    v = rng.randn(*shape).astype(np.float32)
    return [a.astype(dtype) for a in (q, k, v)]


@pytest.mark.parametrize("t,chunk,valid_len", [
    (128, 0, None), (128, 50, None), (256, 50, None), (200, 64, None),
    (100, 0, None), (200, 50, 150), (128, 0, 100)])
def test_plain_matches_jax_flash(t, chunk, valid_len):
    q, k, v = _qkv((1, 2, t, 64), 0)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   chunk_size=chunk, interpret=True, valid_len=valid_len)
    got = fa.flash_chunk_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), chunk, valid_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_bf16():
    """bf16 in, bf16 out; against the f32 golden to 0.05 (as the JAX
    package's own bf16 test) and against the JAX kernel in bf16."""
    rng = np.random.RandomState(1)
    q, k, v = (jnp.asarray(rng.randn(1, 2, 128, 64), jnp.bfloat16)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                  for a in (q, k, v))
    got = fa.flash_chunk_attention(tq, tk, tv, 50)
    assert got.dtype == torch.bfloat16
    golden = xla_chunk_attention(q.astype(jnp.float32),
                                 k.astype(jnp.float32),
                                 v.astype(jnp.float32), 50)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(golden),
                               atol=0.05, rtol=0)
    want = j_flash(q, k, v, chunk_size=50, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.05,
                               rtol=0)


@pytest.mark.parametrize("t,chunk", [(128, 0), (200, 50)])
def test_feature_last_matches_jax(t, chunk):
    b, h, dk = 2, 4, 64
    q, k, v = (a.transpose(0, 2, 1, 3).reshape(b, t, h * dk)
               for a in _qkv((b, h, t, dk), 2))
    want = j_flash_fl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      heads=h, chunk_size=chunk, interpret=True)
    got = fa.flash_chunk_attention_fl(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        heads=h, chunk_size=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_cpu_path_does_not_count_launches():
    before = fa.launch_flash_chunk_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 40, 64), 3))
    fa.flash_chunk_attention(q, k, v, 8)
    fa.flash_chunk_attention_fl(*(x.transpose(1, 2).reshape(1, 40, 128)
                                  for x in (q, k, v)), heads=2)
    assert fa.launch_flash_chunk_attention.launches == before


def test_no_fallback_off_the_cpu(monkeypatch):
    """Without CUDA the default device raises, and a tensor on another
    device than the CPU never reaches the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    q = torch.empty(1, 2, 16, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_chunk_attention(q, q, q)


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 16, 64), 4))
    with pytest.raises(ValueError):
        fa.flash_chunk_attention(q, k[:, :, :8], v)
    with pytest.raises(ValueError):
        fa.flash_chunk_attention(q, k.double(), v)
    with pytest.raises(ValueError):
        fa.flash_chunk_attention(q, k, v, valid_len=17)


@pytest.mark.parametrize("top,tol", [
    (0.3, 2 * 2.0 ** -9),      # |x| in [0.25, 0.5): one bf16 ulp is 2^-9
    (0.5, 2 * 2.0 ** -8),
    (4.9, 2 * 2.0 ** -5),
])
def test_kernel_tolerance_is_two_bf16_ulps_of_the_largest_output(top, tol):
    want = torch.tensor([[0.01, -top, 0.0]], dtype=torch.bfloat16)
    assert fa.kernel_tolerance(want) == tol
    assert fa.kernel_tolerance(want.float()) == 2e-5
    with pytest.raises(ValueError):
        fa.kernel_tolerance(want.half())
