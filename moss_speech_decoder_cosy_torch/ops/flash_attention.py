"""Flash chunk-causal attention: the CUDA kernel ``csrc/flash_chunk_attention.cu``
and its plain PyTorch version.

Replaces the JAX package's Pallas kernels ``ops/pallas_attention.py::
_attn_kernel`` (entry ``flash_chunk_attention``, q/k/v (B, H, T, dk)) and
``::_attn_kernel_fl`` (entry ``flash_chunk_attention_fl``, (B, T, H*dk)).
One kernel serves both entries through (batch, head, time) strides.

Query i attends key k iff ``k < valid_len`` and
(``chunk == 0`` or ``k // chunk <= i // chunk``).  Numerics follow the TPU
kernel: q scaled in its own dtype, f32 scores, masked scores -1e30, p cast
to v's dtype before P*V, f32 m/l/acc, output ``acc / max(l, 1e-20)`` in the
input dtype.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (f32 or bf16, dk = 64) or raises.  There is no fall-back.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import cuda_build
from .autograd_guard import forbid_autograd

_NEG = -1.0e30
KERNEL_HEAD_DIM = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_chunk_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, chunk_size: int = 0,
                                valid_len: Optional[int] = None
                                ) -> torch.Tensor:
    """Materialised-score version with the kernel's mask and cast points.
    q/k/v (B, H, T, dk) -> (B, H, T, dk)."""
    t, dk = q.shape[-2], q.shape[-1]
    vl = t if valid_len is None else valid_len
    qs = q * (1.0 / math.sqrt(dk))
    s = qs.float() @ k.float().transpose(-1, -2)
    pos = torch.arange(t, device=q.device)
    allow = (pos < vl)[None, :]
    if chunk_size > 0:
        allow = allow & ((pos[None, :] // chunk_size)
                         <= (pos[:, None] // chunk_size))
    s = torch.where(allow, s, torch.tensor(_NEG, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ v.float()
    return (acc / torch.clamp(l, min=1e-20)).to(q.dtype)


def kernel_tolerance(want: torch.Tensor) -> float:
    """Largest abs difference allowed between the kernel and the plain
    version whose output is ``want``.  f32: 2e-5 (summation order only).
    bf16: two bf16 ulps of the largest |output| -- the two round p at
    different running maxima and then round the output once."""
    if want.dtype == torch.float32:
        return 2e-5
    if want.dtype != torch.bfloat16:
        raise ValueError(f"kernel takes float32 or bfloat16, got {want.dtype}")
    top = want.float().abs().max().item()
    # bf16 keeps 8 significant bits: for |x| in [2^e, 2^(e+1)) an ulp is
    # 2^(e-7); frexp gives top = f * 2^(e+1), f in [0.5, 1)
    return 2.0 * 2.0 ** (math.frexp(top)[1] - 8) if top > 0 else 0.0


def _check(q, k, v, ndim: int) -> None:
    if q.dim() != ndim or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one {ndim}-D shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q/k/v lie on different devices")


def _valid_len(t: int, valid_len: Optional[int]) -> int:
    vl = t if valid_len is None else int(valid_len)
    if not 1 <= vl <= t:
        raise ValueError(f"valid_len {vl} outside [1, {t}]")
    return vl


def _strides_bht(x: torch.Tensor, layout: str) -> Tuple[int, int, int]:
    if layout == "bhtd":
        return x.stride(0), x.stride(1), x.stride(2)
    return x.stride(0), KERNEL_HEAD_DIM, x.stride(1)     # (B, T, H*dk)


def _kernel_fn():
    fn = cuda_build.load("flash_chunk_attention").flash_chunk_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
    return fn


def launch_flash_chunk_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, out: torch.Tensor,
                                 layout: str, batch: int, heads: int, t: int,
                                 chunk_size: int, valid_len: int) -> None:
    """Launches the kernel on the current stream; ``launches`` counts every
    launch.  Checks device, dtype, head dim and contiguity; raises on a
    non-zero CUDA return code."""
    for x in (q, k, v, out):
        if x.device.type != "cuda":
            raise ValueError(f"kernel needs CUDA tensors, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("kernel needs contiguous q/k/v/out")
    if q.dtype not in _DTYPE_CODE or out.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] != (KERNEL_HEAD_DIM if layout == "bhtd"
                       else heads * KERNEL_HEAD_DIM):
        raise ValueError(f"kernel head dim is {KERNEL_HEAD_DIM}, got shape "
                         f"{tuple(q.shape)} with {heads} heads")
    fn = _kernel_fn()
    strides = [s for x in (q, k, v, out) for s in _strides_bht(x, layout)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPE_CODE[q.dtype], batch, heads, t, KERNEL_HEAD_DIM,
                *strides, chunk_size, valid_len,
                1.0 / math.sqrt(KERNEL_HEAD_DIM), stream)
    launch_flash_chunk_attention.launches += 1
    if rc != 0:
        raise RuntimeError(f"flash_chunk_attention launch failed: CUDA "
                           f"error {rc}")


launch_flash_chunk_attention.launches = 0


def flash_chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          chunk_size: int = 0,
                          valid_len: Optional[int] = None) -> torch.Tensor:
    """q/k/v (B, H, T, dk) -> (B, H, T, dk); chunk_size 0 = full attention,
    ``valid_len`` masks keys >= valid_len."""
    forbid_autograd("flash_chunk_attention",
                               "use_flash_attention", q, k, v)
    _check(q, k, v, 4)
    b, h, t, _ = q.shape
    vl = _valid_len(t, valid_len)
    if q.device.type == "cpu":
        return flash_chunk_attention_plain(q, k, v, chunk_size, vl)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch_flash_chunk_attention(q, k, v, out, "bhtd", b, h, t, chunk_size,
                                 vl)
    return out


def flash_chunk_attention_fl(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, heads: int,
                             chunk_size: int = 0,
                             valid_len: Optional[int] = None
                             ) -> torch.Tensor:
    """Feature-last entry: q/k/v (B, T, H*dk) -> (B, T, H*dk), no
    transposes on the CUDA path."""
    forbid_autograd("flash_chunk_attention_fl",
                               "use_flash_attention", q, k, v)
    _check(q, k, v, 3)
    b, t, hd = q.shape
    if hd % heads:
        raise ValueError(f"feature dim {hd} not divisible by {heads} heads")
    vl = _valid_len(t, valid_len)
    if q.device.type == "cpu":
        def split(x):
            return x.reshape(b, t, heads, hd // heads).transpose(1, 2)
        out = flash_chunk_attention_plain(split(q), split(k), split(v),
                                          chunk_size, vl)
        return out.transpose(1, 2).reshape(b, t, hd)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch_flash_chunk_attention(q, k, v, out, "fl", b, heads, t,
                                 chunk_size, vl)
    return out
