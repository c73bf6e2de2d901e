"""Plain PyTorch pieces of the references: products at a stated precision,
norms, activations, convolutions on (B, T, C), masked attention and HiFT.

Tensors are (B, T, C).  A reference computes at one precision (``Ops``):

- ``float32``: f32 with TF32 off in products and convolutions (the
  references' own precision);
- ``tf32``: f32, TF32 allowed in products and convolutions;
- ``bfloat16``: every floating tensor that an operation of the model takes
  or makes rounded to bf16 (``Ops.model()``), as a program that computes
  in bf16 holds it;
- ``fp8``: the same with float8 e4m3, one scale a tensor (its largest
  magnitude at 448).

The ODE solver's carry and update stay in f32 outside ``Ops.model()``, as
the configurations state (``cfm.solver_dtype``).  Imports torch and numpy
only: nothing of the program or of JAX.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

PRECISIONS = ("float32", "tf32", "bfloat16", "fp8")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """e4m3 with one scale a tensor; infinities (masked scores) kept."""
    fin = torch.isfinite(x)
    s = torch.where(fin, x.abs(), 0).amax().float().clamp(min=1e-30) / 448.0
    q = (x.float() / s).to(torch.float8_e4m3fn).float() * s
    return torch.where(fin, q.to(x.dtype), x)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class _Rounding(TorchDispatchMode):
    """Rounds the floating inputs and results of every operation that runs
    under it (not the results of views and in-place operations, which alias
    their inputs, nor the inputs those operations write)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def _r(self, t):
        if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
            return self.fn(t)
        return t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        if not schema.is_mutable:
            args, kwargs = tree_map(self._r, (args, kwargs))
        out = func(*args, **kwargs)
        if any(r.alias_info is not None for r in schema.returns):
            return out
        return tree_map(self._r, out)


class Ops:
    """The precision a reference computes at (see the module doc): the
    TF32 switches (``active``) and the rounding of the model's tensors
    (``model``)."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    @contextlib.contextmanager
    def active(self):
        """The TF32 switches of this precision, restored on exit."""
        b = torch.backends
        old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        on = self.precision == "tf32"
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = old

    def model(self):
        """The context a model's forward runs in at this precision."""
        if self.precision == "bfloat16":
            return _Rounding(_bf16)
        if self.precision == "fp8":
            return _Rounding(_fp8)
        return contextlib.nullcontext()


def conv(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    """Conv1d on (B, T, C); ``w`` (O, I / groups, K)."""
    return F.conv1d(x.transpose(1, 2), w, b, stride=stride, padding=padding,
                    dilation=dilation, groups=groups).transpose(1, 2)


def conv_t(x, w, b=None, stride=1, padding=0):
    """ConvTranspose1d on (B, T, C); ``w`` (I, O, K)."""
    return F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride,
                              padding=padding).transpose(1, 2)


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def group_norm(x, groups, w, b, eps=1e-5):
    return F.group_norm(x.transpose(1, 2), groups, w, b, eps).transpose(1, 2)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def snake(x, alpha):
    return x + torch.sin(alpha * x) ** 2 / (alpha + 1e-9)


def weight_norm(p: Dict[str, torch.Tensor], key: str) -> torch.Tensor:
    """g * v / ||v||, the norm over all but the first axis."""
    v, g = p[key + ".v"], p[key + ".g"]
    norm = v.flatten(1).norm(dim=1).clamp(min=1e-12)
    return v * (g / norm).view((-1,) + (1,) * (v.dim() - 1))


def masked_attention(q, k, v, heads: int, mask=None, bd=None):
    """Softmax attention.  q, k, v (B, T*, H*D); mask bool (T, S) or None;
    ``bd`` an extra score term (B, H, T, S) before the scale.  Masked keys
    get no weight."""
    b, t, _ = q.shape
    s = k.shape[1]
    dk = q.shape[-1] // heads

    def split(x, n):
        return x.reshape(b, n, heads, dk).transpose(1, 2)

    scores = torch.matmul(split(q, t), split(k, s).transpose(-1, -2))
    if bd is not None:
        scores = scores + bd
    scores = scores / math.sqrt(dk)
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    a = torch.softmax(scores, dim=-1)
    out = torch.matmul(a, split(v, s))
    return out.transpose(1, 2).reshape(b, t, heads * dk)


def chunk_mask(bounds, window: int, device) -> torch.Tensor:
    """(T, T) bool: position i sees j when j's chunk is not after i's and
    j >= (start of i's chunk) - ``window``; ``bounds`` the chunks' starts
    and the end, ascending."""
    t = bounds[-1]
    starts = torch.zeros(t, dtype=torch.long)
    ends = torch.zeros(t, dtype=torch.long)
    for a, e in zip(bounds[:-1], bounds[1:]):
        starts[a:e], ends[a:e] = a, e
    j = torch.arange(t)[None, :]
    m = (j < ends[:, None]) & (j >= starts[:, None] - window)
    return m.to(device)


def fixed_noise(max_len: int, dim: int) -> np.ndarray:
    """The CFM's noise: standard normal (1, max_len, dim) from a NumPy
    RandomState seeded 0, sliced from the start."""
    rng = np.random.RandomState(0)
    return rng.standard_normal((1, max_len, dim)).astype(np.float32)


def t_span(n: int) -> np.ndarray:
    """The cosine schedule of n Euler steps, in f32 as the solver steps."""
    t = np.linspace(0.0, 1.0, n + 1)
    return (1.0 - np.cos(t * 0.5 * np.pi)).astype(np.float32)


def time_embedding(p, pre: str, t: torch.Tensor, dim: int):
    """Sinusoidal embedding of 1000 t (dim channels), then the two-layer MLP
    with SiLU."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32)
                      * -(math.log(10000.0) / (half - 1)))
    emb = (1000.0 * t)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    h = F.linear(emb, p[pre + "linear_1.weight"], p[pre + "linear_1.bias"])
    return F.linear(F.silu(h), p[pre + "linear_2.weight"],
                      p[pre + "linear_2.bias"])


# ---------------------------------------------------------------- HiFT

def nsf_draws(harmonics: int, length: int, device, phase: bool):
    """The NSF source's draws: a generator on ``device`` seeded 0, the
    initial phases (uniform in [0, 1), or in [-pi, pi) with ``phase``) then
    the noise (1, length, harmonics)."""
    g = torch.Generator(device=device)
    g.manual_seed(0)
    rand_ini = torch.rand((1, harmonics), generator=g, device=device)
    noise = torch.randn((1, length, harmonics), generator=g, device=device)
    if phase:
        rand_ini = (rand_ini * 2.0 - 1.0) * np.pi
    return rand_ini, noise


def interp(x: torch.Tensor, n: int) -> torch.Tensor:
    """Linear interpolation of (B, T, C) to n steps (half-pixel centres)."""
    return F.interpolate(x.transpose(1, 2), size=n, mode="linear",
                         align_corners=False).transpose(1, 2)


def _source(h: Dict, p, f0: torch.Tensor, rand_ini, noise) -> torch.Tensor:
    """The harmonic-plus-noise excitation (B, L, 1) of f0 (B, L, 1)."""
    nh = h["nb_harmonics"] + 1
    fn = f0 * torch.arange(1, nh + 1, dtype=torch.float32,
                           device=f0.device)[None, None, :]
    rad = torch.remainder(fn / h["sampling_rate"], 1.0)
    if h["sampling_rate"] == 22050:
        # phase integrated at the audio rate, a fixed start phase a harmonic
        theta = 2.0 * np.pi * torch.cumsum(rad.transpose(1, 2).contiguous(),
                                           dim=-1).transpose(1, 2)
        ini = rand_ini.reshape(1, 1, nh).clone()
        ini[..., 0] = 0.0
        sines = h["nsf_alpha"] * torch.sin(theta + ini)
    else:
        # phase integrated at the frame rate, re-upsampled
        up = math.prod(h["upsample_rates"]) * h["istft_hop_len"]
        ini = rand_ini.clone()
        ini[:, 0] = 0.0
        rad = torch.cat([rad[:, :1] + ini[:, None, :], rad[:, 1:]], dim=1)
        length = f0.shape[1]
        low = interp(rad, length // up)
        cyc = torch.cumsum(low.transpose(1, 2).contiguous(), dim=-1)
        phase = interp(cyc.transpose(1, 2) * 2.0 * np.pi * up, length)
        sines = torch.sin(phase) * h["nsf_alpha"]
    uv = (f0 > h["nsf_voiced_threshold"]).float()
    amp = uv * h["nsf_sigma"] + (1.0 - uv) * h["nsf_alpha"] / 3.0
    wave = sines * uv + amp * noise
    return torch.tanh(F.linear(wave, p["m_source.l_linear.weight"],
                               p["m_source.l_linear.bias"]))


def _resblock(p, pre: str, x, k: int, dils):
    for i, d in enumerate(dils):
        xt = conv(snake(x, p[f"{pre}.act1_{i}.alpha"]),
                      weight_norm(p, f"{pre}.conv1_{i}"),
                      p[f"{pre}.conv1_{i}.bias"], dilation=d,
                      padding=(k * d - d) // 2)
        xt = conv(snake(xt, p[f"{pre}.act2_{i}.alpha"]),
                      weight_norm(p, f"{pre}.conv2_{i}"),
                      p[f"{pre}.conv2_{i}.bias"], padding=(k - 1) // 2)
        x = x + xt
    return x


def hift(h: Dict, p, mel: torch.Tensor, cache_source=None,
         draws=None):
    """HiFT: mel (1, T, n_mel) -> (wav (1, T * up), source (1, T * up, 1)).
    ``cache_source`` replaces the head of the excitation; ``draws`` the NSF
    draws (default: seeded 0 at this length)."""
    rates = h["upsample_rates"]
    up = math.prod(rates) * h["istft_hop_len"]
    x = mel
    for i in range(5):
        x = F.elu(conv(x, weight_norm(p, f"f0_predictor.cond{i}"),
                           p[f"f0_predictor.cond{i}.bias"], padding=1))
    f0 = F.linear(x, p["f0_predictor.classifier.weight"],
                    p["f0_predictor.classifier.bias"]).abs()
    f0 = torch.repeat_interleave(f0, up, dim=1)                 # (1, L, 1)
    if draws is None:
        draws = nsf_draws(h["nb_harmonics"] + 1, f0.shape[1], mel.device,
                          h["sampling_rate"] == 22050)
    s = _source(h, p, f0, *draws)
    if cache_source is not None and cache_source.shape[1] > 0:
        n = cache_source.shape[1]
        s = torch.cat([cache_source, s[:, n:]], dim=1)
    n_fft, hop = h["istft_n_fft"], h["istft_hop_len"]
    win = torch.hann_window(n_fft, periodic=True, device=mel.device)
    spec = torch.stft(s[..., 0], n_fft, hop, window=win, center=True,
                      return_complex=True)                       # (1, F, T')
    s_stft = torch.cat([spec.real, spec.imag], dim=1).transpose(1, 2)
    x = conv(mel, weight_norm(p, "conv_pre"), p["conv_pre.bias"],
                 padding=3)
    down = [1] + list(rates[::-1][:-1])
    cum = [math.prod(down[:i + 1]) for i in range(len(down))][::-1]
    kinds = list(zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))
    for i, (u, k) in enumerate(zip(rates, h["upsample_kernel_sizes"])):
        x = conv_t(F.leaky_relu(x, h["lrelu_slope"]),
                       weight_norm(p, f"ups_{i}"), p[f"ups_{i}.bias"],
                       stride=u, padding=(k - u) // 2)
        if i == len(rates) - 1:
            x = torch.cat([x[:, 1:2], x], dim=1)        # reflection pad (1, 0)
        sd = cum[i]
        if sd == 1:
            si = conv(s_stft, p[f"source_down_{i}.weight"],
                          p[f"source_down_{i}.bias"])
        else:
            si = conv(s_stft, p[f"source_down_{i}.weight"],
                          p[f"source_down_{i}.bias"], stride=sd,
                          padding=sd // 2)
        si = _resblock(p, f"source_res_{i}", si,
                       h["source_resblock_kernel_sizes"][i],
                       h["source_resblock_dilation_sizes"][i])
        x = x + si
        x = sum(_resblock(p, f"resblock_{i}_{j}", x, kk, dd)
                for j, (kk, dd) in enumerate(kinds)) / len(kinds)
    x = conv(F.leaky_relu(x, 0.01), weight_norm(p, "conv_post"),
                 p["conv_post.bias"], padding=3)
    nf = n_fft // 2 + 1
    mag = torch.clamp(torch.exp(x[..., :nf]), max=1e2)
    ph = torch.sin(x[..., nf:])
    spec = torch.complex(mag * torch.cos(ph), mag * torch.sin(ph))
    wav = torch.istft(spec.transpose(1, 2), n_fft, hop, window=win,
                      center=True)
    return torch.clamp(wav, -h["audio_limit"], h["audio_limit"]), s
