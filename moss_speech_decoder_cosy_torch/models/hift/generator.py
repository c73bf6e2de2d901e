"""HiFT vocoder (neural source filter + iSTFT head), after the JAX package's
``models/hift/generator.py`` (reference cosyvoice/hifigan/generator.py:
392-582):

    mel (B, T, 80) -> f0 predictor -> NSF harmonic source (cumsum phase)
    -> conv_pre -> [lrelu -> ConvTranspose up -> (+ STFT'd source branch)
    -> Snake ResBlocks] x N -> conv_post -> exp(mag)/sin(phase)
    -> iSTFT (n_fft 16, hop 4) -> clamp(+-0.99)

The NSF source draws a random initial phase per harmonic and Gaussian noise.
They are injectable as ``(rand_ini, noise)``; by default they come from a
``torch.Generator`` on the model's device seeded 0 on every call, the
counterpart of the JAX package's fixed ``PRNGKey(0)`` per call (torch and JAX
draw different numbers from the same seed).  At 22.05 kHz the source is
``SourceModuleHnNSF`` (phase integrated at the audio rate, ``rand_ini`` a
phase uniform in [-pi, pi)); at any other rate ``SourceModuleHnNSF2``
(phase integrated at the frame rate, ``rand_ini`` uniform in [0, 1)).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import stft as stft_ops
from ...ops.activations import Snake
from ...ops.convs import Conv1d, ConvTranspose1d
from ...utils.config import HiFTConfig

# (harmonics, samples, device) -> (rand_ini (1, H), noise (1, L, H))
DrawFn = Callable[[int, int, torch.device],
                  Tuple[torch.Tensor, torch.Tensor]]


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def linear_interpolate(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False) on (B, T, C), with
    the JAX package's f32 position arithmetic."""
    in_len = x.shape[1]
    scale = in_len / out_len
    pos = (torch.arange(out_len, device=x.device, dtype=torch.float32)
           + 0.5) * scale - 0.5
    pos = torch.clamp(pos, 0.0, in_len - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=in_len - 1)
    w = (pos - lo)[None, :, None].to(x.dtype)
    return x[:, lo] * (1.0 - w) + x[:, hi] * w


def seeded_draws(harmonics: int, length: int, device) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """The default NSF draws: a generator on ``device`` seeded 0."""
    g = torch.Generator(device=device)
    g.manual_seed(0)
    rand_ini = torch.rand((1, harmonics), generator=g, device=device)
    noise = torch.randn((1, length, harmonics), generator=g, device=device)
    return rand_ini, noise


def seeded_phase_draws(harmonics: int, length: int, device) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """The 22.05 kHz source's default draws: a generator on ``device``
    seeded 0; the initial phases uniform in [-pi, pi)."""
    rand_ini, noise = seeded_draws(harmonics, length, device)
    return (rand_ini * 2.0 - 1.0) * np.pi, noise


class ConvRNNF0Predictor(nn.Module):
    """5x (weight-norm conv k3 'same' + ELU) + linear head -> |f0|."""

    def __init__(self, in_channels: int, cond_channels: int = 512):
        super().__init__()
        for i in range(5):
            self.add_module(f"cond{i}", Conv1d(
                in_channels if i == 0 else cond_channels, cond_channels, 3,
                padding=1, weight_norm=True))
        self.classifier = nn.Linear(cond_channels, 1)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel
        for i in range(5):
            x = F.elu(getattr(self, f"cond{i}")(x))
        return torch.abs(self.classifier(x)[..., 0])        # (B, T)


class SourceModuleHnNSF2(nn.Module):
    """Harmonic-plus-noise source for non-22.05 kHz rates (reference
    generator.py:246-389): per-harmonic phases integrated at frame rate
    (along a contiguous axis) and linearly re-upsampled, uv gating, noise;
    f32 throughout.  Returns the merged single-channel excitation (B, L,
    1)."""

    def __init__(self, cfg: HiFTConfig):
        super().__init__()
        self.cfg = cfg
        self.l_linear = nn.Linear(cfg.nb_harmonics + 1, 1)

    def forward(self, f0: torch.Tensor, rand_ini: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        """f0 (B, L, 1); rand_ini (1, H) uniform draws (the fundamental's
        entry is zeroed here); noise (1, L, H) standard normal."""
        cfg = self.cfg
        h = cfg.nb_harmonics + 1
        up = cfg.total_upsample
        f0 = f0.float()
        length = f0.shape[1]
        fn = f0 * torch.arange(1, h + 1, dtype=torch.float32,
                               device=f0.device)[None, None, :]
        rad = torch.remainder(fn / cfg.sampling_rate, 1.0)
        rand_ini = rand_ini.float().clone()
        rand_ini[:, 0] = 0.0
        rad = torch.cat([rad[:, :1] + rand_ini[:, None, :], rad[:, 1:]],
                        dim=1)
        rad_low = linear_interpolate(rad, length // up)
        # the scan runs along the innermost axis, as ``SourceModuleHnNSF``'s:
        # over the strided frame axis the card's f32 cumsum drifted 5.8e-5
        # cycles from a float64 sum over 30 s (x480 below: 0.028 cycles of
        # phase; the source 0.018 off the CPU's), over a contiguous one
        # 6.9e-6, the CPU's 3.8e-6 (chip_smoke.py's cross_hift, an H100)
        cycles = torch.cumsum(rad_low.transpose(1, 2).contiguous(), dim=-1)
        phase_low = cycles.transpose(1, 2) * 2.0 * np.pi
        phase = linear_interpolate(phase_low * up, length)
        sines = torch.sin(phase) * cfg.nsf_alpha

        uv = (f0 > cfg.nsf_voiced_threshold).float()
        noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
        sine_waves = sines * uv + noise_amp * noise.float()
        return torch.tanh(F.linear(sine_waves, self.l_linear.weight.float(),
                                   self.l_linear.bias.float()))


class SourceModuleHnNSF(nn.Module):
    """The 22.05 kHz harmonic-plus-noise source (reference generator.py:
    109-232, SineGen + SourceModuleHnNSF): each harmonic's phase integrated
    at the audio rate, theta = 2 pi cumsum(f0 h / sr mod 1), plus a fixed
    initial phase; uv gating and noise as the 24 kHz source; f32
    throughout, in the JAX package's order of operations (mod, cumsum,
    then + phase).  Returns the merged excitation (B, L, 1).

    Over long audio theta grows to 1e5-1e6 rad, where one f32 ulp is
    0.01-0.06 rad: a parallel scan (the card) and a sequential one (the
    CPU) then give visibly different sines.  The cumsum runs along a
    contiguous time axis, where the card's scan is accurate."""

    def __init__(self, cfg: HiFTConfig):
        super().__init__()
        self.cfg = cfg
        self.l_linear = nn.Linear(cfg.nb_harmonics + 1, 1)

    def forward(self, f0: torch.Tensor, rand_ini: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        """f0 (B, L, 1); rand_ini (1, H) initial phases (the fundamental's
        entry is zeroed here); noise (1, L, H) standard normal."""
        cfg = self.cfg
        h = cfg.nb_harmonics + 1
        f0 = f0.float()
        fn = f0 * torch.arange(1, h + 1, dtype=torch.float32,
                               device=f0.device)[None, None, :]
        rad = torch.remainder(fn / cfg.sampling_rate, 1.0)
        # the scan runs along the innermost axis: PyTorch's CUDA cumsum over
        # a strided axis drifted 0.107 cycles from a float64 sum over 22,050
        # samples on an H100, over a contiguous one 4.8e-4, the CPU's 6.1e-5
        # (chip_smoke.py's cross_v1)
        cycles = torch.cumsum(rad.transpose(1, 2).contiguous(), dim=-1)
        theta = 2.0 * np.pi * cycles.transpose(1, 2)
        phase = rand_ini.float().reshape(1, 1, h).clone()
        phase[..., 0] = 0.0
        sines = cfg.nsf_alpha * torch.sin(theta + phase)
        uv = (f0 > cfg.nsf_voiced_threshold).float()
        noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
        sine_waves = sines * uv + noise_amp * noise.float()
        return torch.tanh(F.linear(sine_waves, self.l_linear.weight.float(),
                                   self.l_linear.bias.float()))


class ResBlock(nn.Module):
    """Dilated residual block with Snake activations."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Tuple[int, ...]):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"act1_{i}", Snake(channels))
            self.add_module(f"conv1_{i}", Conv1d(
                channels, channels, kernel_size, dilation=d,
                padding=get_padding(kernel_size, d), weight_norm=True))
            self.add_module(f"act2_{i}", Snake(channels))
            self.add_module(f"conv2_{i}", Conv1d(
                channels, channels, kernel_size,
                padding=get_padding(kernel_size, 1), weight_norm=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            xt = getattr(self, f"conv1_{i}")(getattr(self, f"act1_{i}")(x))
            xt = getattr(self, f"conv2_{i}")(getattr(self, f"act2_{i}")(xt))
            x = x + xt
        return x


class HiFTGenerator(nn.Module):
    def __init__(self, cfg: HiFTConfig):
        super().__init__()
        self.cfg = cfg
        base = cfg.base_channels
        self.f0_predictor = ConvRNNF0Predictor(cfg.in_channels,
                                               cfg.f0_cond_channels)
        # CosyVoice keeps the original source at 22.05 kHz (generator.py:429)
        v1 = cfg.sampling_rate == 22050
        self.m_source = SourceModuleHnNSF(cfg) if v1 else \
            SourceModuleHnNSF2(cfg)
        self.conv_pre = Conv1d(cfg.in_channels, base, 7, padding=3,
                               weight_norm=True)
        self.ups: List[nn.Module] = []
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            self.ups.append(self._add(f"ups_{i}", ConvTranspose1d(
                base // 2 ** i, base // 2 ** (i + 1), k, u,
                padding=(k - u) // 2, weight_norm=True)))

        # source branch downsamplers (reference generator.py:466-486)
        n_stft = cfg.istft_n_fft + 2
        down_rates = (1,) + tuple(cfg.upsample_rates[::-1][:-1])
        cum = np.cumprod(down_rates)[::-1]
        self.source_downs: List[nn.Module] = []
        self.source_resblocks: List[nn.Module] = []
        for i, (u, k, d) in enumerate(zip(
                cum, cfg.source_resblock_kernel_sizes,
                cfg.source_resblock_dilation_sizes)):
            ch = base // 2 ** (i + 1)
            u = int(u)
            down = (Conv1d(n_stft, ch, 1) if u == 1 else
                    Conv1d(n_stft, ch, u * 2, stride=u, padding=u // 2))
            self.source_downs.append(self._add(f"source_down_{i}", down))
            self.source_resblocks.append(self._add(
                f"source_res_{i}", ResBlock(ch, k, tuple(d))))

        self.resblocks: List[nn.Module] = []
        for i in range(len(self.ups)):
            ch = base // 2 ** (i + 1)
            for j, (k, d) in enumerate(zip(cfg.resblock_kernel_sizes,
                                           cfg.resblock_dilation_sizes)):
                self.resblocks.append(self._add(
                    f"resblock_{i}_{j}", ResBlock(ch, k, tuple(d))))
        last = base // 2 ** len(self.ups)
        self.conv_post = Conv1d(last, cfg.istft_n_fft + 2, 7, padding=3,
                                weight_norm=True)
        self._window = stft_ops.hann_window(cfg.istft_n_fft)
        self.draws: DrawFn = seeded_phase_draws if v1 else seeded_draws

    def _add(self, name: str, module: nn.Module) -> nn.Module:
        # children carry the JAX package's parameter names (weights.py)
        self.add_module(name, module)
        return module

    def _source_stft(self, s: torch.Tensor) -> torch.Tensor:
        real, imag = stft_ops.stft(s[..., 0], self.cfg.istft_n_fft,
                                   self.cfg.istft_hop_len, self._window)
        return torch.cat([real, imag], dim=-1)       # (B, T'', n_fft+2)

    def decode(self, mel: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """mel (B, T, n_mel), source s (B, T*up, 1) -> wav (B, T*up) f32."""
        cfg = self.cfg
        s_stft = self._source_stft(s).to(mel.dtype)
        x = self.conv_pre(mel)
        nk = len(cfg.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, cfg.lrelu_slope))
            if i == len(self.ups) - 1:
                x = torch.cat([x[:, 1:2], x], dim=1)  # ReflectionPad1d((1,0))
            si = self.source_resblocks[i](self.source_downs[i](s_stft))
            x = x + si
            xs = None
            for j in range(nk):
                r = self.resblocks[i * nk + j](x)
                xs = r if xs is None else xs + r
            x = xs / nk
        x = self.conv_post(F.leaky_relu(x, 0.01))
        f = cfg.istft_n_fft // 2 + 1
        magnitude = torch.clamp(torch.exp(x[..., :f]), max=1e2)
        phase = torch.sin(x[..., f:])
        wav = stft_ops.istft(magnitude * torch.cos(phase),
                             magnitude * torch.sin(phase), cfg.istft_n_fft,
                             cfg.istft_hop_len, self._window)
        return torch.clamp(wav, -cfg.audio_limit, cfg.audio_limit)

    def source(self, mel: torch.Tensor,
               draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
        """mel -> NSF excitation (B, T*up, 1) f32."""
        f0 = self.f0_predictor(mel)
        s = torch.repeat_interleave(f0[:, :, None], self.cfg.total_upsample,
                                    dim=1)
        if draws is None:
            draws = self.draws(self.cfg.nb_harmonics + 1, s.shape[1],
                               mel.device)
        return self.m_source(s, *draws)

    def forward(self, mel: torch.Tensor,
                cache_source: Optional[torch.Tensor] = None,
                draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """inference(speech_feat, cache_source) -> (wav, source).
        cache_source (B, S, 1) overwrites the first S source samples."""
        s = self.source(mel, draws)
        if cache_source is not None and cache_source.shape[1] > 0:
            n = cache_source.shape[1]
            s = torch.cat([cache_source.to(s.dtype), s[:, n:]], dim=1)
        return self.decode(mel, s), s
