"""HiFT GAN fine-tuning in one process: the discriminators, the losses and
the two-turn train step, after the JAX package's ``training/gan.py``
(reference cosyvoice/hifigan/discriminator.py:15-230, hifigan.py:9-90,
utils/losses.py:6-22, matcha's HiFiGAN LSGAN losses).

- ``MultiPeriodDiscriminator``: HiFiGAN's periods 2/3/5/7/11;
- ``MultiResolutionDiscriminator``: DAC's ``DiscriminatorR`` over banded
  complex spectrograms at fft 2048 / 1024 / 512 (``ops/stft.py``);
- LSGAN generator / discriminator losses, feature matching x2, multi-mel
  L1 (x45), TPR (tau 0.04), f0 L1;
- ``make_gan_train_step``: the executor's alternating turns, the
  discriminator's then the generator's, each with its own optimizer.

The modules carry the JAX package's parameter names, so
``weights.discriminator_state_from_jax`` maps its params one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import stft as stft_ops
from ..ops.convs import Conv2d
from ..parallel.mesh import DataGroup
from .train_step import AdamW

LRELU = 0.1


class DiscriminatorP(nn.Module):
    """HiFiGAN period discriminator: audio folded into (T/p, p), then
    (5, 1)-kernel strided weight-norm Conv2d stacks."""

    def __init__(self, period: int,
                 channels: Sequence[int] = (32, 128, 512, 1024, 1024)):
        super().__init__()
        self.period = period
        self.n = len(channels)
        cin = 1
        for i, ch in enumerate(channels):
            stride = (3, 1) if i < len(channels) - 1 else (1, 1)
            self.add_module(f"conv_{i}", Conv2d(cin, ch, (5, 1), stride,
                                                (2, 0), weight_norm=True))
            cin = ch
        self.conv_post = Conv2d(cin, 1, (3, 1), (1, 1), (1, 0),
                                weight_norm=True)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        b, t = x.shape
        p = self.period
        pad = (-t) % p
        if pad:
            # torch reflect padding: the mirror excludes the edge sample
            x = torch.cat([x, x[:, t - 1 - pad:t - 1].flip(1)], dim=1)
        x = x.reshape(b, -1, p, 1)
        fmap = []
        for i in range(self.n):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), LRELU)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorR(nn.Module):
    """DAC resolution discriminator on banded complex spectrograms
    (discriminator.py:80-150)."""

    BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))

    def __init__(self, window_length: int, channels: int = 32,
                 hop_factor: float = 0.25):
        super().__init__()
        self.window_length = window_length
        self.hop = int(window_length * hop_factor)
        self.window = stft_ops.hann_window(window_length)
        n_bins = window_length // 2 + 1
        self.bands = [(int(lo * n_bins), int(hi * n_bins))
                      for lo, hi in self.BANDS]
        for bi in range(len(self.bands)):
            cin = 2
            for i in range(5):
                stride = (1, 2) if i in (1, 2, 3) else (1, 1)
                ks = (3, 9) if i < 4 else (3, 3)
                pad = (1, 4) if i < 4 else (1, 1)
                self.add_module(f"band{bi}_conv{i}", Conv2d(
                    cin, channels, ks, stride, pad, weight_norm=True))
                cin = channels
        self.conv_post = Conv2d(channels, 1, (3, 3), (1, 1), (1, 1),
                                weight_norm=True)

    def spectrogram(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T, F, 2): real and imaginary parts."""
        x = x - x.mean(dim=-1, keepdim=True)
        x = 0.8 * x / (x.abs().amax(dim=-1, keepdim=True) + 1e-9)
        real, imag = stft_ops.stft(x, self.window_length, self.hop,
                                   self.window)
        return torch.stack([real, imag], dim=-1)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        spec = self.spectrogram(x)
        fmap, outs = [], []
        for bi, (lo, hi) in enumerate(self.bands):
            h = spec[:, :, lo:hi, :]
            for i in range(5):
                h = F.leaky_relu(getattr(self, f"band{bi}_conv{i}")(h),
                                 LRELU)
                fmap.append(h)
            outs.append(h)
        x = self.conv_post(torch.cat(outs, dim=2))
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class _Multi(nn.Module):
    """Runs each sub-discriminator on the real and the generated audio."""

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for d in self.discs:
            o_r, f_r = d(y)
            o_g, f_g = d(y_hat)
            outs_r.append(o_r)
            outs_g.append(o_g)
            fmaps_r.append(f_r)
            fmaps_g.append(f_g)
        return outs_r, outs_g, fmaps_r, fmaps_g

    def _adds(self, mods):
        self.discs = []
        for i, m in enumerate(mods):
            self.add_module(f"disc_{i}", m)
            self.discs.append(m)


class MultiPeriodDiscriminator(_Multi):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self._adds([DiscriminatorP(p) for p in periods])


class MultiResolutionDiscriminator(_Multi):
    def __init__(self, fft_sizes: Sequence[int] = (2048, 1024, 512)):
        super().__init__()
        self._adds([DiscriminatorR(w) for w in fft_sizes])


class MultipleDiscriminator(nn.Module):
    """MPD ++ MRD (discriminator.py:15-35)."""

    def __init__(self):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator()
        self.mrd = MultiResolutionDiscriminator()

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        r1, g1, fr1, fg1 = self.mpd(y, y_hat)
        r2, g2, fr2, fg2 = self.mrd(y, y_hat)
        return r1 + r2, g1 + g2, fr1 + fr2, fg1 + fg2


# ------------------------------------------------------------------ losses
def generator_loss(disc_outputs: List[torch.Tensor]) -> torch.Tensor:
    return sum(torch.mean((1.0 - dg) ** 2) for dg in disc_outputs)


def discriminator_loss(real: List[torch.Tensor],
                       gen: List[torch.Tensor]) -> torch.Tensor:
    return sum(torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
               for dr, dg in zip(real, gen))


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    return 2.0 * sum(torch.mean(torch.abs(r - g))
                     for fr, fg in zip(fmap_r, fmap_g)
                     for r, g in zip(fr, fg))


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median of all elements; the mean of the middle two for an even
    count (``jnp.median``; ``torch.median`` returns the lower one)."""
    s = x.reshape(-1).sort().values
    n = s.numel()
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def tpr_loss(real: List[torch.Tensor], gen: List[torch.Tensor],
             tau: float) -> torch.Tensor:
    """Truncated pointwise relativistic loss (utils/losses.py:6-12)."""
    loss = 0.0
    for dr, dg in zip(real, gen):
        diff = dr - dg
        m = _median(diff)
        below = (diff < m).to(diff.dtype)
        l_rel = torch.sum((diff - m) ** 2 * below) / torch.clamp(
            below.sum(), min=1.0)
        loss = loss + tau - F.relu(tau - l_rel)
    return loss


def mel_l1_loss(real: torch.Tensor, gen: torch.Tensor,
                mel_transforms: Sequence[Callable]) -> torch.Tensor:
    return sum(torch.mean(torch.abs(t(gen) - t(real)))
               for t in mel_transforms)


# -------------------------------------------------------------- train step
@dataclasses.dataclass
class GanTrainState:
    """The generator-turn count, both modules (updated in place) and their
    optimizers."""
    step: int
    generator: nn.Module
    discriminator: nn.Module
    gen_opt: AdamW
    disc_opt: AdamW


# the NSF source's draws (rand_ini (1, H), noise (1, L, H)), or None for
# the generator's own (``HiFTGenerator.draws``)
Draws = Optional[Tuple[torch.Tensor, torch.Tensor]]


def discriminator_objective(generator: nn.Module, discriminator: nn.Module,
                            batch: Dict[str, torch.Tensor],
                            draws: Draws = None, tpr_weight: float = 1.0,
                            tpr_tau: float = 0.04) -> torch.Tensor:
    """The discriminator's turn's loss: LSGAN + TPR on the real speech and
    the generator's audio (no gradient reaches the generator)."""
    with torch.no_grad():
        wav, _ = generator.forward_train(batch["speech_feat"], draws)
    r, g, _, _ = discriminator(batch["speech"], wav)
    return discriminator_loss(r, g) + tpr_weight * tpr_loss(r, g, tpr_tau)


def generator_objective(generator: nn.Module, discriminator: nn.Module,
                        batch: Dict[str, torch.Tensor],
                        mel_transforms: Sequence[Callable],
                        draws: Draws = None, mel_weight: float = 45.0,
                        fm_weight: float = 2.0, tpr_weight: float = 1.0,
                        tpr_tau: float = 0.04
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The generator's turn's loss and its parts: adversarial + 2 x
    feature matching + 45 x mel L1 + TPR + f0 L1."""
    wav, f0 = generator.forward_train(batch["speech_feat"], draws)
    r, g, fr, fg = discriminator(batch["speech"], wav)
    parts = {"loss_gen": generator_loss(g),
             "loss_fm": feature_loss(fr, fg),
             "loss_mel": mel_l1_loss(batch["speech"], wav, mel_transforms),
             "loss_f0": torch.mean(torch.abs(f0 - batch["pitch_feat"]))}
    loss = (parts["loss_gen"] + fm_weight * parts["loss_fm"]
            + mel_weight * parts["loss_mel"]
            + tpr_weight * tpr_loss(g, r, tpr_tau) + parts["loss_f0"])
    return loss, parts


def make_gan_train_step(mel_transforms: Sequence[Callable],
                        mel_weight: float = 45.0, fm_weight: float = 2.0,
                        tpr_weight: float = 1.0, tpr_tau: float = 0.04,
                        dp: Optional[DataGroup] = None):
    """Returns ``(disc_step, gen_step)``, each ``(state, batch, draws=None)
    -> (state, metrics)``, the executor's alternating turns
    (executor.py:94-180).  batch: speech (B, L), speech_feat (B, T, n_mel),
    pitch_feat (B, T); ``draws``: the NSF source's ``(rand_ini, noise)``
    for ``HiFTGenerator.forward_train`` (default: the generator's own).

    ``dp`` (a ``parallel.mesh.DataGroup``; None for one process): each
    rank's turn runs on its rows and the gradients are averaged over the
    ranks, as the reference's DDP averages them; the TPR loss's median and
    the NSF draws stay each rank's own, so unlike the flow and LM steps
    this is not the single-process step on the global batch."""

    def average(opt: AdamW) -> None:
        if dp is None:
            return
        for p in opt.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            grads = [p.grad for p in opt.params]
            dp.sum_(grads)
            torch._foreach_div_(grads, dp.world)

    def mean(v: torch.Tensor) -> torch.Tensor:
        return v if dp is None else dp.sum(v) / dp.world

    def disc_step(state: GanTrainState, batch: Dict[str, torch.Tensor],
                  draws: Draws = None):
        opt = state.disc_opt
        opt.zero_grad()
        loss = discriminator_objective(state.generator, state.discriminator,
                                       batch, draws, tpr_weight, tpr_tau)
        loss.backward()
        average(opt)
        opt.step()
        return state, {"loss_disc": mean(loss.detach())}

    def gen_step(state: GanTrainState, batch: Dict[str, torch.Tensor],
                 draws: Draws = None):
        opt = state.gen_opt
        opt.zero_grad()
        loss, parts = generator_objective(
            state.generator, state.discriminator, batch, mel_transforms,
            draws, mel_weight, fm_weight, tpr_weight, tpr_tau)
        loss.backward()
        # the discriminator takes no update on the generator's turn
        state.discriminator.zero_grad(set_to_none=True)
        average(opt)
        opt.step()
        state.step += 1
        return state, {"loss": mean(loss.detach()),
                       **{k: mean(v.detach()) for k, v in parts.items()}}

    return disc_step, gen_step
