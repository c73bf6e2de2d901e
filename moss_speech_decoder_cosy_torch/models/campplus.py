"""CAM++ speaker embedding (a D-TDNN with context-aware masking), after the
JAX package's ``models/campplus.py``.

The reference runs ``campplus.onnx`` on the host as a feature: an 80-bin
Kaldi fbank, mean-normalized, to a 192-d x-vector that conditions the flow.
Here it is a PyTorch module on the codec's device with the public
``speakerlab`` CAM++ layout: an FCM 2-D front end, a TDNN stem, three
CAM dense-TDNN blocks with transit layers, statistics pooling and a dense
layer.  BatchNorm runs in inference mode on its running statistics.
Parameter names follow the JAX package's (``head.block0a.conv1``,
``block1_layer3.cam_layer.linear_local``, ...), the running statistics as
``running_mean`` / ``running_var`` buffers.  Loading ``campplus.onnx``
(``SpeakerEncoder.from_onnx``) waits for the port's ONNX reader (ROADMAP
A6).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.convs import Conv1d, Conv2d
from ..ops.melspec import kaldi_fbank
from ..utils.device import resolve_device


class BatchNorm(nn.Module):
    """Inference batch norm over the last axis: ``(x - running_mean) *
    rsqrt(running_var + eps) * weight + bias``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def seed_init(self, name, shape, g):
        """``weights.seeded_state``'s draws: weight ones, a running mean
        normal(0.1) and a running variance uniform in [0.5, 1.5], so that
        inference BatchNorm is not the identity."""
        if name == "weight":
            return torch.ones(shape)
        if name == "running_mean":
            return torch.randn(shape, generator=g) * 0.1
        if name == "running_var":
            return 0.5 + torch.rand(shape, generator=g)
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ((x - self.running_mean) * torch.rsqrt(self.running_var
                                                      + self.eps)
                * self.weight + self.bias)


def _out_len(n: int, stride: int) -> int:
    """Length after a k3, pad-1 conv of ``stride``."""
    return (n - 1) // stride + 1


class BasicResBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride=(1, 1)):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, (3, 3), stride, (1, 1),
                            use_bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, (3, 3), (1, 1), (1, 1),
                            use_bias=False)
        self.bn2 = BatchNorm(planes)
        self.shortcut = tuple(stride) != (1, 1) or in_planes != planes
        if self.shortcut:
            self.shortcut_conv = Conv2d(in_planes, planes, (1, 1), stride,
                                        use_bias=False)
            self.shortcut_bn = BatchNorm(planes)

    def forward(self, x):                        # (B, F, T, C)
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.shortcut:
            x = self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(h + x)


class FCM(nn.Module):
    """2-D conv front end: (B, T, F) -> (B, T, m_channels * F')."""

    def __init__(self, feat_dim: int = 80, m_channels: int = 32):
        super().__init__()
        m = m_channels
        self.conv1 = Conv2d(1, m, (3, 3), (1, 1), (1, 1), use_bias=False)
        self.bn1 = BatchNorm(m)
        for i in range(2):
            self.add_module(f"block{i}a", BasicResBlock(m, m, (2, 1)))
            self.add_module(f"block{i}b", BasicResBlock(m, m))
        self.conv2 = Conv2d(m, m, (3, 3), (2, 1), (1, 1), use_bias=False)
        self.bn2 = BatchNorm(m)
        f = feat_dim
        for _ in range(3):
            f = _out_len(f, 2)
        self.out_channels = m * f

    def forward(self, feat):                     # (B, T, F)
        x = feat.transpose(1, 2)[..., None]      # (B, F, T, 1)
        x = F.relu(self.bn1(self.conv1(x)))
        for i in range(2):
            x = getattr(self, f"block{i}b")(getattr(self, f"block{i}a")(x))
        x = F.relu(self.bn2(self.conv2(x)))
        b, f, t, c = x.shape
        return x.permute(0, 2, 1, 3).reshape(b, t, f * c)


class CAMLayer(nn.Module):
    """A local conv gated by the segment and global context."""

    def __init__(self, bn_channels: int, out_channels: int,
                 kernel_size: int, dilation: int, reduction: int = 2,
                 seg_len: int = 100):
        super().__init__()
        self.seg_len = seg_len
        self.linear_local = Conv1d(
            bn_channels, out_channels, kernel_size,
            padding=dilation * (kernel_size - 1) // 2, dilation=dilation,
            use_bias=False)
        self.linear1 = Conv1d(bn_channels, bn_channels // reduction, 1)
        self.linear2 = Conv1d(bn_channels // reduction, out_channels, 1)

    def forward(self, x):                        # (B, T, C)
        y = self.linear_local(x)
        context = x.mean(dim=1, keepdim=True) + self._seg_pooling(x)
        m = torch.sigmoid(self.linear2(F.relu(self.linear1(context))))
        return y * m

    def _seg_pooling(self, x):
        """Each frame gets its segment's mean; the last segment is padded
        with zeros, which its mean counts (as in the JAX package)."""
        b, t, c = x.shape
        n = -(-t // self.seg_len)
        xp = F.pad(x, (0, 0, 0, n * self.seg_len - t))
        seg = xp.reshape(b, n, self.seg_len, c).mean(dim=2)
        return torch.repeat_interleave(seg, self.seg_len, dim=1)[:, :t]


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, bn_channels: int,
                 kernel_size: int, dilation: int):
        super().__init__()
        self.bn1 = BatchNorm(in_channels)
        self.linear1 = Conv1d(in_channels, bn_channels, 1, use_bias=False)
        self.bn2 = BatchNorm(bn_channels)
        self.cam_layer = CAMLayer(bn_channels, growth_rate, kernel_size,
                                  dilation)

    def forward(self, x):
        h = self.linear1(F.relu(self.bn1(x)))
        return self.cam_layer(F.relu(self.bn2(h)))


class CAMPPlus(nn.Module):
    """(B, T, feat_dim) Kaldi fbank (mean-normalized) -> (B, embedding_size)
    x-vector.  The defaults are the released campplus_cn_common's."""

    def __init__(self, embedding_size: int = 192, growth_rate: int = 32,
                 bn_size: int = 4, init_channels: int = 128,
                 block_layers: Sequence[int] = (12, 24, 16),
                 block_dilations: Sequence[int] = (1, 2, 2),
                 feat_dim: int = 80, m_channels: int = 32):
        super().__init__()
        self.block_layers = tuple(block_layers)
        self.head = FCM(feat_dim, m_channels)
        self.tdnn_conv = Conv1d(self.head.out_channels, init_channels, 5,
                                stride=2, use_bias=False)
        self.tdnn_bn = BatchNorm(init_channels)
        c = init_channels
        for bi, (n_layers, dil) in enumerate(zip(block_layers,
                                                 block_dilations)):
            for li in range(n_layers):
                self.add_module(f"block{bi}_layer{li}", CAMDenseTDNNLayer(
                    c, growth_rate, bn_size * growth_rate, 3, dil))
                c += growth_rate
            self.add_module(f"transit{bi}_bn", BatchNorm(c))
            self.add_module(f"transit{bi}_conv",
                            Conv1d(c, c // 2, 1, use_bias=False))
            c //= 2
        self.out_bn = BatchNorm(c)
        self.dense = nn.Linear(2 * c, embedding_size)
        self.dense_bn = BatchNorm(embedding_size)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = F.pad(self.head(feat), (0, 0, 2, 2))
        x = F.relu(self.tdnn_bn(self.tdnn_conv(x)))
        for bi, n_layers in enumerate(self.block_layers):
            for li in range(n_layers):
                h = getattr(self, f"block{bi}_layer{li}")(x)
                x = torch.cat([x, h], dim=-1)
            x = F.relu(getattr(self, f"transit{bi}_bn")(x))
            x = getattr(self, f"transit{bi}_conv")(x)
        x = F.relu(self.out_bn(x))
        stats = torch.cat([x.mean(dim=1), x.std(dim=1, correction=0)],
                          dim=-1)
        return self.dense_bn(self.dense(stats))


class SpeakerEncoder:
    """wav at 16 kHz -> x-vector (1, embedding_size), with the reference's
    preprocessing: an 80-bin Kaldi fbank, then per-utterance mean
    subtraction (whisper_encoder_decoder.py:197-206).  ``state`` a state
    dict of ``model`` (default ``CAMPPlus()``); runs on ``device`` (CUDA
    unless the caller passes ``device="cpu"``)."""

    def __init__(self, state, model: CAMPPlus = None, device=None):
        self.device = resolve_device(device)
        if model is None:
            with torch.device("meta"):
                model = CAMPPlus()
        model.load_state_dict(state, strict=True, assign=True)
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def embed(self, wav_16k) -> torch.Tensor:
        """The x-vector on the device."""
        wav = torch.as_tensor(np.asarray(wav_16k, np.float32).reshape(1, -1)
                              ).to(self.device)
        feat = kaldi_fbank(wav)
        return self.model(feat - feat.mean(dim=1, keepdim=True))

    def __call__(self, wav_16k) -> np.ndarray:
        return self.embed(wav_16k).float().cpu().numpy()

    @classmethod
    def from_onnx(cls, path, model: CAMPPlus = None,
                  device=None) -> "SpeakerEncoder":
        """The reference's ``campplus.onnx`` (GLM_modules/
        flow_inference.py:86-89): its initializers through
        ``utils.checkpoint.convert_campplus_state_dict`` into ``model``
        (default ``CAMPPlus()``), run by the port."""
        from ..utils.checkpoint import convert_campplus_state_dict
        from ..utils.onnx_io import load_onnx_initializers
        if model is None:
            with torch.device("meta"):
                model = CAMPPlus()
        state, unused = convert_campplus_state_dict(
            load_onnx_initializers(path), model.block_layers)
        if unused:
            import logging
            logging.getLogger(__name__).warning(
                "campplus.onnx: %d unused initializers (e.g. %s)",
                len(unused), unused[:3])
        return cls(state, model, device=device)
