"""Upsample conformer encoder: speech tokens -> mel-rate features, after the
JAX package's ``models/flow/encoder.py`` (reference
cosyvoice/transformer/upsample_encoder.py:105-321):

    linear embed (x sqrt(d)) -> PreLookaheadLayer -> N conformer blocks ->
    nearest x`stride` upsample + causal conv -> re-embed -> M conformer
    blocks -> LayerNorm

The conformer layer also has the macaron feed-forward (0.5 scale) and the
conv module (GLU, depthwise conv, layer or batch norm) of the wenet layer,
which the CosyVoice-v1 encoders (``flow_v1.py``) may enable.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.activations import get_activation
from ...ops.attention import RelPositionMultiHeadedAttention
from ...ops.convs import Conv1d
from ...ops.embeddings import espnet_rel_pos, wenet_rel_pos
from ...ops.masks import chunk_attention_mask
from ...ops.norms import LayerNorm
from ...utils.config import EncoderConfig

# a dropout (``ops/dropout.Dropout``) in the training forward, else None
Drop = Optional[Callable[[torch.Tensor], torch.Tensor]]


class LinearEmbed(nn.Module):
    """LinearNoSubsampling: Linear + LayerNorm(1e-5), then x * sqrt(d).
    ``relu=True``: LegacyLinearNoSubsampling (a ReLU after the norm, the v1
    TransformerLM's ``linear_legacy`` input layer)."""

    def __init__(self, in_features: int, output_size: int,
                 relu: bool = False):
        super().__init__()
        self.output_size = output_size
        self.relu = relu
        self.linear = nn.Linear(in_features, output_size)
        self.norm = LayerNorm(output_size, eps=1e-5)

    def forward(self, x: torch.Tensor, drop: Drop = None) -> torch.Tensor:
        x = self.norm(self.linear(x))
        if drop is not None:
            x = drop(x)
        if self.relu:
            x = F.relu(x)
        # a device fill, not an upload, so a captured step can run it
        return x * torch.full((), self.output_size, dtype=x.dtype,
                              device=x.device).sqrt()


class PreLookaheadLayer(nn.Module):
    """conv1 (kernel la+1, la tokens of lookahead or explicit context) ->
    leaky_relu -> causal conv2 k3 -> +residual."""

    def __init__(self, channels: int, pre_lookahead_len: int = 3):
        super().__init__()
        self.la = pre_lookahead_len
        self.conv1 = Conv1d(channels, channels, pre_lookahead_len + 1)
        self.conv2 = Conv1d(channels, channels, 3)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if context is None:
            h = F.pad(x, (0, 0, 0, self.la))
        else:
            assert context.shape[1] == self.la
            h = torch.cat([x, context], dim=1)
        h = F.leaky_relu(self.conv1(h), 0.01)
        h = self.conv2(F.pad(h, (0, 0, 2, 0)))
        return h + x


class ConvolutionModule(nn.Module):
    """Conformer conv module (reference transformer/convolution.py:24-145):
    pointwise conv to 2C -> GLU -> depthwise conv k (same padding, or
    ``causal`` left padding) -> layer norm or batch norm -> activation ->
    pointwise conv, the input and output zeroed where ``pad_mask`` is False.

    ``norm="batch_norm"`` is torch ``BatchNorm1d`` in eval mode: ``weight``
    and ``bias`` parameters and the ``running_mean`` / ``running_var``
    buffers (parameters in the JAX package)."""

    def __init__(self, channels: int, kernel_size: int = 15,
                 activation: str = "swish", causal: bool = False,
                 norm: str = "layer_norm"):
        super().__init__()
        self.causal = causal
        self.kernel_size = kernel_size
        self.batch_norm = norm == "batch_norm"
        self.act = get_activation(activation)
        self.pointwise_conv1 = Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = Conv1d(
            channels, channels, kernel_size,
            padding=0 if causal else (kernel_size - 1) // 2, groups=channels)
        if self.batch_norm:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))
        else:
            self.norm = LayerNorm(channels, eps=1e-5)
        self.pointwise_conv2 = Conv1d(channels, channels, 1)

    def seed_init(self, name: str, shape, g: torch.Generator):
        """``weights.seeded_state``: batch-norm statistics drawn (means
        normal(0.1), variances in [0.5, 1.5)), its scale ones."""
        if name == "running_mean":
            return torch.randn(shape, generator=g) * 0.1
        if name == "running_var":
            return 0.5 + torch.rand(shape, generator=g)
        if name == "weight":
            return torch.ones(shape)
        return None

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor
                ) -> torch.Tensor:
        m = pad_mask[..., None].to(x.dtype)
        h = self.pointwise_conv1(x * m)
        a, b = h.chunk(2, dim=-1)
        h = a * torch.sigmoid(b)                          # GLU
        if self.causal:
            h = F.pad(h, (0, 0, self.kernel_size - 1, 0))
        h = self.depthwise_conv(h)
        if self.batch_norm:
            inv = torch.rsqrt(self.running_var + 1e-5).to(h.dtype)
            h = ((h - self.running_mean.to(h.dtype)) * inv
                 * self.weight.to(h.dtype) + self.bias.to(h.dtype))
        else:
            h = self.norm(h)
        return self.pointwise_conv2(self.act(h)) * m


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, activation: str = "swish"):
        super().__init__()
        self.w_1 = nn.Linear(dim, hidden)
        self.w_2 = nn.Linear(hidden, dim)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, drop: Drop = None) -> torch.Tensor:
        h = self.act(self.w_1(x))
        return self.w_2(h if drop is None else drop(h))


class ConformerEncoderLayer(nn.Module):
    """Pre-LN conformer layer (reference transformer/encoder_layer.py:
    110-236): [macaron FF x 0.5] -> rel-pos self-attention -> [conv module]
    -> FF (x 0.5 with macaron) -> [final LayerNorm with the conv module]."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        d = cfg.output_size
        self.macaron = cfg.macaron_style
        self.conv = cfg.use_cnn_module
        if self.macaron:
            self.norm_ff_macaron = LayerNorm(d, eps=1e-12)
            self.ff_macaron = FeedForward(d, cfg.linear_units,
                                          cfg.activation)
        self.norm_mha = LayerNorm(d, eps=1e-12)
        self.self_attn = RelPositionMultiHeadedAttention(
            cfg.attention_heads, d, cfg.key_bias)
        if self.conv:
            self.norm_conv = LayerNorm(d, eps=1e-12)
            self.conv_module = ConvolutionModule(
                d, cfg.cnn_module_kernel, cfg.activation, cfg.cnn_causal,
                cfg.cnn_module_norm)
            self.norm_final = LayerNorm(d, eps=1e-12)
        self.norm_ff = LayerNorm(d, eps=1e-12)
        self.feed_forward = FeedForward(d, cfg.linear_units, cfg.activation)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                pos_emb: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                drop: Drop = None) -> torch.Tensor:
        """``pad_mask`` bool (B, T), needed only by the conv module;
        ``drop`` the feed-forwards' dropout (training)."""
        if self.macaron:
            x = x + 0.5 * self.ff_macaron(self.norm_ff_macaron(x), drop)
        x = x + self.self_attn(self.norm_mha(x), pos_emb, attn_mask)
        if self.conv:
            x = x + self.conv_module(self.norm_conv(x), pad_mask)
        x = x + (0.5 if self.macaron else 1.0) * self.feed_forward(
            self.norm_ff(x), drop)
        return self.norm_final(x) if self.conv else x


class Upsample1D(nn.Module):
    """Nearest x`stride` + left-padded conv k=2*stride+1."""

    def __init__(self, channels: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv = Conv1d(channels, channels, 2 * stride + 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.repeat_interleave(x, self.stride, dim=1)
        return self.conv(F.pad(x, (0, 0, 2 * self.stride, 0)))


class UpsampleConformerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.output_size
        self.embed = LinearEmbed(cfg.input_size, d)
        self.pre_lookahead_layer = PreLookaheadLayer(d, cfg.pre_lookahead_len)
        self.encoders = [self._add(f"encoders_{i}", ConformerEncoderLayer(cfg))
                         for i in range(cfg.num_blocks)]
        self.up_layer = Upsample1D(d, cfg.upsample_stride)
        self.up_embed = LinearEmbed(d, d)
        self.up_encoders = [
            self._add(f"up_encoders_{i}", ConformerEncoderLayer(cfg))
            for i in range(cfg.num_up_blocks)]
        self.after_norm = LayerNorm(d, eps=1e-5)

    def _add(self, name: str, module: nn.Module) -> nn.Module:
        # children carry the JAX package's parameter names (weights.py)
        self.add_module(name, module)
        return module

    def _rel_pos(self, size: int, device) -> torch.Tensor:
        if self.cfg.pos_enc_layer_type == "rel_pos_espnet":
            return espnet_rel_pos(size, self.cfg.output_size, device=device)
        return wenet_rel_pos(size, self.cfg.output_size, device=device)

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                streaming: bool = False, drop: Drop = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: embedded tokens (B, T, input_size); valid bool (B, T);
        ``drop`` the training forward's dropout (the embeddings and the
        feed-forwards, as the JAX package places it).
        Returns (features (B, T*stride, output_size), valid_up)."""
        c = self.cfg
        t = x.shape[1]
        x = self.embed(x, drop)
        pos = self._rel_pos(t, x.device).to(x.dtype)
        if context is not None:
            context = self.embed(context, drop)
        chunk = c.static_chunk_size if streaming else 0
        attn_mask = chunk_attention_mask(valid, chunk)

        x = self.pre_lookahead_layer(x, context)
        for layer in self.encoders:
            x = layer(x, attn_mask, pos, valid, drop)

        x = self.up_layer(x)
        valid_up = torch.repeat_interleave(valid, c.upsample_stride, dim=1)
        x = self.up_embed(x, drop)
        pos_up = self._rel_pos(t * c.upsample_stride, x.device).to(x.dtype)
        attn_mask_up = chunk_attention_mask(
            valid_up, chunk * c.upsample_stride if streaming else 0)
        for layer in self.up_encoders:
            x = layer(x, attn_mask_up, pos_up, valid_up, drop)
        return self.after_norm(x), valid_up
