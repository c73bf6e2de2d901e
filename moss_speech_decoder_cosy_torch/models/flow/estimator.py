"""Causal U-Net flow estimator (the CFM velocity network), after the JAX
package's ``models/flow/estimator.py`` (reference
cosyvoice/flow/decoder.py:294-494 and the Matcha blocks it imports).

All tensors are (B, T, C).  With ``EstimatorConfig.use_flash_attention``
every transformer block runs the flash chunk-attention kernel with the
analytic mask; T is not padded (the kernel masks its ragged edge), and the
output is NaN-poisoned when any row is right-padded, since the kernel's key
mask covers only the scalar length.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ...ops.activations import get_activation, mish
from ...ops.attention import UNetAttention
from ...ops.convs import CausalConv1d, Conv1d, ConvTranspose1d
from ...ops.embeddings import SinusoidalPosEmb, TimestepEmbedding
from ...ops.masks import chunk_attention_mask, mask_to_bias
from ...ops.norms import GroupNorm, LayerNorm
from ...utils.config import EstimatorConfig


class CausalBlock1D(nn.Module):
    """CausalConv1d k3 -> LayerNorm -> Mish."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = CausalConv1d(dim_in, dim_out, 3)
        self.norm = LayerNorm(dim_out, eps=1e-5)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask[..., None].to(x.dtype)
        return mish(self.norm(self.conv(x * m))) * m


class Block1D(nn.Module):
    """Conv k3 same -> GroupNorm(8) -> Mish (the non-causal matcha block)."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.conv = Conv1d(dim_in, dim_out, 3, padding=1)
        self.norm = GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask[..., None].to(x.dtype)
        return mish(self.norm(self.conv(x * m))) * m


class CausalResnetBlock1D(nn.Module):
    """block1 -> +time-emb -> block2 -> +res_conv(x)."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int,
                 causal: bool = True):
        super().__init__()
        block = CausalBlock1D if causal else Block1D
        self.block1 = block(dim_in, dim_out)
        self.mlp = nn.Linear(time_dim, dim_out)
        self.block2 = block(dim_out, dim_out)
        self.res_conv = Conv1d(dim_in, dim_out, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                t_emb: torch.Tensor) -> torch.Tensor:
        h = self.block1(x, mask)
        h = h + self.mlp(mish(t_emb))[:, None, :]
        h = self.block2(h, mask)
        return h + self.res_conv(x * mask[..., None].to(x.dtype))


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> +res, LN -> FF(GELU) -> +res."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 act_fn: str = "gelu", ff_mult: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = UNetAttention(dim, num_heads, head_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff_proj = nn.Linear(dim, dim * ff_mult)
        self.ff_out = nn.Linear(dim * ff_mult, dim)
        self.act = get_activation(act_fn)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None,
                flash_chunk: int = -1) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), attn_bias, flash_chunk)
        return x + self.ff_out(self.act(self.ff_proj(self.norm3(x))))


class Downsample1D(nn.Module):
    """Conv k3 stride 2 pad 1."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = Conv1d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class TransposeUpsample1D(nn.Module):
    """ConvTranspose k4 s2 p1."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = ConvTranspose1d(dim, dim, 4, 2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class CausalConditionalDecoder(nn.Module):
    def __init__(self, cfg: EstimatorConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        chans = tuple(c.channels)
        time_dim = chans[0] * 4
        self.time_embeddings = SinusoidalPosEmb(c.in_channels)
        self.time_mlp = TimestepEmbedding(c.in_channels, time_dim)

        def tf_blocks(prefix: str, ch: int) -> List[nn.Module]:
            return [self._add(f"{prefix}_{j}", BasicTransformerBlock(
                ch, c.num_heads, c.attention_head_dim, c.act_fn))
                for j in range(c.n_blocks)]

        def out_conv(name: str, ch: int) -> nn.Module:
            mod = (CausalConv1d(ch, ch, 3) if c.causal
                   else Conv1d(ch, ch, 3, padding=1))
            return self._add(name, mod)

        # down path (reference decoder.py:427-448)
        self.down = []
        ch_in = c.in_channels
        for i, ch in enumerate(chans):
            is_last = i == len(chans) - 1
            res = self._add(f"down_res_{i}", CausalResnetBlock1D(
                ch_in, ch, time_dim, c.causal))
            tfs = tf_blocks(f"down_tf_{i}", ch)
            conv = (out_conv(f"down_conv_{i}", ch) if is_last
                    else self._add(f"down_conv_{i}", Downsample1D(ch)))
            self.down.append((res, tfs, conv))
            ch_in = ch
        # mid blocks
        self.mid = [(self._add(f"mid_res_{i}", CausalResnetBlock1D(
            chans[-1], chans[-1], time_dim, c.causal)),
            tf_blocks(f"mid_tf_{i}", chans[-1]))
            for i in range(c.num_mid_blocks)]
        # up path with skip connections
        up_chans = chans[::-1] + (chans[0],)
        self.up = []
        for i in range(len(up_chans) - 1):
            out_ch = up_chans[i + 1]
            is_last = i == len(up_chans) - 2
            res = self._add(f"up_res_{i}", CausalResnetBlock1D(
                up_chans[i] + chans[::-1][i], out_ch, time_dim, c.causal))
            tfs = tf_blocks(f"up_tf_{i}", out_ch)
            conv = (out_conv(f"up_conv_{i}", out_ch) if is_last
                    else self._add(f"up_conv_{i}",
                                   TransposeUpsample1D(out_ch)))
            self.up.append((res, tfs, conv))
        block = CausalBlock1D if c.causal else Block1D
        self.final_block = block(up_chans[-1], up_chans[-1])
        self.final_proj = Conv1d(up_chans[-1], c.out_channels, 1)

    def _add(self, name: str, module: nn.Module) -> nn.Module:
        # children carry the JAX package's parameter names (weights.py)
        self.add_module(name, module)
        return module

    def _attn_bias(self, valid: torch.Tensor, streaming: bool, dtype
                   ) -> Tuple[Optional[torch.Tensor], int]:
        """(bias or None, flash_chunk): the flash kernel applies the
        chunk-causal mask itself."""
        c = self.cfg
        chunk = c.static_chunk_size if streaming else 0
        if c.use_flash_attention:
            return None, chunk
        m = chunk_attention_mask(valid, chunk, c.num_left_chunks)
        return mask_to_bias(m, dtype), -1

    def forward(self, x: torch.Tensor, valid: torch.Tensor, mu: torch.Tensor,
                t: torch.Tensor, spks: torch.Tensor, cond: torch.Tensor,
                streaming: bool = False) -> torch.Tensor:
        """x, mu, cond (B, T, n_mel); valid bool (B, T); t (B,);
        spks (B, n_mel).  Returns the velocity (B, T, n_mel)."""
        c = self.cfg
        t_emb = self.time_mlp(self.time_embeddings(t).to(x.dtype))
        spks_b = spks[:, None, :].expand(x.shape[0], x.shape[1],
                                         spks.shape[-1])
        h = torch.cat([x, mu, spks_b, cond], dim=-1)

        def mask3(m):
            return m[..., None].to(h.dtype)

        hiddens, masks = [], [valid]
        for i, (res, tfs, conv) in enumerate(self.down):
            is_last = i == len(self.down) - 1
            m = masks[-1]
            h = res(h, m, t_emb)
            bias, fchunk = self._attn_bias(m, streaming, h.dtype)
            for blk in tfs:
                h = blk(h, bias, fchunk)
            hiddens.append(h)
            h = conv(h * mask3(m))
            masks.append(m if is_last else m[:, ::2])
        masks = masks[:-1]

        m = masks[-1]
        bias, fchunk = self._attn_bias(m, streaming, h.dtype)
        for res, tfs in self.mid:
            h = res(h, m, t_emb)
            for blk in tfs:
                h = blk(h, bias, fchunk)

        for res, tfs, conv in self.up:
            m = masks.pop()
            skip = hiddens.pop()
            h = torch.cat([h[:, : skip.shape[1]], skip], dim=-1)
            h = res(h, m, t_emb)
            bias, fchunk = self._attn_bias(m, streaming, h.dtype)
            for blk in tfs:
                h = blk(h, bias, fchunk)
            h = conv(h * mask3(m))

        h = self.final_block(h, m)
        out = self.final_proj(h * mask3(m)) * mask3(valid)
        if c.use_flash_attention:
            # the kernel's key mask covers only the scalar length, not
            # per-row validity: poison the output if any row is padded
            out = torch.where(valid.all(), out,
                              torch.full_like(out, float("nan")))
        return out
