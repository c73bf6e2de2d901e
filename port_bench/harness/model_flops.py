"""Model FLOPs counted from the configuration, not from what the program runs.

Two FLOPs per multiply-add of every product and convolution; element-wise
work, norms, softmax, the time embedding and the STFT / iSTFT (a 16-point
transform per 4 samples) count nothing.  Attention counts its QK^T and AV
(and the rel-pos encoder's position term) over the keys each query sees.

- ``stream_frame_flops``: one mel frame of the chunk-causal KV streaming
  decode in steady state: its tokens through the encoder (each query sees
  the ring and its own chunk), 10 Euler steps x 2 CFG rows of the estimator
  (each frame sees ``ring * ratio`` frames and its chunk), and HiFT over the
  frame and its share of the hop's ``mel_cache_len`` re-vocoded frames.
- ``offline_v1_flops``: one whole CosyVoice-v1 ``token2wav`` of ``n``
  tokens: the conformer over all tokens, the length regulator, 10 x 2 rows
  of the two-level U-Net with full attention at T and ceil(T / 2), HiFT over
  T frames.
"""

from __future__ import annotations

import math
from typing import Dict


def _conformer_layer(d: int, ff: int, pos_rows: float, keys: float,
                     pos_keys: float) -> float:
    """One rel-pos conformer layer per query position."""
    return (2 * 3 * d * d + 2 * d * d + 2 * 2 * d * ff      # qkv, out, FF
            + 2 * d * d * pos_rows                           # linear_pos
            + 2 * d * keys * 2 + 2 * d * pos_keys)           # ac, av, bd


def _resnet(cin: int, ch: int) -> float:
    return 2 * cin * ch * 3 + 2 * ch * ch * 3 + 2 * cin * ch


def _tf_block(ch: int, inner: int, ff: int, keys: float) -> float:
    return (2 * ch * inner * 3 + 2 * inner * ch + 2 * 2 * ch * ff
            + 4 * inner * keys)


def hift_frame_flops(h: Dict) -> float:
    """HiFT per mel frame: the f0 predictor, conv_pre, each upsampling
    stage's transposed conv, source branch and resblocks, conv_post."""
    n_mel, base, fc = h["in_channels"], h["base_channels"], h["f0_cond_channels"]
    f = 2 * n_mel * fc * 3 + 4 * 2 * fc * fc * 3 + 2 * fc
    f += 2 * n_mel * base * 7
    n_stft = h["istft_n_fft"] + 2
    rates = h["upsample_rates"]
    stft_pos = math.prod(rates)                 # source STFT frames a frame
    down = [1] + list(rates[::-1][:-1])
    cum = [math.prod(down[:i + 1]) for i in range(len(down))][::-1]
    pos = 1
    for i, (u, k) in enumerate(zip(rates, h["upsample_kernel_sizes"])):
        cin, cout = base // 2 ** i, base // 2 ** (i + 1)
        f += 2 * cin * cout * k * pos           # transposed conv, per input
        pos *= u
        sd = cum[i]
        f += 2 * n_stft * cout * (1 if sd == 1 else 2 * sd) * (stft_pos / sd)
        sk, sdil = h["source_resblock_kernel_sizes"][i], \
            h["source_resblock_dilation_sizes"][i]
        f += len(sdil) * 2 * (2 * cout * cout * sk) * pos
        for k2, dil in zip(h["resblock_kernel_sizes"],
                           h["resblock_dilation_sizes"]):
            f += len(dil) * 2 * (2 * cout * cout * k2) * pos
    last = base // 2 ** len(rates)
    f += 2 * last * n_stft * 7 * pos
    return float(f)


def stream_frame_flops(cfg: Dict) -> float:
    """FLOPs of one delivered mel frame of the KV streaming decode."""
    fl, e, est = cfg["flow"], cfg["flow"]["encoder"], cfg["flow"]["estimator"]
    p = cfg["pipeline"]
    ratio, d, ff = fl["token_mel_ratio"], e["output_size"], e["linear_units"]
    hop, ring = p["block_size"], cfg["serving"]["ring_tokens"]
    tok_keys, mel_keys = ring + hop, (ring + hop) * ratio
    per_tok = (2 * fl["input_size"] * d
               + 2 * d * d * (e["pre_lookahead_len"] + 1) + 2 * d * d * 3
               + e["num_blocks"] * _conformer_layer(d, ff, 1, tok_keys,
                                                     tok_keys))
    per_mel = (2 * d * d * (2 * e["upsample_stride"] + 1) + 2 * d * d
               + e["num_up_blocks"] * _conformer_layer(d, ff, 1, mel_keys,
                                                        mel_keys)
               + 2 * d * fl["output_size"])
    ch, inner = est["channels"][0], est["num_heads"] * est["attention_head_dim"]
    tff = 4 * ch
    tf = est["n_blocks"] * _tf_block(ch, inner, tff, mel_keys)
    unet = (_resnet(est["in_channels"], ch) + tf + 2 * ch * ch * 3
            + est["num_mid_blocks"] * (_resnet(ch, ch) + tf)
            + _resnet(2 * ch, ch) + tf + 2 * ch * ch * 3
            + 2 * ch * ch * 3 + 2 * ch * est["out_channels"])
    rows = 2 * fl["cfm"]["n_timesteps"]
    cf = hop * ratio
    voc = hift_frame_flops(cfg["hift"]) * (cf + p["mel_cache_len"]) / cf
    return per_tok / ratio + per_mel + rows * unet + voc


def v1_mel_len(cfg: Dict, n_tokens: int) -> int:
    fl = cfg["flow"]
    return int(n_tokens / fl["input_frame_rate"] * cfg["hift"]["sampling_rate"]
               / cfg["pipeline"]["mel_hop"])


def offline_v1_flops(cfg: Dict, n_tokens: int) -> float:
    """FLOPs of one CosyVoice-v1 ``token2wav`` of ``n_tokens`` tokens."""
    fl, e, est = cfg["flow"], cfg["flow"]["encoder"], cfg["flow"]["estimator"]
    n, d, ff = n_tokens, e["output_size"], e["linear_units"]
    t = v1_mel_len(cfg, n)
    t2 = (t + 1) // 2
    enc = n * (2 * fl["input_size"] * d
               + e["num_blocks"] * _conformer_layer(
                   d, ff, (2 * n - 1) / n, n, 2 * n - 1))
    enc += n * 2 * d * fl["output_size"]
    m = fl["output_size"]
    reg = t * (4 * 2 * m * m * 3 + 2 * m * m)
    ch, inner = est["channels"][0], est["num_heads"] * est["attention_head_dim"]
    nb = est["n_blocks"]

    def tf(keys):
        return nb * _tf_block(ch, inner, 4 * ch, keys)

    unet = (t * (_resnet(est["in_channels"], ch) + tf(t))
            + t2 * 2 * ch * ch * 3                       # strided downsample
            + t2 * (_resnet(ch, ch) + tf(t2) + 2 * ch * ch * 3)
            + est["num_mid_blocks"] * t2 * (_resnet(ch, ch) + tf(t2))
            + t2 * (_resnet(2 * ch, ch) + tf(t2) + 2 * ch * ch * 4)
            + t * (_resnet(2 * ch, ch) + tf(t) + 2 * ch * ch * 3)
            + t * (2 * ch * ch * 3 + 2 * ch * est["out_channels"]))
    rows = 2 * fl["cfm"]["n_timesteps"]
    return enc + reg + rows * unet + t * hift_frame_flops(cfg["hift"])
