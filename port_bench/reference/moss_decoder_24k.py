"""Plain reference of the MOSS-Speech 24 kHz decoder as the decode server
streams it: one request's tokens and speaker vector -> its waveform.

The server decodes a stream chunk by chunk (``block_size`` tokens a hop, a
ring of ``ring_tokens`` tokens of left context, the last ``la + r`` tokens
in a finalize hop), then vocodes hop by hop with a mel cache, a source
cache and a Hamming cross-fade.  Here the same semantics are computed
without rings, caches or a wavefront:

- the flow runs once over the whole sequence, every attention under the
  chunk-causal mask of that partition (a position sees its own chunk and the
  ``ring_tokens`` tokens, or ``ring_tokens * ratio`` mel frames, before the
  chunk's start), every causal convolution zero-padded on the left, the
  lookahead convolution zero-padded on the right at the end of the stream;
  the noise is the CFM's fixed noise from the start of the stream, the
  Euler solve in f32 with classifier-free guidance;
- HiFT then runs hop by hop over the flow's mel cut at the same chunk
  bounds: the first hop alone, each later one behind the last
  ``mel_cache_len`` frames of the one before, its excitation's head
  replaced by the cached source, its head cross-faded with the cached
  speech, the last ``mel_cache_len * upsample`` samples held back until the
  finalize hop, which emits everything.

Weights are the state dicts the benchmark drew (float32).  Imports torch,
numpy and ``plain`` only.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

try:
    from . import plain
except ImportError:                       # loaded by path
    import importlib.util as _u
    import pathlib as _p
    _s = _u.spec_from_file_location(
        "port_bench_reference_plain", _p.Path(__file__).with_name("plain.py"))
    plain = _u.module_from_spec(_s)
    _s.loader.exec_module(plain)

Ops = plain.Ops


def chunk_bounds(n_tokens: int, hop: int, la: int) -> List[int]:
    """Token chunk starts and the end: ``k_total`` hops, then the finalize
    hop's tail (at least ``la`` tokens)."""
    k_total = max(0, (n_tokens - la) // hop)
    return [hop * k for k in range(k_total + 1)] + (
        [n_tokens] if n_tokens > hop * k_total else [])


def _abs_pe(n: int, d: int, device) -> torch.Tensor:
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(1e4) / d))
    pe = np.zeros((n, d))
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return torch.from_numpy(pe.astype(np.float32)).to(device)


def _linear_embed(p, pre, x):
    x = F.linear(x, p[pre + "linear.weight"], p[pre + "linear.bias"])
    x = plain.layer_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"], 1e-5)
    return x * math.sqrt(x.shape[-1])


def _conformer(p, pre, x, pe, mask, heads):
    """Pre-LN conformer layer: rel-pos self-attention (the position term
    indexed by the key's position), then a SiLU feed-forward."""
    a = pre + "self_attn."
    h = plain.layer_norm(x, p[pre + "norm_mha.weight"], p[pre + "norm_mha.bias"],
                         1e-12)
    q = F.linear(h, p[a + "linear_q.weight"], p[a + "linear_q.bias"])
    k = F.linear(h, p[a + "linear_k.weight"], p[a + "linear_k.bias"])
    v = F.linear(h, p[a + "linear_v.weight"], p[a + "linear_v.bias"])
    pos = F.linear(pe, p[a + "linear_pos.weight"])            # (T, d)
    b, t, d = q.shape
    dk = d // heads
    qv = (q.reshape(b, t, heads, dk) + p[a + "pos_bias_v"]).transpose(1, 2)
    bd = torch.matmul(qv, pos.reshape(t, heads, dk).permute(1, 2, 0)[None])
    qu = (q.reshape(b, t, heads, dk) + p[a + "pos_bias_u"]).reshape(b, t, d)
    o = plain.masked_attention(qu, k, v, heads, mask, bd)
    x = x + F.linear(o, p[a + "linear_out.weight"], p[a + "linear_out.bias"])
    h = plain.layer_norm(x, p[pre + "norm_ff.weight"], p[pre + "norm_ff.bias"],
                         1e-12)
    f = pre + "feed_forward."
    h = F.silu(F.linear(h, p[f + "w_1.weight"], p[f + "w_1.bias"]))
    return x + F.linear(h, p[f + "w_2.weight"], p[f + "w_2.bias"])


def encode(cfg, p, tokens: torch.Tensor, bounds: List[int]):
    """tokens (1, n) -> mu (1, n * ratio, n_mel)."""
    e = cfg["flow"]["encoder"]
    ring, heads, la = (cfg["serving"]["ring_tokens"], e["attention_heads"],
                       e["pre_lookahead_len"])
    s = e["upsample_stride"]
    dev = tokens.device
    x = p["input_embedding.weight"][tokens]
    x = _linear_embed(p, "encoder.embed.", x)
    pre = "encoder.pre_lookahead_layer."
    h = F.leaky_relu(plain.conv(F.pad(x, (0, 0, 0, la)), p[pre + "conv1.weight"],
                              p[pre + "conv1.bias"]), 0.01)
    x = plain.conv(F.pad(h, (0, 0, 2, 0)), p[pre + "conv2.weight"],
                 p[pre + "conv2.bias"]) + x
    n = x.shape[1]
    mask = plain.chunk_mask(bounds, ring, dev)
    pe = _abs_pe(n, x.shape[-1], dev)
    for i in range(e["num_blocks"]):
        x = _conformer(p, f"encoder.encoders_{i}.", x, pe, mask, heads)
    x = torch.repeat_interleave(x, s, dim=1)
    x = plain.conv(F.pad(x, (0, 0, 2 * s, 0)), p["encoder.up_layer.conv.weight"],
                 p["encoder.up_layer.conv.bias"])
    x = _linear_embed(p, "encoder.up_embed.", x)
    mask = plain.chunk_mask([b * s for b in bounds], ring * s, dev)
    pe = _abs_pe(n * s, x.shape[-1], dev)
    for i in range(e["num_up_blocks"]):
        x = _conformer(p, f"encoder.up_encoders_{i}.", x, pe, mask, heads)
    x = plain.layer_norm(x, p["encoder.after_norm.weight"],
                         p["encoder.after_norm.bias"], 1e-5)
    return F.linear(x, p["encoder_proj.weight"], p["encoder_proj.bias"])


def _causal_block(p, pre, x):
    x = plain.conv(F.pad(x, (0, 0, 2, 0)), p[pre + "conv.conv.weight"],
                 p[pre + "conv.conv.bias"])
    return plain.mish(plain.layer_norm(x, p[pre + "norm.weight"],
                                       p[pre + "norm.bias"], 1e-5))


def _resnet(p, pre, x, t_emb):
    h = _causal_block(p, pre + "block1.", x)
    h = h + F.linear(plain.mish(t_emb), p[pre + "mlp.weight"],
                       p[pre + "mlp.bias"])[:, None, :]
    h = _causal_block(p, pre + "block2.", h)
    return h + plain.conv(x, p[pre + "res_conv.weight"], p[pre + "res_conv.bias"])


def _tf_block(p, pre, x, mask, heads):
    a = pre + "attn1."
    h = plain.layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"], 1e-5)
    q = F.linear(h, p[a + "to_q.weight"])
    k = F.linear(h, p[a + "to_k.weight"])
    v = F.linear(h, p[a + "to_v.weight"])
    o = plain.masked_attention(q, k, v, heads, mask)
    x = x + F.linear(o, p[a + "to_out.weight"], p[a + "to_out.bias"])
    h = plain.layer_norm(x, p[pre + "norm3.weight"], p[pre + "norm3.bias"], 1e-5)
    h = F.gelu(F.linear(h, p[pre + "ff_proj.weight"], p[pre + "ff_proj.bias"]))
    return x + F.linear(h, p[pre + "ff_out.weight"], p[pre + "ff_out.bias"])


def estimator(cfg, p, x, mu, t, spks, cond, mask):
    """The causal U-Net's velocity; x, mu, cond (B, T, n_mel), t (B,)."""
    est = cfg["flow"]["estimator"]
    pe = "decoder.estimator."
    heads, nb = est["num_heads"], est["n_blocks"]
    t_emb = plain.time_embedding(p, pe + "time_mlp.", t,
                                 est["in_channels"])
    h = torch.cat([x, mu, spks[:, None, :].expand(-1, x.shape[1], -1), cond],
                  dim=-1)
    h = _resnet(p, pe + "down_res_0.", h, t_emb)
    for j in range(nb):
        h = _tf_block(p, f"{pe}down_tf_0_{j}.", h, mask, heads)
    skip = h
    h = plain.conv(F.pad(h, (0, 0, 2, 0)), p[pe + "down_conv_0.conv.weight"],
                 p[pe + "down_conv_0.conv.bias"])
    for i in range(est["num_mid_blocks"]):
        h = _resnet(p, f"{pe}mid_res_{i}.", h, t_emb)
        for j in range(nb):
            h = _tf_block(p, f"{pe}mid_tf_{i}_{j}.", h, mask, heads)
    h = _resnet(p, pe + "up_res_0.", torch.cat([h, skip], dim=-1), t_emb)
    for j in range(nb):
        h = _tf_block(p, f"{pe}up_tf_0_{j}.", h, mask, heads)
    h = plain.conv(F.pad(h, (0, 0, 2, 0)), p[pe + "up_conv_0.conv.weight"],
                 p[pe + "up_conv_0.conv.bias"])
    h = _causal_block(p, pe + "final_block.", h)
    return plain.conv(h, p[pe + "final_proj.weight"], p[pe + "final_proj.bias"])


def flow_mel(ops, cfg, p, tokens: np.ndarray, speaker: np.ndarray, device):
    """The mel (T, n_mel) of a whole stream and its token chunk bounds."""
    fl, pipe = cfg["flow"], cfg["pipeline"]
    ratio, n_mel = fl["token_mel_ratio"], fl["output_size"]
    bounds = chunk_bounds(len(tokens), pipe["block_size"],
                          fl["pre_lookahead_len"])
    tok = torch.as_tensor(np.asarray(tokens, np.int64), device=device)[None]
    emb = torch.as_tensor(np.asarray(speaker, np.float32), device=device)[None]
    with ops.model():
        mu = encode(cfg, p, tok, bounds)
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        spks = F.linear(emb, p["spk_embed_affine_layer.weight"],
                          p["spk_embed_affine_layer.bias"])
    tm = mu.shape[1]
    mask = plain.chunk_mask([b * ratio for b in bounds],
                            cfg["serving"]["ring_tokens"] * ratio, device)
    cfm = fl["cfm"]
    x = torch.from_numpy(plain.fixed_noise(cfm["max_noise_len"], n_mel)[:, :tm]
                         ).to(device)
    ts = plain.t_span(cfm["n_timesteps"])
    rate = cfm["inference_cfg_rate"]
    mu2 = torch.cat([mu, torch.zeros_like(mu)])
    spk2 = torch.cat([spks, torch.zeros_like(spks)])
    cond2 = torch.zeros_like(mu2)
    for s in range(cfm["n_timesteps"]):
        t = torch.full((2,), float(ts[s]), device=device)
        with ops.model():
            d = estimator(cfg, p, torch.cat([x, x]), mu2, t, spk2, cond2,
                          mask).float()
        x = x + float(ts[s + 1] - ts[s]) * ((1.0 + rate) * d[:1] - rate * d[1:])
    return x[0], bounds


def vocode_hops(ops, cfg, p, mel: torch.Tensor, bounds: List[int]):
    """HiFT hop by hop over ``mel`` cut at the chunk bounds (in tokens),
    as the server emits: the waveform (samples,)."""
    h, pipe = cfg["hift"], cfg["pipeline"]
    ratio = cfg["flow"]["token_mel_ratio"]
    up = math.prod(h["upsample_rates"]) * h["istft_hop_len"]
    mcl = pipe["mel_cache_len"]
    scl = mcl * up
    win = torch.from_numpy(np.hamming(2 * scl).astype(np.float32)).to(mel.device)
    fade_in, fade_out = win[:scl], win[scl:]
    out = []
    cache = None                      # (mel, source, speech)
    n_hops = len(bounds) - 1
    for i in range(n_hops):
        chunk = mel[bounds[i] * ratio: bounds[i + 1] * ratio][None]
        last = i == n_hops - 1
        if cache is None:
            mel_in, src_in = chunk, None
        else:
            mel_in, src_in = torch.cat([cache[0], chunk], dim=1), cache[1]
        with ops.model():
            wav, src = plain.hift(h, p, mel_in, cache_source=src_in)
        wav, src = wav.float(), src.float()
        if cache is not None:
            wav = torch.cat([wav[:, :scl] * fade_in + cache[2] * fade_out,
                             wav[:, scl:]], dim=1)
        if last:
            out.append(wav)
            break
        out.append(wav[:, : wav.shape[1] - scl])
        cache = (mel_in[:, mel_in.shape[1] - mcl:], src[:, src.shape[1] - scl:],
                 wav[:, wav.shape[1] - scl:])
    return torch.cat(out, dim=1)[0]


@torch.no_grad()
def decode(cfg: Dict, flow: Dict[str, torch.Tensor],
           hift: Dict[str, torch.Tensor], tokens: np.ndarray,
           speaker: np.ndarray, device, precision: str = "float32"
           ) -> np.ndarray:
    """One request -> its waveform (samples,) float32."""
    ops = Ops(precision)
    with ops.active():
        mel, bounds = flow_mel(ops, cfg, flow, tokens, speaker, device)
        wav = vocode_hops(ops, cfg, hift, mel, bounds)
    return wav.float().cpu().numpy()
