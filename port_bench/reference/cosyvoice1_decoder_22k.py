"""Plain reference of the CosyVoice-300M (v1) decoder at 22.05 kHz: one
request's tokens and x-vector -> the waveform of an offline ``token2wav``
with no prompt.

The conformer text encoder (ESPnet relative positions) over all tokens, the
projection, the length regulator (linear interpolation to the mel rate, the
first and last 20 tokens apart once there are more than 40, then four
convolutions), 10 Euler steps of classifier-free-guided flow matching over
the two-level non-causal U-Net from the CFM's fixed noise, every attention
over all frames of its level, then HiFT over the whole mel.  Imports torch,
numpy and ``plain`` only.
"""

from __future__ import annotations

import math
from typing import Dict

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


def mel_len(cfg: Dict, n_tokens: int) -> int:
    return int(n_tokens / cfg["flow"]["input_frame_rate"]
               * cfg["hift"]["sampling_rate"] / cfg["pipeline"]["mel_hop"])


def _rel_pe(n: int, d: int, device) -> torch.Tensor:
    """Sinusoids of the relative positions n-1 .. -(n-1), (2n-1, d)."""
    pos = np.arange(n - 1, -n, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(1e4) / d))
    pe = np.zeros((2 * n - 1, d))
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return torch.from_numpy(pe.astype(np.float32)).to(device)


def _conformer(p, pre, x, pe, heads):
    """Pre-LN conformer layer with ESPnet relative-position attention (the
    position term of query i and key j read at relative position i - j),
    then a SiLU feed-forward; every position sees every other."""
    a = pre + "self_attn."
    h = plain.layer_norm(x, p[pre + "norm_mha.weight"], p[pre + "norm_mha.bias"],
                         1e-12)
    q = F.linear(h, p[a + "linear_q.weight"], p[a + "linear_q.bias"])
    k = F.linear(h, p[a + "linear_k.weight"], p[a + "linear_k.bias"])
    v = F.linear(h, p[a + "linear_v.weight"], p[a + "linear_v.bias"])
    pos = F.linear(pe, p[a + "linear_pos.weight"])           # (2T-1, d)
    b, t, d = q.shape
    dk = d // heads
    qv = (q.reshape(b, t, heads, dk) + p[a + "pos_bias_v"]).transpose(1, 2)
    bd = torch.matmul(qv, pos.reshape(2 * t - 1, heads, dk).permute(1, 2, 0)[None])
    i = torch.arange(t, device=x.device)
    idx = (t - 1 - i[:, None] + i[None, :]).expand(b, heads, t, t)
    bd = torch.gather(bd, -1, idx)
    qu = (q.reshape(b, t, heads, dk) + p[a + "pos_bias_u"]).reshape(b, t, d)
    o = plain.masked_attention(qu, k, v, heads, None, bd)
    x = x + F.linear(o, p[a + "linear_out.weight"], p[a + "linear_out.bias"])
    h = plain.layer_norm(x, p[pre + "norm_ff.weight"], p[pre + "norm_ff.bias"],
                         1e-12)
    f = pre + "feed_forward."
    h = F.silu(F.linear(h, p[f + "w_1.weight"], p[f + "w_1.bias"]))
    return x + F.linear(h, p[f + "w_2.weight"], p[f + "w_2.bias"])


def _block(p, pre, x):
    x = plain.conv(x, p[pre + "conv.weight"], p[pre + "conv.bias"], padding=1)
    return plain.mish(plain.group_norm(x, 8, p[pre + "norm.weight"],
                                       p[pre + "norm.bias"]))


def _resnet(p, pre, x, t_emb):
    h = _block(p, pre + "block1.", x)
    h = h + F.linear(plain.mish(t_emb), p[pre + "mlp.weight"],
                       p[pre + "mlp.bias"])[:, None, :]
    h = _block(p, pre + "block2.", h)
    return h + plain.conv(x, p[pre + "res_conv.weight"], p[pre + "res_conv.bias"])


def _tf_block(p, pre, x, heads):
    a = pre + "attn1."
    h = plain.layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"], 1e-5)
    q = F.linear(h, p[a + "to_q.weight"])
    k = F.linear(h, p[a + "to_k.weight"])
    v = F.linear(h, p[a + "to_v.weight"])
    o = plain.masked_attention(q, k, v, heads)
    x = x + F.linear(o, p[a + "to_out.weight"], p[a + "to_out.bias"])
    h = plain.layer_norm(x, p[pre + "norm3.weight"], p[pre + "norm3.bias"], 1e-5)
    h = F.gelu(F.linear(h, p[pre + "ff_proj.weight"], p[pre + "ff_proj.bias"]))
    return x + F.linear(h, p[pre + "ff_out.weight"], p[pre + "ff_out.bias"])


def estimator(cfg, p, x, mu, t, spks, cond):
    """The two-level non-causal U-Net's velocity."""
    est = cfg["flow"]["estimator"]
    pe = "decoder.estimator."
    heads, nb, levels = est["num_heads"], est["n_blocks"], len(est["channels"])
    t_emb = plain.time_embedding(p, pe + "time_mlp.", t,
                                 est["in_channels"])
    h = torch.cat([x, mu, spks[:, None, :].expand(-1, x.shape[1], -1), cond],
                  dim=-1)
    skips = []
    for i in range(levels):
        h = _resnet(p, f"{pe}down_res_{i}.", h, t_emb)
        for j in range(nb):
            h = _tf_block(p, f"{pe}down_tf_{i}_{j}.", h, heads)
        skips.append(h)
        if i < levels - 1:
            h = plain.conv(h, p[f"{pe}down_conv_{i}.conv.weight"],
                         p[f"{pe}down_conv_{i}.conv.bias"], stride=2,
                         padding=1)
        else:
            h = plain.conv(h, p[f"{pe}down_conv_{i}.weight"],
                         p[f"{pe}down_conv_{i}.bias"], padding=1)
    for i in range(est["num_mid_blocks"]):
        h = _resnet(p, f"{pe}mid_res_{i}.", h, t_emb)
        for j in range(nb):
            h = _tf_block(p, f"{pe}mid_tf_{i}_{j}.", h, heads)
    for i in range(levels):
        skip = skips.pop()
        h = torch.cat([h[:, :skip.shape[1]], skip], dim=-1)
        h = _resnet(p, f"{pe}up_res_{i}.", h, t_emb)
        for j in range(nb):
            h = _tf_block(p, f"{pe}up_tf_{i}_{j}.", h, heads)
        if i < levels - 1:
            h = plain.conv_t(h, p[f"{pe}up_conv_{i}.conv.weight"],
                           p[f"{pe}up_conv_{i}.conv.bias"], stride=2,
                           padding=1)
        else:
            h = plain.conv(h, p[f"{pe}up_conv_{i}.weight"],
                         p[f"{pe}up_conv_{i}.bias"], padding=1)
    h = _block(p, pe + "final_block.", h)
    return plain.conv(h, p[pe + "final_proj.weight"], p[pe + "final_proj.bias"])


def flow_mel(ops, cfg, p, tokens: np.ndarray, speaker: np.ndarray, device):
    """The mel (T, n_mel) of ``token2wav`` with no prompt."""
    fl = cfg["flow"]
    n_mel = fl["output_size"]
    tok = torch.as_tensor(np.asarray(tokens, np.int64), device=device)[None]
    with ops.model():
        mu, spks = _encode(cfg, p, tok, speaker, device)
    cfm = fl["cfm"]
    t = mu.shape[1]
    x = torch.from_numpy(plain.fixed_noise(cfm["max_noise_len"], n_mel)[:, :t]
                         ).to(device)
    ts = plain.t_span(cfm["n_timesteps"])
    rate = cfm["inference_cfg_rate"]
    mu2 = torch.cat([mu, torch.zeros_like(mu)])
    spk2 = torch.cat([spks, torch.zeros_like(spks)])
    cond2 = torch.zeros_like(mu2)
    for s in range(cfm["n_timesteps"]):
        tt = torch.full((2,), float(ts[s]), device=device)
        with ops.model():
            d = estimator(cfg, p, torch.cat([x, x]), mu2, tt, spk2,
                          cond2).float()
        x = x + float(ts[s + 1] - ts[s]) * ((1.0 + rate) * d[:1] - rate * d[1:])
    return x


def _encode(cfg, p, tok, speaker, device):
    """(mu (1, T, n_mel), projected speaker (1, n_mel))."""
    fl = cfg["flow"]
    e = fl["encoder"]
    n = tok.shape[1]
    x = p["input_embedding.weight"][tok]
    x = F.linear(x, p["encoder.embed.linear.weight"],
                   p["encoder.embed.linear.bias"])
    x = plain.layer_norm(x, p["encoder.embed.norm.weight"],
                         p["encoder.embed.norm.bias"], 1e-5) * math.sqrt(
                             e["output_size"])
    pe = _rel_pe(n, e["output_size"], device)
    for i in range(e["num_blocks"]):
        x = _conformer(p, f"encoder.encoders_{i}.", x, pe,
                       e["attention_heads"])
    x = plain.layer_norm(x, p["encoder.after_norm.weight"],
                         p["encoder.after_norm.bias"], 1e-5)
    h = F.linear(x, p["encoder_proj.weight"], p["encoder_proj.bias"])
    t = mel_len(cfg, n)
    if n > 40:
        edge = int(20 / fl["input_frame_rate"] * cfg["hift"]["sampling_rate"]
                   / cfg["pipeline"]["mel_hop"])
        h = torch.cat([plain.interp(h[:, :20], edge),
                       plain.interp(h[:, 20:-20], t - 2 * edge),
                       plain.interp(h[:, -20:], edge)], dim=1)
    else:
        h = plain.interp(h, t)
    for i in range(4):
        h = plain.conv(h, p[f"length_regulator.conv_{i}.weight"],
                     p[f"length_regulator.conv_{i}.bias"], padding=1)
        h = plain.mish(plain.group_norm(h, 1, p[f"length_regulator.norm_{i}.weight"],
                                        p[f"length_regulator.norm_{i}.bias"]))
    mu = plain.conv(h, p["length_regulator.out_conv.weight"],
                  p["length_regulator.out_conv.bias"])
    emb = torch.as_tensor(np.asarray(speaker, np.float32), device=device)[None]
    emb = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    spks = F.linear(emb, p["spk_embed_affine_layer.weight"],
                      p["spk_embed_affine_layer.bias"])
    return mu.float(), spks.float()


@torch.no_grad()
def decode(cfg: Dict, flow: Dict[str, torch.Tensor],
           hift: Dict[str, torch.Tensor], tokens: np.ndarray,
           speaker: np.ndarray, device, precision: str = "float32"
           ) -> np.ndarray:
    """One request -> its waveform (samples,) float32."""
    ops = Ops(precision)
    with ops.active():
        mel = flow_mel(ops, cfg, flow, tokens, speaker, device)
        with ops.model():
            wav, _ = plain.hift(cfg["hift"], hift, mel)
    return wav[0].float().cpu().numpy()
