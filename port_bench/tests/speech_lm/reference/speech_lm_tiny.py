"""Plain reference of the fixture's speech LM: a Qwen2 decoder over
[sos, prompt text, task id, speech tokens] with its speech head.

RMSNorm, rotary embeddings on halves, grouped-query causal attention with
an f32 softmax, a SwiGLU MLP; the whole sequence at once, with no cache and
no slots.  Weights are the state dict the family drew, keyed by the port's
parameter names; computed in float32, or in bfloat16 for the control.
Imports torch, numpy and math only.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _lin(p, key, x):
    b = p.get(key + ".bias")
    return x @ p[key + ".weight"].T + (0 if b is None else b)


def _rope(x, pos, theta):
    """x (T, H, dk): [x1 cos - x2 sin, x2 cos + x1 sin] at positions pos."""
    dk = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dk, 2, dtype=torch.float32,
                                        device=x.device) / dk))
    ang = pos.float()[:, None] * inv                      # (T, dk / 2)
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None].to(x.dtype)
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None].to(x.dtype)
    x1, x2 = x[..., :dk // 2], x[..., dk // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


@torch.no_grad()
def logits(cfg: Dict, state: Dict[str, torch.Tensor], prompt: np.ndarray,
           tokens: np.ndarray, device, precision: str = "float32"
           ) -> np.ndarray:
    """The speech logits (n_tokens + 1, V) float32 of the positions from the
    task id on."""
    dt = DTYPES[precision]
    p = {k: v.to(device=device, dtype=dt) for k, v in state.items()}
    bb = cfg["backbone"]
    h, hkv = bb["num_heads"], bb["num_kv_heads"]
    dk = bb["hidden_size"] // h
    eps, theta = bb["norm_eps"], bb["rope_theta"]
    ids = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    special = p["llm_embedding.weight"]
    x = torch.cat([special[:1], p["llm.embed_tokens.weight"][ids(prompt)],
                   special[1:2], p["speech_embedding.weight"][ids(tokens)]])
    t = x.shape[0]
    pos = torch.arange(t, device=device)
    causal = pos[None, :] <= pos[:, None]                  # (T, S)
    for i in range(bb["num_layers"]):
        pre = f"llm.layers_{i}."
        lin = lambda name, v: _lin(p, pre + name, v)          # noqa: E731
        a = _rms(x, p[pre + "input_layernorm.weight"], eps)
        q = _rope(lin("q_proj", a).view(t, h, dk), pos, theta)
        k = _rope(lin("k_proj", a).view(t, hkv, dk), pos, theta)
        v = lin("v_proj", a).view(t, hkv, dk)
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        sc = torch.einsum("thd,shd->hts", q, k).float() / math.sqrt(dk)
        sc = sc.masked_fill(~causal, -math.inf)
        w = torch.softmax(sc, dim=-1).to(dt)
        o = torch.einsum("hts,shd->thd", w, v).reshape(t, h * dk)
        x = x + lin("o_proj", o)
        a = _rms(x, p[pre + "post_attention_layernorm.weight"], eps)
        x = x + lin("down_proj", F.silu(lin("gate_proj", a))
                    * lin("up_proj", a))
    x = _rms(x, p["llm.norm.weight"], eps)
    first = len(prompt) + 1                                # the task id
    return _lin(p, "llm_decoder", x[first:]).float().cpu().numpy()
