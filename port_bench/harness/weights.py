"""Seeded weights made on the device in a few large draws.

The state dict of a module built on the ``meta`` device is filled from one
standard-normal draw and one uniform draw of a ``torch.Generator`` on the
device, each leaf a slice of them.  The rules follow the port's seeded
weights (lecun-normal dense and conv weights, norms and Snake alphas ones,
biases zeros, position biases xavier-uniform, embeddings normal(1),
weight-norm gains ||v|| so the kernel starts equal to v), so the random
model stays in range; the draws differ.  One rule departs: HiFT's
transposed, residual and last convolutions are lecun-normal too, not
normal(0.01) (the JAX package's training init).  At 0.01 the vocoder's
output hardly depends on its mel: two requests with different tokens gave
waveforms correlated 0.998 at full width, so no check could see a wrong
token; lecun-normal gives speech-level output (rms ~0.2) that follows the
mel.

The leaves are float32; the program casts its own copy to the type it
serves in, and the reference keeps these.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

def _plan(module: nn.Module) -> List[Tuple[str, tuple, str, float]]:
    """(key, shape, kind, scale) of every parameter; kind is normal,
    uniform, ones, zeros or gain."""
    plan = []
    for mod_name, mod in module.named_modules():
        pre = f"{mod_name}." if mod_name else ""
        kind_name = type(mod).__name__
        for name, p in mod.named_parameters(recurse=False):
            shape = tuple(p.shape)
            key = pre + name
            if name == "bias":
                plan.append((key, shape, "zeros", 0.0))
            elif kind_name in ("LayerNorm", "GroupNorm", "RMSNorm") \
                    or name == "alpha":
                plan.append((key, shape, "ones", 0.0))
            elif name in ("pos_bias_u", "pos_bias_v"):
                plan.append((key, shape, "uniform",
                             math.sqrt(6.0 / (shape[0] + shape[1]))))
            elif isinstance(mod, nn.Embedding):
                plan.append((key, shape, "normal", 1.0))
            elif isinstance(mod, nn.Linear):
                plan.append((key, shape, "normal", 1.0 / math.sqrt(shape[1])))
            elif name in ("weight", "v") and p.dim() == 3:
                fan_in = (shape[0] * shape[2] if kind_name == "ConvTranspose1d"
                          else shape[1] * shape[2])
                plan.append((key, shape, "normal", 1.0 / math.sqrt(fan_in)))
            elif name == "g":
                plan.append((key, shape, "gain", 0.0))
            else:
                raise ValueError(f"no init rule for {key} {shape}")
    if any(True for _ in module.buffers()):
        raise ValueError("modules with buffers are not seeded here")
    return plan


@torch.no_grad()
def seeded_state(module: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A float32 state dict for ``module`` (built on ``meta``), drawn on
    ``device`` from ``seed``."""
    plan = _plan(module)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sizes = {k: math.prod(s) for k, s, _, _ in plan}
    n_norm = sum(sizes[k] for k, _, kind, _ in plan if kind == "normal")
    n_unif = sum(sizes[k] for k, _, kind, _ in plan if kind == "uniform")
    normal = torch.randn(n_norm, generator=gen, device=device)
    unif = torch.rand(max(n_unif, 1), generator=gen, device=device) * 2 - 1
    state: Dict[str, torch.Tensor] = {}
    i = j = 0
    for key, shape, kind, scale in plan:
        n = sizes[key]
        if kind == "normal":
            state[key] = normal[i:i + n].view(shape).mul_(scale)
            i += n
        elif kind == "uniform":
            state[key] = unif[j:j + n].view(shape).mul_(scale)
            j += n
        elif kind == "ones":
            state[key] = torch.ones(shape, device=device)
        elif kind == "zeros":
            state[key] = torch.zeros(shape, device=device)
    for key, shape, kind, _ in plan:
        if kind == "gain":
            v = state[key[:-1] + "v"]
            state[key] = torch.sqrt((v * v).sum(dim=tuple(range(1, v.dim()))))
    return state


def seed_for(seed: int, part: int) -> int:
    """A generator seed for ``part`` (0 flow, 1 vocoder) of run ``seed``."""
    return (int(seed) * 1_000_003 + 7919 * (part + 1)) % (1 << 63)


def model_states(cfg: Dict, seed: int, device):
    """(flow state, vocoder state) of a configuration file, drawn on
    ``device`` from ``seed``: the causal streaming flow
    (``CausalMaskedDiffWithXvec``) or, for a non-causal U-Net, the v1 flow
    (``MaskedDiffWithXvec``), and HiFT."""
    from port_bench.harness.configs import flow_hift
    from moss_speech_decoder_cosy_torch.models.flow.flow import (
        CausalMaskedDiffWithXvec)
    from moss_speech_decoder_cosy_torch.models.flow.flow_v1 import (
        MaskedDiffWithXvec)
    from moss_speech_decoder_cosy_torch.models.hift import HiFTGenerator
    flow_cfg, hift_cfg = flow_hift(cfg)
    cls = (CausalMaskedDiffWithXvec if flow_cfg.estimator.causal
           else MaskedDiffWithXvec)
    with torch.device("meta"):
        flow, hift = cls(flow_cfg), HiFTGenerator(hift_cfg)
    return (seeded_state(flow, seed_for(seed, 0), device),
            seeded_state(hift, seed_for(seed, 1), device))
