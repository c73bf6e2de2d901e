"""VQ codebook training in one process: EMA updates and the dead-code
restart, after the JAX package's ``training/vq.py`` (reference
speech_tokenizer/modeling_whisper.py:1391-1465).

- EMA counts and weights with Laplace smoothing, decay
  ``quantize_ema_decay`` (0.99);
- the commit loss (scale 10 x coefficient 0.25) and the straight-through
  estimator;
- the dead-code restart every ``quantize_restart_interval`` steps: entries
  whose EMA count fell under 0.1 x decay^interval take live hidden states,
  the candidate rows drawn from a ``torch.Generator`` or passed in.

One process: the cross-replica sums of the reference wait for data-parallel
training (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..tokenizer.config import WhisperVQConfig


@dataclasses.dataclass
class VQTrainState:
    codebook: torch.Tensor      # (V, D)
    ema_count: torch.Tensor     # (V,)
    ema_weight: torch.Tensor    # (V, D)
    steps: int


def init_vq_state(codebook: torch.Tensor) -> VQTrainState:
    cb = codebook.detach().float()
    return VQTrainState(codebook=cb.clone(),
                        ema_count=torch.ones(cb.shape[0], device=cb.device),
                        ema_weight=cb.clone(), steps=0)


def quantize(hidden: torch.Tensor, codebook: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, D) -> (quantized, ids): the nearest codebook entry by L2."""
    h2 = torch.sum(hidden * hidden, dim=-1, keepdim=True)
    c2 = torch.sum(codebook * codebook, dim=-1)
    dist = h2 + c2[None, None] - 2.0 * torch.einsum("btd,vd->btv", hidden,
                                                    codebook)
    ids = torch.argmin(dist, dim=-1)
    return codebook[ids], ids


def straight_through(hidden: torch.Tensor,
                     quantized: torch.Tensor) -> torch.Tensor:
    """hidden + (quantized - hidden).detach() (modeling_whisper.py:1457)."""
    return hidden + (quantized - hidden).detach()


def commit_loss(hidden: torch.Tensor, quantized: torch.Tensor,
                valid: torch.Tensor, cfg: WhisperVQConfig) -> torch.Tensor:
    m = valid.to(hidden.dtype)
    per = torch.mean((hidden - quantized.detach()) ** 2, dim=-1)
    loss = torch.sum(per * m) / torch.clamp(torch.sum(m), min=1.0)
    return cfg.quantize_loss_scale * cfg.quantize_commit_coefficient * loss


def restart_candidates(valid: torch.Tensor, n: int,
                       generator: torch.Generator) -> torch.Tensor:
    """``n`` flat row indices drawn uniformly, with replacement, from the
    valid positions of ``valid`` (B, T)."""
    probs = valid.reshape(-1).float()
    return torch.multinomial(probs / probs.sum().clamp(min=1.0), n,
                             replacement=True, generator=generator)


@torch.no_grad()
def ema_update(state: VQTrainState, hidden: torch.Tensor, ids: torch.Tensor,
               valid: torch.Tensor, cfg: WhisperVQConfig,
               generator: Optional[torch.Generator] = None,
               candidates: Optional[torch.Tensor] = None) -> VQTrainState:
    """One EMA step; at every ``quantize_restart_interval``-th step the
    dead-code restart when ``generator`` or ``candidates`` (V flat row
    indices into the (B * T, D) hidden states) is given."""
    v = cfg.quantize_vocab_size
    decay = cfg.quantize_ema_decay
    flat = hidden.detach().float().reshape(-1, hidden.shape[-1])
    mask = valid.reshape(-1).float()
    enc = F.one_hot(ids.reshape(-1).long(), v).float() * mask[:, None]
    n = enc.sum(dim=0)
    dw = enc.T @ flat
    ema_count = state.ema_count * decay + (1.0 - decay) * n
    total = ema_count.sum()
    ema_count = (ema_count + 1e-5) / (total + v * 1e-5) * total
    ema_weight = state.ema_weight * decay + (1.0 - decay) * dw
    new = VQTrainState(codebook=ema_weight / ema_count[:, None],
                       ema_count=ema_count, ema_weight=ema_weight,
                       steps=state.steps + 1)
    interval = cfg.quantize_restart_interval
    if (generator is None and candidates is None) or interval is None \
            or new.steps % interval:
        return new
    if candidates is None:
        candidates = restart_candidates(valid, v, generator)
    return restart_dead_codes(new, flat[candidates], cfg)


def restart_dead_codes(state: VQTrainState, cand: torch.Tensor,
                       cfg: WhisperVQConfig) -> VQTrainState:
    """Entries with an EMA count under 0.1 x decay^interval take the
    candidate rows ``cand`` (V, D) (modeling_whisper.py:1419-1454)."""
    thr = 0.1 * cfg.quantize_ema_decay ** cfg.quantize_restart_interval
    dead = state.ema_count < thr
    return VQTrainState(
        codebook=torch.where(dead[:, None], cand, state.codebook),
        ema_count=torch.where(dead, torch.ones_like(state.ema_count),
                              state.ema_count),
        ema_weight=torch.where(dead[:, None], cand, state.ema_weight),
        steps=state.steps)
