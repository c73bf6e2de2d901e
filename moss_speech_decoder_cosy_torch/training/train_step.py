"""The flow model's train step in one process, after the JAX package's
``training/train_step.py`` (reference cosyvoice/bin/train.py +
utils/executor.py + utils/train_utils.py).

- The learning-rate schedules are plain functions of the step, in the JAX
  package's float32 arithmetic.
- ``make_optimizer`` is ``optax.chain(clip_by_global_norm(clip),
  adamw(schedule))`` written out (``AdamW``): the clip scales by
  ``max_norm / norm`` only when ``norm >= max_norm``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` adds one); weight decay 1e-4 (optax's
  default; torch's ``AdamW`` decays by 1e-2); the schedule is read at the
  update count before it is incremented, so the first update runs at step
  0.
- Gradient accumulation: the batch splits into ``accum_steps`` microbatches
  along its rows; their gradients are summed and divided by
  ``accum_steps``, as the loss.
- Every random draw of a step (the flow loss's and the dropout masks) comes
  from one ``torch.Generator``, or is passed in (``draws``).

No mesh, ZeRO or tensor parallelism: those wait for data-parallel training
(ROADMAP A8).  A train step runs the plain paths: the CUDA kernels have no
backward and raise under autograd (``ops/autograd_guard.forbid_autograd``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.flow import CausalMaskedDiffWithXvec
from ..models.flow.flow import FlowLossDraws
from ..ops.dropout import Dropout
from ..utils.config import FlowConfig

Schedule = Callable[[int], float]
_F32 = np.float32


def warmup_lr(peak_lr: float, warmup_steps: int) -> Schedule:
    """WarmupLR (cosyvoice/utils/scheduler.py:27-75):
    lr * warmup^0.5 * min(step^-0.5, step * warmup^-1.5), step >= 1."""
    w = float(warmup_steps)

    def sched(step: int) -> float:
        s = _F32(max(step, 1))
        return float(_F32(peak_lr * w ** 0.5)
                     * min(s ** _F32(-0.5), s * _F32(w ** -1.5)))
    return sched


def _linear_warmup(s: np.float32, peak_lr: float, warmup_steps: int
                   ) -> float:
    # a division by a constant runs as a product with its f32 reciprocal,
    # as XLA compiles the JAX package's schedules
    return float(_F32(peak_lr) * min(
        s * _F32(1.0 / max(warmup_steps, 1)), _F32(1.0)))


def noam_hold_annealing(peak_lr: float, warmup_steps: int, hold_steps: int,
                        max_steps: int, decay_rate: float = 0.5,
                        min_lr: float = 0.0) -> Schedule:
    """NoamHoldAnnealing (scheduler.py:433-441,623-680): linear warmup ->
    hold -> noam decay with exponent ``decay_rate``."""
    del max_steps       # the reference's signature; the decay never ends

    def sched(step: int) -> float:
        s = _F32(step)
        if s <= warmup_steps:
            return _linear_warmup(s, peak_lr, warmup_steps)
        if s <= warmup_steps + hold_steps:
            return float(_F32(peak_lr))
        t_warm = max(1.0, warmup_steps ** decay_rate)
        t_hold = max(_F32(1.0), (s - _F32(hold_steps)) ** _F32(decay_rate))
        return float(max(_F32(peak_lr * t_warm) / t_hold, _F32(min_lr)))
    return sched


def cosine_annealing(peak_lr: float, warmup_steps: int, max_steps: int,
                     min_lr: float = 0.0) -> Schedule:
    """CosineAnnealing with linear warmup (scheduler.py:497-534)."""
    def sched(step: int) -> float:
        s = _F32(step)
        if s <= warmup_steps:
            return _linear_warmup(s, peak_lr, warmup_steps)
        frac = np.clip((s - _F32(warmup_steps))
                       * _F32(1.0 / max(max_steps - warmup_steps, 1)),
                       _F32(0.0), _F32(1.0))
        return float(_F32(min_lr) + _F32(peak_lr - min_lr) * _F32(0.5)
                     * (_F32(1.0) + np.cos(_F32(np.pi) * frac)))
    return sched


def constant_lr(lr: float) -> Schedule:
    return lambda step: float(_F32(lr))


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """The global 2-norm of every element (``optax.global_norm``), a device
    scalar: the norm of the tensors' norms, a few multi-tensor launches."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, b1,
    b2, eps, weight_decay=weight_decay))`` over f32 ``params``
    (``clip_norm`` None: no clip; ``weight_decay`` 0: ``optax.adam``).
    ``step()`` applies the gradients in ``p.grad``; ``count`` is optax's
    update count.  The moments are f32 tensors beside each parameter, and
    every update runs as multi-tensor (``torch._foreach_*``) launches: a
    loop over the flow's 1121 tensors launched ~14 kernels each."""

    def __init__(self, params: Iterable[nn.Parameter], schedule: Schedule,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 clip_norm: Optional[float] = None):
        self.params: List[nn.Parameter] = [p for p in params
                                           if p.requires_grad]
        if any(p.dtype != torch.float32 for p in self.params):
            raise ValueError("AdamW updates f32 parameters only")
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = self.grads()
        if self.clip_norm is not None:
            # scaled by max_norm / norm only when norm >= max_norm, no eps
            norm = global_norm(grads)
            scale = torch.where(norm >= self.clip_norm,
                                self.clip_norm / norm, torch.ones_like(norm))
            grads = torch._foreach_mul(grads, scale)
        self.count += 1
        c1 = float(_F32(1.0) - _F32(self.b1) ** _F32(self.count))
        c2 = float(_F32(1.0) - _F32(self.b2) ** _F32(self.count))
        lr = self.schedule(self.count - 1)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, c2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, c1), denom)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)


def make_optimizer(peak_lr: float = 1e-3, warmup_steps: int = 2500,
                   clip_norm: float = 5.0):
    """A factory ``params -> AdamW``: clip by global norm ``clip_norm``,
    then AdamW under ``warmup_lr(peak_lr, warmup_steps)``."""
    def build(params: Iterable[nn.Parameter]) -> AdamW:
        return AdamW(params, warmup_lr(peak_lr, warmup_steps),
                     clip_norm=clip_norm)
    return build


@dataclasses.dataclass
class TrainState:
    """The step count (the number of updates applied), the model (its
    parameters updated in place) and its optimizer."""
    step: int
    model: nn.Module
    optimizer: AdamW


def create_flow_train_state(cfg: FlowConfig, seed: int = 0,
                            optimizer=None, device=None) -> TrainState:
    """A ``CausalMaskedDiffWithXvec`` with weights drawn from ``seed``
    (``weights.seeded_module``) on ``device`` (the card unless the caller
    asks for the CPU), f32, and ``optimizer(params)`` (default
    ``make_optimizer()``)."""
    from ..weights import seeded_module
    model = seeded_module(lambda: CausalMaskedDiffWithXvec(cfg), seed,
                          device)
    optimizer = optimizer or make_optimizer()
    return TrainState(step=0, model=model,
                      optimizer=optimizer(model.parameters()))


FLOW_BATCH_KEYS = ("speech_token", "token_valid", "speech_feat",
                   "feat_valid", "embedding")
# one microbatch's draws: (micro index, microbatch) -> (loss draws, dropout)
FlowDraws = Callable[[int, Dict[str, torch.Tensor]], tuple]


def split_micro(batch: Dict[str, torch.Tensor], accum_steps: int
                ) -> List[Dict[str, torch.Tensor]]:
    """The batch's rows in ``accum_steps`` equal consecutive microbatches
    (the JAX package's reshape to (accum_steps, B / accum_steps, ...))."""
    b = next(iter(batch.values())).shape[0]
    if b % accum_steps:
        raise ValueError(f"batch of {b} rows does not split into "
                         f"{accum_steps} microbatches")
    n = b // accum_steps
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(accum_steps)]


def accumulate(state: TrainState, micro: Sequence, loss_fn) -> Dict:
    """Runs ``loss_fn(i, microbatch)`` and its backward for each
    microbatch, divides the summed gradients and losses by their count,
    applies the optimizer and advances ``state.step``.  Returns the mean
    loss and the unclipped global norm of the mean gradient."""
    opt = state.optimizer
    opt.zero_grad()
    total = 0.0
    for i, mb in enumerate(micro):
        loss = loss_fn(i, mb)
        loss.backward()
        total = total + loss.detach()
    n = len(micro)
    if n > 1:
        with torch.no_grad():
            torch._foreach_div_([p.grad for p in opt.params
                                 if p.grad is not None], n)
    gnorm = global_norm(opt.grads())
    opt.step()
    state.step += 1
    return {"loss": total / n, "grad_norm": gnorm}


def make_flow_train_step(model: CausalMaskedDiffWithXvec,
                         accum_steps: int = 1) -> Callable:
    """Returns ``step(state, batch, generator=None, draws=None) -> (state,
    metrics)``.

    batch: speech_token (B, Tt) int, token_valid (B, Tt) bool, speech_feat
    (B, Tm, D) f32, feat_valid (B, Tm) bool, embedding (B, E) f32, on the
    model's device.  Each microbatch's draws come from ``generator`` (the
    flow loss's, then the encoder's dropout masks at the config's
    ``dropout_rate``), or from ``draws(i, microbatch) -> (FlowLossDraws,
    drop)``.  metrics: ``loss`` and ``grad_norm`` (device scalars)."""
    rate = model.cfg.encoder.dropout_rate

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[FlowDraws] = None):
        m = state.model

        def loss_fn(i, mb):
            if draws is not None:
                d, drop = draws(i, mb)
            else:
                feat = mb["speech_feat"]
                d = FlowLossDraws.draw(tuple(feat.shape), generator,
                                       feat.device)
                drop = Dropout(rate, generator) if rate > 0 else None
            return m.loss(mb["speech_token"], mb["token_valid"],
                          mb["speech_feat"], mb["feat_valid"],
                          mb["embedding"], d, drop=drop)

        metrics = accumulate(state, split_micro(
            {k: batch[k] for k in FLOW_BATCH_KEYS}, accum_steps), loss_fn)
        return state, metrics

    return step

