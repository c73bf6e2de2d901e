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

Data parallelism (the JAX package's mesh step, the reference's DDP):
under an initialized process group each rank passes its rows
(``parallel.distributed.local_rows``); the step pads them to the ranks'
longest, draws the global batch's draws from a generator seeded alike on
every rank and keeps its rows, divides the masked mean by the mask's count
over every rank, and sums the gradients in one all-reduce, so the update
is the single-process step's on the global batch.  ``AdamW(zero=group)``
keeps only the rank's ``zero_sharding`` slices of the moments (ZeRO),
updates its slices and all-gathers the parameters.

A train step runs the plain paths: the CUDA kernels have no backward and
raise under autograd (``ops/autograd_guard.forbid_autograd``).
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
from ..parallel.mesh import DataGroup, zero_dim
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
    loop over the flow's 1121 tensors launched ~14 kernels each.

    ``zero`` (a ``DataGroup``; the gradients already summed over it): each
    rank keeps the moments of its slice of every parameter that
    ``zero_sharding`` splits (chunk ``rank`` along ``zero_dims``), updates
    that slice, and all-gathers the slices; replicated parameters update
    whole on every rank.  ``norm_fn``: the clip's global norm of the
    gradients (default ``global_norm``; tensor parallelism sums the
    sliced parameters' squares over its ranks)."""

    def __init__(self, params: Iterable[nn.Parameter], schedule: Schedule,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 clip_norm: Optional[float] = None,
                 zero: Optional[DataGroup] = None,
                 norm_fn: Optional[Callable] = None):
        self.params: List[nn.Parameter] = [p for p in params
                                           if p.requires_grad]
        if any(p.dtype != torch.float32 for p in self.params):
            raise ValueError("AdamW updates f32 parameters only")
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.norm_fn = norm_fn
        self.zero = zero
        self.zero_dims = [None] * len(self.params)
        if zero is not None:
            self.zero_dims = [zero_dim(tuple(p.shape), zero.world)
                              for p in self.params]
        self.count = 0
        self.mu = [torch.zeros_like(self._mine(p, d))
                   for p, d in zip(self.params, self.zero_dims)]
        self.nu = [torch.zeros_like(m) for m in self.mu]

    def _mine(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's ZeRO slice of ``t`` (a view), or ``t``."""
        if dim is None:
            return t
        return t.chunk(self.zero.world, dim)[self.zero.rank]

    def moment_bytes(self) -> int:
        """The bytes of the moments this rank holds."""
        return sum(m.numel() * m.element_size() for m in self.mu + self.nu)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def grad_norm(self) -> torch.Tensor:
        """The global 2-norm of the gradients (``norm_fn``'s)."""
        if self.norm_fn is not None:
            return self.norm_fn(self.params)
        return global_norm(self.grads())

    @torch.no_grad()
    def step(self) -> None:
        grads = self.grads()
        if self.clip_norm is not None:
            # scaled by max_norm / norm only when norm >= max_norm, no eps
            norm = self.grad_norm()
            scale = torch.where(norm >= self.clip_norm,
                                self.clip_norm / norm, torch.ones_like(norm))
            grads = torch._foreach_mul(grads, scale)
        params = self.params
        if self.zero is not None:
            params = [self._mine(p, d) for p, d in zip(params,
                                                        self.zero_dims)]
            grads = [self._mine(g, d) for g, d in zip(grads, self.zero_dims)]
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
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        if self.zero is not None:
            self.zero.gather_slices(self.params, self.zero_dims)


def make_optimizer(peak_lr: float = 1e-3, warmup_steps: int = 2500,
                   clip_norm: float = 5.0, zero: Optional[DataGroup] = None,
                   norm_fn: Optional[Callable] = None):
    """A factory ``params -> AdamW``: clip by global norm ``clip_norm``,
    then AdamW under ``warmup_lr(peak_lr, warmup_steps)``; ``zero`` and
    ``norm_fn`` as ``AdamW``'s."""
    def build(params: Iterable[nn.Parameter]) -> AdamW:
        return AdamW(params, warmup_lr(peak_lr, warmup_steps),
                     clip_norm=clip_norm, zero=zero, norm_fn=norm_fn)
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


def accumulate(state: TrainState, micro: Sequence, loss_fn,
               dp: Optional[DataGroup] = None) -> Dict:
    """Runs ``loss_fn(i, microbatch)`` and its backward for each
    microbatch, divides the summed gradients and losses by their count,
    applies the optimizer and advances ``state.step``.  Returns the mean
    loss and the unclipped global norm of the mean gradient.  ``dp``: the
    gradients and the losses (each rank's share of its microbatch's) are
    summed over the ranks first."""
    opt = state.optimizer
    opt.zero_grad()
    total = 0.0
    for i, mb in enumerate(micro):
        loss = loss_fn(i, mb)
        loss.backward()
        total = total + loss.detach()
    n = len(micro)
    if dp is not None:
        for p in opt.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            dp.sum_([p.grad for p in opt.params])
        total = dp.sum(total)
    if n > 1:
        with torch.no_grad():
            torch._foreach_div_([p.grad for p in opt.params
                                 if p.grad is not None], n)
    gnorm = opt.grad_norm()
    opt.step()
    state.step += 1
    return {"loss": total / n, "grad_norm": gnorm}


def pad_to(batch: Dict[str, torch.Tensor], lengths: Dict[str, int]
           ) -> Dict[str, torch.Tensor]:
    """Each tensor of ``batch`` zero-padded (False for a mask) along dim 1
    to ``lengths[key]`` where it is shorter."""
    out = dict(batch)
    for k, n in lengths.items():
        t = out[k]
        if t.shape[1] < n:
            pad = t.new_zeros((t.shape[0], n - t.shape[1]) + t.shape[2:])
            out[k] = torch.cat([t, pad], dim=1)
    return out


def global_rows(dp: DataGroup, batch: Dict[str, torch.Tensor],
                keys: Sequence[str]):
    """A data-parallel rank's view of the global batch: (its rows, each
    tensor of ``keys`` padded along dim 1 to the ranks' longest, the
    global row count, the rank's first row).  Every rank holds as many
    rows."""
    b = next(iter(batch.values())).shape[0]
    dev = next(iter(batch.values())).device
    sizes = dp.max(torch.tensor([b, -b] + [batch[k].shape[1] for k in keys],
                                device=dev))
    sizes = [int(x) for x in sizes.cpu()]
    if sizes[0] != -sizes[1]:
        raise ValueError(f"data-parallel ranks hold {-sizes[1]} to "
                         f"{sizes[0]} rows; each must hold as many")
    padded = pad_to(batch, dict(zip(keys, sizes[2:])))
    return padded, b * dp.world, b * dp.rank


def make_flow_train_step(model: CausalMaskedDiffWithXvec,
                         accum_steps: int = 1,
                         dp: Optional[DataGroup] = None) -> Callable:
    """Returns ``step(state, batch, generator=None, draws=None) -> (state,
    metrics)``.

    batch: speech_token (B, Tt) int, token_valid (B, Tt) bool, speech_feat
    (B, Tm, D) f32, feat_valid (B, Tm) bool, embedding (B, E) f32, on the
    model's device.  Each microbatch's draws come from ``generator`` (the
    flow loss's, then the encoder's dropout masks at the config's
    ``dropout_rate``), or from ``draws(i, microbatch) -> (FlowLossDraws,
    drop)``.  metrics: ``loss`` and ``grad_norm`` (device scalars).

    ``dp`` (a ``parallel.mesh.DataGroup``; None for one process):
    ``batch`` is the rank's rows, the same count on
    every rank, and ``generator`` seeded alike on every rank; microbatch
    i of the global batch is every rank's microbatch i, in rank order."""
    rate = model.cfg.encoder.dropout_rate

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[FlowDraws] = None):
        m = state.model
        batch = {k: batch[k] for k in FLOW_BATCH_KEYS}
        rows = None
        if dp is not None:
            batch, total, lo = global_rows(dp, batch, (
                "speech_token", "token_valid", "speech_feat", "feat_valid"))
            n = batch["speech_token"].shape[0] // accum_steps
            rows = (lo // accum_steps, lo // accum_steps + n,
                    total // accum_steps)

        def loss_fn(i, mb):
            if draws is not None:
                d, drop = draws(i, mb)
            else:
                feat = mb["speech_feat"]
                shape = tuple(feat.shape)
                if rows is not None:
                    shape = (rows[2],) + shape[1:]
                d = FlowLossDraws.draw(shape, generator, feat.device)
                if rows is not None:
                    d = d.rows(rows[0], rows[1], shape[1])
                drop = Dropout(rate, generator, rows) if rate > 0 else None
            return m.loss(mb["speech_token"], mb["token_valid"],
                          mb["speech_feat"], mb["feat_valid"],
                          mb["embedding"], d, drop=drop,
                          reduce=None if dp is None else dp.sum)

        metrics = accumulate(state, split_micro(batch, accum_steps),
                             loss_fn, dp)
        return state, metrics

    return step

