"""Speech-LM training in one process: the teacher-forced next-token loss
and DPO, after the JAX package's ``training/lm.py`` (reference
cosyvoice/llm/llm.py:263-427, utils/losses.py:24-60).

- ``pack_lm_batch`` builds each row's [sos, text, task, speech, pad...]
  sequence by gathers and selects over per-row lengths (no ragged loop);
- the backbone runs ``Qwen2Model.forward_causal``, a cache-free causal
  forward (the serving cache's in-place writes are no place for autograd,
  nor its ``max_seq_len`` slots for a training batch);
- ``label_smoothing_loss`` (transformer/label_smoothing_loss.py) with
  ignore-padding masking and the accuracy; ``dpo_loss``, the sigmoid form
  with label smoothing and IPO.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.llm.speech_lm import Qwen2SpeechLM
from ..parallel.mesh import DataGroup
from .train_step import TrainState


def pack_lm_batch(model: Qwen2SpeechLM, text: torch.Tensor,
                  text_len: torch.Tensor, speech: torch.Tensor,
                  speech_len: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(embeds (B, L, D), targets (B, L), loss_mask (B, L)), L = Tt + Ts +
    2.  Position j's logits predict targets[j]: the speech tokens, then
    eos (llm.py:296-330)."""
    b, tt = text.shape
    ts = speech.shape[1]
    eos = model.cfg.speech_token_size
    length = tt + ts + 2
    dev = text.device
    pos = torch.arange(length, device=dev)[None, :]
    tl = text_len.to(dev).long()[:, None]
    sl = speech_len.to(dev).long()[:, None]
    text_emb = model.llm.embed_tokens(text.long())
    speech_emb = model.speech_embedding(speech.long())
    sos = model.llm_embedding.weight[0]
    task = model.llm_embedding.weight[1]
    d = text_emb.shape[-1]

    def gather(src, idx):
        return torch.gather(src, 1, idx.expand(b, length)[..., None]
                            .expand(b, length, d))

    gather_t = gather(text_emb, torch.clamp(pos - 1, 0, tt - 1))
    gather_s = gather(speech_emb, torch.clamp(pos - tl - 2, 0, ts - 1))
    is_sos = (pos == 0)[..., None]
    is_text = ((pos >= 1) & (pos < 1 + tl))[..., None]
    is_task = (pos == 1 + tl)[..., None]
    is_speech = ((pos >= 2 + tl) & (pos < 2 + tl + sl))[..., None]
    zero = torch.zeros((), dtype=text_emb.dtype, device=dev)
    embeds = torch.where(is_sos, sos, torch.where(
        is_text, gather_t, torch.where(is_task, task, torch.where(
            is_speech, gather_s, zero))))
    tgt_idx = torch.clamp(pos - tl - 1, 0, ts - 1).expand(b, length)
    gather_tgt = torch.gather(speech.long(), 1, tgt_idx)
    predicts_speech = (pos >= 1 + tl) & (pos < 1 + tl + sl)
    predicts_eos = pos == 1 + tl + sl
    targets = torch.where(predicts_speech, gather_tgt, torch.where(
        predicts_eos, torch.full_like(gather_tgt, eos),
        torch.full_like(gather_tgt, -1)))
    return embeds, targets, predicts_speech | predicts_eos


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor, smoothing: float = 0.0,
                         reduce=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """KL(label-smoothed one-hot || softmax) over the valid positions, and
    the accuracy.  ``reduce`` (a data-parallel rank's): the valid count
    summed over the ranks, so the ranks' shares add up to the global
    batch's mean."""
    v = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    tgt = torch.clamp(targets, min=0)
    confidence = 1.0 - smoothing
    smooth = smoothing / (v - 1)
    onehot = F.one_hot(tgt, v).float() * (confidence - smooth) + smooth
    nll = -torch.sum(onehot * logp, dim=-1)
    m = mask.float()
    count = m.sum()
    if reduce is not None:
        count = reduce(count.detach())
    denom = torch.clamp(count, min=1.0)
    loss = torch.sum(nll * m) / denom
    acc = torch.sum((logits.argmax(-1) == tgt).float() * m) / denom
    return loss, acc


def _logits(model: Qwen2SpeechLM, batch: Dict[str, torch.Tensor],
            speech_key: str = "speech"):
    embeds, targets, mask = pack_lm_batch(
        model, batch["text_token"], batch["text_token_len"],
        batch[f"{speech_key}_token"], batch[f"{speech_key}_token_len"])
    return model.llm_decoder(model.llm.forward_causal(embeds)), targets, mask


def lm_loss(model: Qwen2SpeechLM, batch: Dict[str, torch.Tensor],
            smoothing: float = 0.0, reduce=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: text_token (B, Tt), text_token_len (B,), speech_token
    (B, Ts), speech_token_len (B,).  ``reduce`` as in
    ``label_smoothing_loss``."""
    logits, targets, mask = _logits(model, batch)
    loss, acc = label_smoothing_loss(logits, targets, mask, smoothing,
                                     reduce)
    return loss, {"loss": loss, "acc": acc}


def sequence_logp(model: Qwen2SpeechLM, batch: Dict[str, torch.Tensor],
                  speech_key: str = "speech") -> torch.Tensor:
    """The sum of each row's per-token log-probs over its speech region
    and eos (B,)."""
    logits, targets, mask = _logits(model, batch, speech_key)
    logp = F.log_softmax(logits.float(), dim=-1)
    tok = torch.gather(logp, -1, torch.clamp(targets, min=0)[..., None])
    return torch.sum(tok[..., 0] * mask.float(), dim=-1)


def dpo_loss(policy_chosen: torch.Tensor, policy_rejected: torch.Tensor,
             ref_chosen: torch.Tensor, ref_rejected: torch.Tensor,
             beta: float = 0.01, label_smoothing: float = 0.0,
             ipo: bool = False):
    """The DPO objective (utils/losses.py:24-60): (mean loss, chosen
    rewards, rejected rewards)."""
    logits = (policy_chosen - policy_rejected) - (ref_chosen - ref_rejected)
    if ipo:
        losses = (logits - 1.0 / (2.0 * beta)) ** 2
    else:
        losses = (-F.logsigmoid(beta * logits) * (1 - label_smoothing)
                  - F.logsigmoid(-beta * logits) * label_smoothing)
    chosen_rw = beta * (policy_chosen - ref_chosen).detach()
    rejected_rw = beta * (policy_rejected - ref_rejected).detach()
    return losses.mean(), chosen_rw, rejected_rw


def _update(state: TrainState, loss: torch.Tensor, dp=None) -> None:
    """One update; ``dp``: the gradients summed over its ranks first."""
    opt = state.optimizer
    opt.zero_grad()
    loss.backward()
    if dp is not None:
        for p in opt.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            dp.sum_([p.grad for p in opt.params])
    opt.step()
    state.step += 1


def make_lm_train_step(smoothing: float = 0.0,
                       dp: Optional[DataGroup] = None):
    """``step(state, batch) -> (state, metrics)``: one CE update of
    ``state.model`` (a ``Qwen2SpeechLM``, or its tensor-parallel shard);
    metrics ``loss``, ``acc``.  ``dp`` (a ``parallel.mesh.DataGroup``;
    None for one process or under pure tensor parallelism): ``batch`` is the rank's rows, the mean runs over the global batch's
    valid positions and the gradients are summed over the ranks."""
    reduce = None if dp is None else dp.sum

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, metrics = lm_loss(state.model, batch, smoothing, reduce)
        _update(state, loss, dp)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if dp is not None:
            metrics = {k: dp.sum(v) for k, v in metrics.items()}
        return state, metrics
    return step


def make_dpo_train_step(ref_model: Qwen2SpeechLM, beta: float = 0.01,
                        ipo: bool = False, label_smoothing: float = 0.0,
                        dp: Optional[DataGroup] = None):
    """``step(state, batch) -> (state, metrics)``: one DPO update of
    ``state.model`` over chosen / rejected completions against the frozen
    ``ref_model`` (the pre-DPO policy).  batch: text_token /
    text_token_len and {chosen, rejected}_token / _token_len.  metrics:
    ``loss``, ``reward_margin``, ``reward_acc``.  ``dp`` as in
    ``make_lm_train_step``: the means run over the global batch's rows
    (every rank holds as many)."""
    world = 1 if dp is None else dp.world

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        m = state.model
        pc = sequence_logp(m, batch, "chosen")
        pr = sequence_logp(m, batch, "rejected")
        with torch.no_grad():
            rc = sequence_logp(ref_model, batch, "chosen")
            rr = sequence_logp(ref_model, batch, "rejected")
        loss, crw, rrw = dpo_loss(pc, pr, rc, rr, beta=beta,
                                  label_smoothing=label_smoothing, ipo=ipo)
        loss = loss / world
        _update(state, loss, dp)
        metrics = {"loss": loss.detach(),
                   "reward_margin": (crw - rrw).mean() / world,
                   "reward_acc": (crw > rrw).float().mean() / world}
        if dp is not None:
            metrics = {k: dp.sum(v) for k, v in metrics.items()}
        return state, metrics
    return step
