"""Continuous batching for the speech LM (the vLLM role), after the JAX
package's ``serving/lm_server.py``: a fixed pool of slots, each a request
at its own KV position (``models/llm/qwen2.SlotKVCache``), with

- admission at any time: one slot's prefill and first token
  (``Qwen2SpeechLM.admit``); the text and speech buckets bound what a
  request may carry, as in JAX (a longer one raises ``ValueError`` before
  it takes a slot).  The JAX batcher pads a prompt to its bucket to bound
  its compiled shapes; the port prefills eagerly at the prompt's own
  length, so a request's prefill is exactly ``generate``'s;
- batched decode: ``step`` advances every active slot ``step_chunk``
  tokens as one CUDA graph replay of ``step_chunk`` single-token steps
  (per-slot RAS pick, min-length mask, counter-based noise keyed by the
  request's seed); the host reads the chunk's tokens once;
- eviction on eos (or at ``max_len``): the slot is free for the next
  submit, whose prefill overwrites it;
- ``recent > 0``: the two-tier cache, flushed between chunks.

With ``recent=0`` a request's tokens equal ``Qwen2SpeechLM.generate``'s for
its seed, whatever its slot, its neighbours and when it was admitted.  With
``recent > 0`` they do so only up to f32 rounding: the two-tier cache
scores [main ++ recent] split where the flushes fall, the same attention
rounded differently, so in bf16 a pick can flip.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.llm.speech_lm import DecodeState, Qwen2SpeechLM
from ..utils.graphs import StepGraphs

BatchState = DecodeState


class ContinuousBatcher:
    """Admission + batched decode over a fixed slot pool on the model's
    device.  ``graphs`` (on a CUDA device) replays each chunk of steps and
    each flush as a CUDA graph; ``graphs=False`` runs them eagerly.  A
    request's tokens are ``generate``'s for its seed with ``recent=0``, and
    up to f32 rounding with ``recent > 0``."""

    def __init__(self, model: Qwen2SpeechLM, slots: int = 4,
                 step_chunk: int = 16, text_buckets=(8, 16, 32, 64),
                 speech_buckets=(0, 16, 64), recent: int = 0,
                 graphs: bool = True):
        """``recent > 0``: two-tier KV cache (``qwen2.SlotKVCache``);
        requires recent > step_chunk.  It loses on the card, where the
        single-tier cache already writes each K/V row in place:
        ``chip_smoke.py``'s ``lm`` phase (four 250-token requests, 4
        slots, bf16, graphed, in turns on one H100) served 1,090 tokens a
        second with ``recent=64`` against 1,216 with ``recent=0``, and
        none of the four recent-mode streams equalled ``generate``'s.  It
        stays as the JAX package's surface."""
        if recent and recent <= step_chunk:
            raise ValueError(f"recent {recent} must exceed step_chunk "
                             f"{step_chunk}")
        self.model = model
        self.step_chunk = step_chunk
        self.recent = recent
        self._since_flush = 0
        self.text_buckets = tuple(sorted(text_buckets))
        self.speech_buckets = tuple(sorted(speech_buckets))
        self._free = list(range(slots))
        self._next_req = 0
        self._slot_req: Dict[int, Optional[int]] = {}
        self._streams: Dict[int, List[int]] = {}
        self._finished: Dict[int, bool] = {}
        self._max_len: Dict[int, int] = {}
        with torch.inference_mode():
            self.state = model.decode_state(slots, recent=recent)
            self._emits = torch.zeros(step_chunk, slots, dtype=torch.long,
                                      device=model.device)
            self._oks = torch.zeros(step_chunk, slots, dtype=torch.bool,
                                    device=model.device)
        self.steps = StepGraphs(model.device, graphs)

    # ------------------------------------------------------------- submit
    @torch.inference_mode()
    def submit(self, text_ids, prompt_speech_ids=None, seed: int = 0,
               max_len: int = 512) -> Optional[int]:
        """Admit a request; returns a request id, or None when every slot
        is busy.  Raises ValueError (before taking a slot) when the text or
        prompt is longer than the largest bucket, or prompt plus
        ``max_len`` exceeds the KV cache."""
        text = np.asarray(text_ids, np.int64).reshape(1, -1)
        speech = (np.zeros((1, 0), np.int64) if prompt_speech_ids is None
                  else np.asarray(prompt_speech_ids, np.int64).reshape(1, -1))
        n_text, n_speech = text.shape[1], speech.shape[1]
        if n_text > self.text_buckets[-1] or \
                n_speech > self.speech_buckets[-1]:
            raise ValueError(
                f"request exceeds buckets: text {n_text} > "
                f"{self.text_buckets[-1]} or prompt {n_speech} > "
                f"{self.speech_buckets[-1]}")
        cap = self.model.cfg.backbone.max_seq_len
        if 2 + n_text + n_speech + max_len > cap:
            raise ValueError(f"prompt {2 + n_text + n_speech} + max_len "
                             f"{max_len} exceeds max_seq_len {cap}")
        if not self._free:
            return None
        slot = self._free.pop(0)
        req = self._next_req
        self._next_req += 1
        self._slot_req[slot] = req
        min_len = int(np.float32(n_text)
                      * np.float32(self.model.cfg.min_token_text_ratio))
        tok0, done0 = self.model.admit(
            self.state, slot, self.model.prompt_embeds(text, speech), seed,
            min_len, max_len)
        tok0, done0 = int(tok0), bool(done0)
        self._streams[req] = [] if done0 else [tok0]
        self._finished[req] = done0
        self._max_len[req] = max_len
        if done0:
            self._release(slot)
        return req

    # -------------------------------------------------------------- decode
    def _chunk(self) -> None:
        for j in range(self.step_chunk):
            emit, ok, _ = self.model.decode_rows(self.state)
            self._emits[j].copy_(emit)
            self._oks[j].copy_(ok)

    @torch.inference_mode()
    def step(self) -> Dict[int, List[int]]:
        """Advance all active slots ``step_chunk`` tokens; returns the newly
        emitted tokens per request id (empty when idle)."""
        if not any(req is not None and not self._finished[req]
                   for req in self._slot_req.values()):
            return {}
        if self.recent and (self._since_flush + self.step_chunk
                            >= self.recent):
            self.steps.run(("flush",), lambda: self.model.llm.flush_slots(
                self.state.cache))
            self._since_flush = 0
        self.steps.run(("steps", self.step_chunk), self._chunk)
        self._since_flush += self.step_chunk
        emits = self._emits.cpu().numpy()              # (n, B)
        ok = self._oks.cpu().numpy()
        out: Dict[int, List[int]] = {}
        for slot, req in list(self._slot_req.items()):
            if req is None or self._finished[req]:
                continue
            toks = self._streams[req]
            new = [int(t) for t, o in zip(emits[:, slot], ok[:, slot]) if o]
            got_eos = not ok[:, slot].all()
            room = self._max_len[req] - len(toks)
            if len(new) >= room:                       # cap BEFORE reporting
                new = new[:room]
                got_eos = True
            if new:
                toks.extend(new)
                out[req] = new
            if got_eos:
                self.state.done[slot] = True
                self._finished[req] = True
                self._release(slot)
        return out

    def _release(self, slot: int):
        self._slot_req[slot] = None
        if slot not in self._free:
            self._free.append(slot)

    # ------------------------------------------------------------- queries
    def result(self, req: int) -> List[int]:
        return self._streams.get(req, [])

    def finished(self, req: int) -> bool:
        return self._finished.get(req, False)

    def run_all(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            if not self.step() and all(
                    self._finished.get(s, True) for s in self._streams):
                return
