"""Fixture driver: the port's speech LM scoring given speech tokens in slots.

One ``Qwen2SpeechLM`` (its weights the family's seeded states) holds a slot
cache of ``engine.slots`` rows.  A request's [sos, prompt, task] embeddings
prefill a free slot (``Qwen2Model.prefill_slot``); each decode step
(``Qwen2Model.decode_step_slots``, every slot at its own position, as the LM
server's batch step runs) then feeds every live slot its request's next
speech token.  A request is served the speech head's logits of the
prefill's last position and of each step: (n_tokens + 1, V).  The traffic's
``clients`` requests are live at a time, each client sending its next when
its last has ended; a speech token counts as 1/12.5 s of audio
(``token_rate``).  The run's counters ``lm.decode_steps`` and
``lm.decode_s`` count the decode steps that ran in the window and their
host time, each step's logits fetched to the host.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench.harness.traffic import Request, Traffic
from port_bench.harness.window import Record, RunResult

DRAIN_S = 60.0


@dataclasses.dataclass
class Served:
    """A finished request's inputs and the logits it was served."""
    tokens: np.ndarray          # (n,) int32 speech tokens fed
    prompt: np.ndarray          # (p,) int32 text ids
    output: np.ndarray          # (n + 1, V) float32 logits


class Driver:
    def __init__(self, cell, seed: int, device, trace: bool):
        self.cell, self.seed, self.device, self.trace = cell, seed, device, trace
        self.sample_rate = float(cell.config["token_rate"])
        self.slots = int(cell.cell["engine"]["slots"])
        self.clients = int(cell.traffic["clients"])
        if self.clients > self.slots:
            raise ValueError(f"{self.clients} clients on {self.slots} slots")
        self.traffic = Traffic(cell.traffic, seed)
        self.lm = self.cache = None
        self._served: Dict[int, Served] = {}
        self.counters = {"lm.decode_steps": 0, "lm.decode_s": 0.0}
        self.setup_parts: Dict[str, float] = {}

    def setup(self) -> None:
        from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
            Qwen2SpeechLM, load_lm)
        fam = self.cell.family()
        t = time.perf_counter()
        self.lm = load_lm(Qwen2SpeechLM, fam.lm_config(self.cell.config),
                          fam.states(self.cell, self.seed, self.device),
                          device=self.device)
        self.cache = self.lm.llm.init_slot_cache(self.slots)
        self.setup_parts["build"] = time.perf_counter() - t
        t = time.perf_counter()
        n = int(self.cell.traffic["tokens"]["min"])
        warm = Request(-1, np.zeros(n, np.int32), np.zeros(0, np.float32),
                       np.zeros(1, np.int32))
        self._serve([(warm, None)])
        self.setup_parts["warm_request"] = time.perf_counter() - t

    @torch.inference_mode()
    def _prefill(self, slot: int, req: Request) -> np.ndarray:
        emb = self.lm.prompt_embeds(req.prompt[None], np.zeros((1, 0)))
        last, _ = self.lm.llm.prefill_slot(self.cache, slot, emb,
                                           emb.shape[1])
        return self.lm.head(last)[0].float().cpu().numpy()

    @torch.inference_mode()
    def _step(self, live: Dict[int, list]) -> np.ndarray:
        """One decode step of every slot; the live ones advance."""
        ids = np.zeros(self.slots, np.int64)
        advance = np.zeros(self.slots, bool)
        for s, (req, _, rows) in live.items():
            ids[s], advance[s] = req.tokens[len(rows) - 1], True
        emb = self.lm.speech_embedding(torch.as_tensor(ids, device=self.device))
        h, _ = self.lm.llm.decode_step_slots(
            emb[:, None], self.cache,
            advance=torch.as_tensor(advance, device=self.device))
        return self.lm.head(h).float().cpu().numpy()

    def _serve(self, queue, t1: float = None) -> None:
        """Serve ``queue`` (an iterator of (request, record)) on the slots,
        ``clients`` at a time, taking new ones until ``t1`` and finishing the
        live ones within ``DRAIN_S`` after it."""
        queue = iter(queue)
        live: Dict[int, list] = {}
        more = True
        while True:
            now = time.perf_counter()
            while more and len(live) < self.clients and (t1 is None
                                                         or now < t1):
                nxt = next(queue, None)
                if nxt is None:
                    more = False
                    break
                req, rec = nxt
                slot = min(set(range(self.slots)) - set(live))
                live[slot] = [req, rec, [self._prefill(slot, req)]]
            if not live or (t1 is not None and now > t1 + DRAIN_S):
                return
            t_step = time.perf_counter()
            logits = self._step(live)
            t = time.perf_counter()
            if t1 is not None and t_step < t1:
                self.counters["lm.decode_steps"] += 1
                self.counters["lm.decode_s"] += t - t_step
            for s in list(live):
                req, rec, rows = live[s]
                rows.append(logits[s])
                if rec is not None:
                    rec.chunks.append((t, 1))
                    rec.t_first = rec.t_first or t
                if len(rows) == req.n_tokens + 1:
                    del live[s]
                    if rec is not None:
                        rec.t_last = t
                        self._served[req.index] = Served(
                            req.tokens, req.prompt, np.stack(rows))

    def run(self, seconds: float) -> RunResult:
        records: List[Record] = []

        def queue():
            for i in itertools.count():
                req = self.traffic.get(i)
                rec = Record(i, req.n_tokens, req.n_tokens / self.sample_rate,
                             time.perf_counter())
                records.append(rec)
                yield req, rec

        t0 = time.perf_counter()
        t1 = t0 + seconds
        self._serve(queue(), t1)
        return RunResult(self.cell, records, t0, t1, self.sample_rate,
                         counters=dict(self.counters),
                         t_done=time.perf_counter())

    def served(self) -> Dict[int, Served]:
        return dict(self._served)

    def close(self) -> None:
        self.lm = self.cache = None
