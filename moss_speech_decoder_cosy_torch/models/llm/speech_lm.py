"""Speech-token language model, after the JAX package's
``models/llm/speech_lm.py`` (CosyVoice2 Qwen2LM, reference
llm.py:263-611): text tokens -> autoregressive speech tokens with
repetition-aware nucleus sampling (RAS).

The JAX package runs the whole generation loop as one traced
``lax.while_loop``.  The port keeps the loop on the card the CUDA way:
persistent KV and state buffers, device positions and device ``done`` /
``count`` tensors, and a chunk of single-token steps (forward, speech head,
log-softmax, min-length mask, RAS pick, history ring, embedding of the
picked token) captured as one CUDA graph and replayed.  The host reads the
state once per chunk, never once per token.  ``graphs=False`` runs the same
steps eagerly; a graph that fails to capture raises.

Sampling is split in two:

- ``ras_pick``, a pure function of (log-probs, history, Gumbel noise):
  ``jax.random.categorical(key, l)`` is ``argmax(gumbel(key) + l)``, so
  JAX's own noise fed here gives JAX's token;
- ``counter_gumbel``, the noise: counter-based, keyed by (request seed,
  draw index) with integer tensor ops, the same in a graph, on the CPU and
  on the card.  A request gets the same tokens in any slot and beside any
  neighbours (the JAX batcher's per-slot key chains promise the same).
  JAX's threefry streams are not reproduced.

``generate`` runs on the slot machinery of ``serving/lm_server.py`` at one
slot (``prefill_slot``, ``decode_step_slots``): a request decodes with the
same operations alone as it does in the batcher.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...utils.device import resolve_device
from ...utils.graphs import StepGraphs
from .qwen2 import Qwen2Config, Qwen2Model, SlotKVCache, tiny_qwen2_config

_NEG = -1.0e10
_M32 = 0xFFFFFFFF
GEN_CHUNK = 16               # single-token steps a generate graph runs
NoiseFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SpeechLMConfig:
    backbone: Qwen2Config = Qwen2Config()
    speech_token_size: int = 6561        # vocab 16384 for the MOSS tokenizer
    top_p: float = 0.8
    top_k: int = 25
    win_size: int = 10
    tau_r: float = 0.1
    min_token_text_ratio: float = 2.0
    max_token_text_ratio: float = 20.0
    mix_ratio: Tuple[int, int] = (5, 15)


def tiny_speech_lm_config() -> SpeechLMConfig:
    return SpeechLMConfig(backbone=tiny_qwen2_config(),
                          speech_token_size=32, top_k=8, win_size=4)


# ---------------------------------------------------------------- sampling
def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors holding values < 2^32 (the
    lowbias32 shape with multipliers below 2^31, so no product leaves
    int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def counter_gumbel(seeds: torch.Tensor, idx: torch.Tensor, n: int
                   ) -> torch.Tensor:
    """Gumbel noise (B, 2, n) f32 for draw ``idx`` (B,) of requests
    ``seeds`` (B,): stream 0 for the nucleus pick, stream 1 for the
    repetition fallback.  A pure function of (seed, draw, stream, lane)."""
    dev = seeds.device
    key = _mix32(_mix32(seeds.long() & _M32) ^ (idx.long() & _M32))
    stream = torch.arange(2, device=dev)
    key = _mix32(key[:, None] ^ (stream * 0x632BE5AB + 0x1B873593))
    lane = _mix32(torch.arange(n, device=dev) + 0x3C6EF372)
    h = _mix32(key[:, :, None] ^ lane)
    u = ((h >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)     # (0, 1)
    return -torch.log(-torch.log(u))


def ras_pick(logp: torch.Tensor, history: torch.Tensor,
             noise: torch.Tensor, cfg: SpeechLMConfig) -> torch.Tensor:
    """Repetition-aware nucleus sampling (utils/common.py:111-139) as a
    pure pick: logp (B, V), history (B, W), noise (B, 2, V) Gumbel draws
    over the sorted vocabulary.  Nucleus(top_p, top_k) picks with noise[:,
    0]; if the candidate appears >= win * tau_r times in the history, the
    plain sample over the whole distribution (noise[:, 1]) replaces it.
    The sort is stable (``jnp.argsort``'s ties: masked tokens all have
    probability 0) and 1e-20 goes in before each log, as in JAX."""
    probs = torch.softmax(logp, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sp = torch.gather(probs, -1, order)
    cum = torch.cumsum(sp, dim=-1)
    rank = torch.arange(sp.shape[-1], device=sp.device)
    keep = (((cum - sp) < cfg.top_p) & (rank < cfg.top_k)) | (rank == 0)
    masked = torch.where(keep, sp, 0.0)
    cand_at = torch.argmax(noise[:, 0] + torch.log(masked + 1e-20), dim=-1)
    cand = torch.gather(order, -1, cand_at[:, None])[:, 0]
    rep = (history == cand[:, None]).sum(-1)
    fb_at = torch.argmax(noise[:, 1] + torch.log(sp + 1e-20), dim=-1)
    fallback = torch.gather(order, -1, fb_at[:, None])[:, 0]
    return torch.where(rep >= cfg.win_size * cfg.tau_r, fallback, cand)


def pushed(history: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """The history ring (B, W) rolled left with ``tok`` (B,) at the end."""
    return torch.cat([history[:, 1:], tok[:, None]], dim=1)


def load_lm(model_cls, cfg, state, device=None, dtype=None):
    """``model_cls(cfg)`` (``Qwen2Model``, ``Qwen2SpeechLM``,
    ``TransformerLM``) holding ``state`` (``*_state_from_jax``,
    ``utils.checkpoint.convert_*_state_dict`` or ``weights.seeded_state``)
    on ``device`` (CUDA unless the caller asks for the CPU; raises if CUDA
    is missing), cast to ``dtype``, in eval mode."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = model_cls(cfg)
    model.load_state_dict(state, strict=True, assign=True)
    model = model.to(dev)
    return (model if dtype is None else model.to(dtype)).eval()


# ----------------------------------------------------------------- state
@dataclasses.dataclass
class DecodeState:
    """Per-row decode state on the device (the JAX batcher's
    ``BatchState``, plus each row's output cap)."""
    cache: SlotKVCache
    cur_emb: torch.Tensor          # (B, 1, D) embedding fed next
    history: torch.Tensor          # (B, W) int64
    seeds: torch.Tensor            # (B,) int64
    counts: torch.Tensor           # (B,) int64 accepted tokens
    done: torch.Tensor             # (B,) bool
    min_len: torch.Tensor          # (B,) int64
    max_len: torch.Tensor          # (B,) int64


class Qwen2SpeechLM(nn.Module):
    def __init__(self, cfg: SpeechLMConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.backbone.hidden_size
        v = cfg.speech_token_size + 3
        self.llm = Qwen2Model(cfg.backbone)
        # 0 = sos_eos, 1 = task_id (llm.py:289-291)
        self.llm_embedding = nn.Embedding(2, d)
        self.speech_embedding = nn.Embedding(v, d)
        self.llm_decoder = nn.Linear(d, v)
        self.noise: NoiseFn = counter_gumbel
        self._gen = None

    @property
    def device(self) -> torch.device:
        return self.llm_decoder.weight.device

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.long, device=self.device)

    # ---------------------------------------------------------------- emb
    def prompt_embeds(self, text, prompt_speech) -> torch.Tensor:
        """[sos, text emb, task_id, prompt speech emb] (llm.py:436-443);
        ids (1, T) as arrays or tensors."""
        text = self._ids(text)
        prompt_speech = self._ids(prompt_speech)
        sos = self.llm_embedding.weight[None, :1]
        task = self.llm_embedding.weight[None, 1:2]
        parts = [sos, self.llm.embed_tokens(text), task]
        if prompt_speech.shape[1] > 0:
            parts.append(self.speech_embedding(prompt_speech))
        return torch.cat(parts, dim=1)

    def prefill(self, embeds: torch.Tensor, cache=None):
        if cache is None:
            cache = self.llm.init_cache(embeds.shape[0])
        return self.llm.forward_embeds(embeds, cache)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Speech logits (B, V) of hidden states (B, D).  One row is padded
        to two: cuBLAS rounds a one-row product of this width differently
        from a product of several rows (measured on the H100), and a
        request's logits must not depend on how many slots decode."""
        if h.shape[0] == 1:
            return self.llm_decoder(torch.cat([h, torch.zeros_like(h)]))[:1]
        return self.llm_decoder(h)

    # ------------------------------------------------------------ sampling
    def sample(self, logits: torch.Tensor, forbid: torch.Tensor,
               history: torch.Tensor, seeds: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
        """log-softmax (f32), -1e10 where ``forbid`` (B, V), RAS pick with
        ``self.noise(seeds, idx)``; (B,) int64 tokens."""
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp = torch.where(forbid, _NEG, logp)
        return ras_pick(logp, history,
                        self.noise(seeds, idx, logp.shape[-1]), self.cfg)

    def min_len_forbid(self, counts: torch.Tensor, min_len: torch.Tensor
                       ) -> torch.Tensor:
        """Forbid eos and the >eos special ids while counts < min_len."""
        special = torch.arange(self.cfg.speech_token_size + 3,
                               device=counts.device) \
            >= self.cfg.speech_token_size
        return special[None] & (counts < min_len)[:, None]

    # ------------------------------------------------------------- decode
    def decode_state(self, rows: int, recent: int = 0) -> DecodeState:
        c, dev = self.cfg, self.device
        long = dict(dtype=torch.long, device=dev)
        return DecodeState(
            cache=self.llm.init_slot_cache(rows, recent=recent),
            cur_emb=torch.zeros(rows, 1, c.backbone.hidden_size,
                                dtype=self.llm_decoder.weight.dtype,
                                device=dev),
            history=torch.full((rows, c.win_size), -1, **long),
            seeds=torch.zeros(rows, **long), counts=torch.zeros(rows, **long),
            done=torch.ones(rows, dtype=torch.bool, device=dev),
            min_len=torch.zeros(rows, **long),
            max_len=torch.zeros(rows, **long))

    def admit(self, st: DecodeState, slot: int, embeds: torch.Tensor,
              seed: int, min_len: int, max_len: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prefill ``slot`` with ``embeds`` (1, P, D) and sample its first
        token (draw 0 of ``seed``); returns (token, done) as device
        scalars.  The generate loop's start and the batcher's submit."""
        c = self.cfg
        last, _ = self.llm.prefill_slot(st.cache, slot, embeds,
                                        embeds.shape[1])
        long = dict(dtype=torch.long, device=self.device)
        zero = torch.zeros(1, **long)
        seeds = torch.full((1,), seed, **long)
        hist0 = torch.full((1, c.win_size), -1, **long)
        tok0 = self.sample(self.head(last), self.min_len_forbid(
            zero, torch.full((1,), min_len, **long)), hist0, seeds, zero)
        done0 = tok0 >= c.speech_token_size
        st.cur_emb[slot] = self.speech_embedding(tok0)
        st.history[slot] = pushed(hist0, tok0)[0]
        st.seeds[slot] = seed
        st.counts[slot] = (~done0).long()[0]
        st.done[slot] = done0[0]
        st.min_len[slot] = min_len
        st.max_len[slot] = max_len
        return tok0[0], done0[0]

    def decode_rows(self, st: DecodeState
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One token for every row, in place (the JAX batcher's step):
        rows that are done or at their cap keep their state.  Returns
        (emit, ok, active): the token emitted (eos where none), whether a
        token was accepted, whether the row ran."""
        eos = self.cfg.speech_token_size
        active = ~st.done & (st.counts < st.max_len)
        h, _ = self.llm.decode_step_slots(st.cur_emb, st.cache,
                                          advance=active)
        toks = self.sample(self.head(h),
                           self.min_len_forbid(st.counts, st.min_len),
                           st.history, st.seeds, st.counts)
        ok = active & (toks < eos)
        st.history.copy_(torch.where(active[:, None],
                                     pushed(st.history, toks), st.history))
        st.cur_emb.copy_(torch.where(active[:, None, None],
                                     self.speech_embedding(toks[:, None]),
                                     st.cur_emb))
        st.counts += ok.long()
        st.done |= active & (toks >= eos)
        return torch.where(ok, toks, eos), ok, active

    def _generator(self):
        """The one-row state, the token buffer and the graph runner every
        ``generate`` call shares, whatever its ``max_len``: each row's cap
        is the device ``max_len`` in its state."""
        if self._gen is None:
            self._gen = (
                self.decode_state(1),
                torch.full((self.cfg.backbone.max_seq_len,),
                           self.cfg.speech_token_size, dtype=torch.long,
                           device=self.device),
                StepGraphs(self.device, True))
        return self._gen

    @torch.inference_mode()
    def generate(self, embeds: torch.Tensor, seed: int, min_len: int,
                 max_len: int, graphs: bool = True
                 ) -> Tuple[torch.Tensor, int]:
        """Full AR generation on the card: prefill, then chunks of
        ``GEN_CHUNK`` single-token steps, each chunk one CUDA graph replay
        (``graphs``; eager on the CPU or with ``graphs=False``) on
        persistent buffers; the host reads ``done`` and the count once per
        chunk.  Returns (tokens (max_len,) int64 padded with eos, count)."""
        eos = self.cfg.speech_token_size
        if embeds.shape[1] + max_len > self.cfg.backbone.max_seq_len:
            raise ValueError(f"prompt {embeds.shape[1]} + max_len {max_len} "
                             f"exceeds max_seq_len "
                             f"{self.cfg.backbone.max_seq_len}")
        st, out, steps = self._generator()
        out.fill_(eos)
        tok0, done0 = self.admit(st, 0, embeds, seed, min_len, max_len)
        out[0] = torch.where(done0, eos, tok0)

        def chunk():
            for _ in range(GEN_CHUNK):
                at = torch.minimum(st.counts, st.max_len - 1)
                emit, _, active = self.decode_rows(st)
                out.scatter_(0, at, torch.where(active, emit,
                                                out.gather(0, at)))

        while not bool(st.done[0] | (st.counts[0] >= max_len)):
            if graphs:
                steps.run(("gen", GEN_CHUNK), chunk)
            else:
                chunk()
        return out[:max_len].clone(), int(st.counts[0])

    def graphs(self) -> StepGraphs:
        """The graph runner of ``generate(..., graphs=True)``."""
        return self._generator()[2]

    def forward(self, text, prompt_speech, seed: int = 0, max_len: int = 64,
                graphs: bool = True):
        """Inference entry (llm.py:428-462): min_len from the text length."""
        embeds = self.prompt_embeds(text, prompt_speech)
        min_len = int(self._ids(text).shape[1]
                      * self.cfg.min_token_text_ratio)
        return self.generate(embeds, seed, min_len, max_len, graphs)


class BistreamSession:
    """Live text/speech interleave (llm.py:514-611): consume text in chunks
    of mix_ratio[0] tokens, emit up to mix_ratio[1] speech tokens per chunk.
    The RAS history ring persists across chunks.  Host-coordinated over the
    model's KV cache; each phase's steps run masked on the device and the
    host reads their state once per ``GEN_CHUNK`` steps.  Draw ``j`` of
    the session's ``c``-th phase is draw ``(c << 16) + j`` of ``seed``."""

    def __init__(self, model: Qwen2SpeechLM, seed: int = 0):
        self.model = model
        self.seed = seed
        self.cache = None
        self._text_buf: List[int] = []
        self._started = False
        self._phase = 0
        self._history = torch.full((1, model.cfg.win_size), -1,
                                   dtype=torch.long, device=model.device)
        # embedding of the last accepted speech token not yet in the KV
        # cache (fed before the next phase's inputs)
        self._pending_emb = None

    def _embed(self, ids: List[int]) -> torch.Tensor:
        return self.model.llm.embed_tokens(self.model._ids([ids]))

    def _special(self, i: int) -> torch.Tensor:
        return self.model.llm_embedding.weight[None, i:i + 1]

    def _start(self, embeds: torch.Tensor) -> torch.Tensor:
        if not self._started:
            embeds = torch.cat([self._special(0), embeds], dim=1)
            self.cache = self.model.llm.init_cache(1)
            self._started = True
        elif self._pending_emb is not None:
            embeds = torch.cat([self._pending_emb, embeds], dim=1)
        self._pending_emb = None
        return embeds

    @torch.inference_mode()
    def _phase_tokens(self, embeds: torch.Tensor, n: int, final: bool
                      ) -> np.ndarray:
        """Prefill ``embeds``, then sample up to n speech tokens.  Mid-stream
        eos is masked and the fill token (speech_token_size + 2) ends the
        phase (llm.py:570-591); in the final phase eos is allowed and ends
        generation (llm.py:595-611).  The stop token is never fed back; a
        phase that ends on its budget leaves its last token pending."""
        m, c = self.model, self.model.cfg
        eos = c.speech_token_size
        stop_tok = eos if final else eos + 2
        ids = torch.arange(eos + 3, device=m.device)
        allow = ids <= eos if final else (ids < eos) | (ids == eos + 2)
        forbid = ~allow[None]
        base = self._phase << 16
        self._phase += 1
        long = dict(dtype=torch.long, device=m.device)
        seeds = torch.full((1,), self.seed, **long)

        h, self.cache = m.llm.forward_embeds(embeds, self.cache)
        tok = m.sample(m.head(h[:, -1]), forbid, self._history, seeds,
                       torch.full((1,), base, **long))
        stop = tok == stop_tok
        out = torch.full((n,), eos, **long)
        out[0] = torch.where(stop[0], eos, tok[0])
        hist = torch.where(stop[:, None], self._history,
                           pushed(self._history, tok))
        cur = m.speech_embedding(tok[:, None])
        i = (~stop).long()
        done = stop
        for step in range(1, n):
            if step % GEN_CHUNK == 0 and bool(done[0] | (i[0] >= n)):
                break
            active = ~done & (i < n)
            h, self.cache = m.llm.forward_embeds(cur, self.cache,
                                                 n_valid=active.long()[0])
            tok = m.sample(m.head(h[:, -1]), forbid, hist, seeds, base + i)
            stop = tok == stop_tok
            write = active & ~stop
            at = i.clamp(max=n - 1)
            out.scatter_(0, at, torch.where(write, tok, out.gather(0, at)))
            hist = torch.where(write[:, None], pushed(hist, tok), hist)
            cur = torch.where(write[:, None, None],
                              m.speech_embedding(tok[:, None]), cur)
            i = i + write.long()
            done = done | (active & stop)
        self._history = hist
        count = int(i[0])
        # budget spent without fill / eos: the last token's embedding has
        # not been fed through the backbone yet
        self._pending_emb = None if bool(done[0]) or count == 0 else cur
        return out[:count].cpu().numpy()

    def push_text(self, text_ids: Iterable[int]) -> List[np.ndarray]:
        """Feed text tokens; returns the speech chunks the ratio fills."""
        self._text_buf.extend(int(t) for t in text_ids)
        n_text, n_speech = self.model.cfg.mix_ratio
        out = []
        with torch.inference_mode():
            while len(self._text_buf) >= n_text:
                chunk, self._text_buf = (self._text_buf[:n_text],
                                         self._text_buf[n_text:])
                toks = self._phase_tokens(self._start(self._embed(chunk)),
                                          n_speech, final=False)
                if toks.size:
                    out.append(toks)
        return out

    def flush(self, n_final: Optional[int] = None) -> List[np.ndarray]:
        """Consume the trailing text (< mix_ratio[0] tokens) and decode until
        eos (llm.py:593-611: [pending speech emb] ++ text ++ task_id);
        ``n_final`` (default 4 * mix_ratio[1]) bounds the decode."""
        n_text, n_speech = self.model.cfg.mix_ratio
        n_final = n_final or 4 * n_speech
        if not self._started and not self._text_buf:
            return []
        chunk, self._text_buf = self._text_buf, []
        with torch.inference_mode():
            parts = [self._embed(chunk)] if chunk else []
            embeds = self._start(torch.cat(parts + [self._special(1)],
                                           dim=1))
            toks = self._phase_tokens(embeds, n_final, final=True)
        return [toks] if toks.size else []
