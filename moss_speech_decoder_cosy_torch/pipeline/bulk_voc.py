"""Bulk vocoding: the whole hop chain of a stream in one batched HiFT pass,
after the JAX package's ``pipeline/bulk_voc.py``.

The per-hop vocoder chain is sequential only through three caches, and
each can be resolved after one batched pass:

- mel cache: the previous ``mel_cache_len`` global mel frames, known once
  the whole mel is;
- source cache: the previous hop's last ``scl`` excitation samples; the
  head replacement is pointwise and ``2*scl <= hop wav length``, so every
  hop's source tail is independent of its own head fix: one shifted gather
  resolves the chain;
- speech cache: the previous hop's last ``scl`` wav samples for the Hamming
  cross-fade, which rewrites only the head.

So the steady hops stack on the batch axis, source and decode run once
each, and two shifted head fixes give the sequential chain's output.  One
stream (batch 1); the segmented and multi-stream forms are not ported.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class BulkVocoder:
    """Vocodes a whole mel with the session's hop semantics (``emit_frames``
    mel frames per hop, ``mel_cache_len`` frames of context, cross-fades)."""

    def __init__(self, dec, emit_frames: int):
        self.dec = dec
        self.F = emit_frames
        self.C = dec.pipe_cfg.mel_cache_len
        self.scl = dec.source_cache_len
        self.u = dec.hift_cfg.total_upsample
        if 2 * self.C > self.F + self.C:
            raise ValueError("hop too small for independent head fixes")
        win = torch.from_numpy(np.hamming(2 * self.scl).astype(np.float32))
        self._fade_in = win[: self.scl].to(dec.device)
        self._fade_out = win[self.scl:].to(dec.device)

    def _steady(self, wins, last_s_tail, last_w_tail):
        """Steady hops batched: wins (n, F+C, D) in the compute dtype.
        Returns (emit (1, n*F*u) f32, s_tail, w_tail)."""
        hift, scl = self.dec.hift, self.scl
        ss = hift.source(wins)                               # (n, (F+C)u, 1)
        prev_s = torch.cat([last_s_tail.to(ss.dtype), ss[:-1, -scl:]])
        ss = torch.cat([prev_s, ss[:, scl:]], dim=1)
        ws = hift.decode(wins, ss)                           # (n, (F+C)u)
        prev_w = torch.cat([last_w_tail.to(ws.dtype), ws[:-1, -scl:]])
        heads = ws[:, :scl] * self._fade_in + prev_w * self._fade_out
        ws_fixed = torch.cat([heads, ws[:, scl:].float()], dim=1)
        emit = ws_fixed[:, : (self.F + self.C) * self.u - scl]
        return emit.reshape(1, -1), ss[-1:, -scl:], ws[-1:, -scl:]

    def _tail_hop(self, mel_t, last_s_tail, last_w_tail):
        """Finalize hop over mel (1, C + tail, D): emits everything."""
        hift, scl = self.dec.hift, self.scl
        s_t = hift.source(mel_t)
        s_t = torch.cat([last_s_tail.to(s_t.dtype), s_t[:, scl:]], dim=1)
        w_t = hift.decode(mel_t, s_t)
        head = w_t[:, :scl] * self._fade_in + last_w_tail * self._fade_out
        return torch.cat([head, w_t[:, scl:].float()], dim=1)

    @torch.inference_mode()
    def vocode(self, mel: torch.Tensor, plan: Sequence[int]) -> torch.Tensor:
        """mel (1, Tm, D) f32 on the decoder's device; ``plan`` the per-hop
        emit mel-frame counts [F, ..., F, tail], or one finalize hop [n].
        Returns the wav (1, sum(plan) * u) f32 on the device."""
        if mel.shape[0] != 1:
            raise NotImplementedError("bulk vocoding of several lockstep "
                                      "streams is ROADMAP item A3")
        if any(p != self.F for p in plan[:-1]):
            raise ValueError(f"every hop but the last emits {self.F} frames, "
                             f"got {list(plan)}")
        dt = self.dec._dt()
        f, c, scl, u = self.F, self.C, self.scl, self.u
        n_steady = max(len(plan) - 2, 0)
        tail = plan[-1] if len(plan) > 1 else 0
        first = plan[0] if len(plan) == 1 else f
        hift = self.dec.hift

        mel0 = mel[:, :first].to(dt)
        s0 = hift.source(mel0)
        w0 = hift.decode(mel0, s0)
        if n_steady == 0 and tail == 0:
            return w0.float()              # one hop: nothing withheld
        outs = [w0[:, : f * u - scl].float()]
        s_tail, w_tail = s0[:, -scl:], w0[:, -scl:]
        if n_steady > 0:
            starts = (1 + torch.arange(n_steady, device=mel.device)) * f - c
            idx = starts[:, None] + torch.arange(f + c, device=mel.device)
            emit, s_tail, w_tail = self._steady(mel[0][idx].to(dt), s_tail,
                                                w_tail)
            outs.append(emit)
        if tail > 0:
            t0 = (1 + n_steady) * f
            outs.append(self._tail_hop(mel[:, t0 - c: t0 + tail].to(dt),
                                       s_tail, w_tail))
        return torch.cat(outs, dim=1)
