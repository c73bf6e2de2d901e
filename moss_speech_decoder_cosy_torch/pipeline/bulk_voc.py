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
for each batch of hops, and two shifted head fixes give the sequential
chain's output.  The
chain also splits into segments (``vocode_first`` then ``vocode_cont``,
each carrying the source and speech tails to the next) that give, joined,
the one-pass output: the segmented KV wavefront vocodes each segment as it
leaves.

Several lockstep streams (mel (B, Tm, D)) vocode together: each stream
keeps its own mel context and source and speech tails; the steady windows
of all streams (stream-major) go through HiFT in the same batches of
``WINDOW_BATCH``, and each stream's first and tail hop run as a batch of
one, as they do for a stream alone.  The NSF source's draws depend only on the window's
length and are shared by every row, so each stream gets the draws it would
get alone, as the JAX package's per-stream ``vmap`` with one key does.

The steady hops' windows go through HiFT in batches of ``WINDOW_BATCH``,
the last one padded with zero windows.  On the card cuDNN and cuBLAS pick
their kernels by the batch, and bf16 HiFT turns the last-bit differences
that follow into 12% of the wav's peak (an H100, full width, 48 windows at
once against 22 then 26: 8.2e-4 of a 7.0e-3 peak; ``bin/window_batch.py``).
With one batch shape a window's audio does not depend on how the stream was
cut into segments, nor on how many streams share the call: segmented and
one-pass vocoding agree bit for bit, and so do a lockstep stream and the
same stream alone wherever its windows fill the same batches.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# hop windows per HiFT call of the steady hops (see the module's doc)
WINDOW_BATCH = 16


def _in_batches(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` over the rows of ``xs`` in batches of ``WINDOW_BATCH`` rows,
    the last padded with zeros; the rows' results, concatenated."""
    n, outs = xs[0].shape[0], []
    for i in range(0, n, WINDOW_BATCH):
        parts = [x[i:i + WINDOW_BATCH] for x in xs]
        m = parts[0].shape[0]
        if m < WINDOW_BATCH:
            parts = [torch.cat([p, p.new_zeros((WINDOW_BATCH - m,)
                                               + tuple(p.shape[1:]))])
                     for p in parts]
        outs.append(fn(*parts)[:m])
    return torch.cat(outs)


def _per_row(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` over each row of ``xs`` as a batch of one; the rows' results,
    concatenated."""
    return torch.cat([fn(*(x[i:i + 1] for x in xs))
                      for i in range(xs[0].shape[0])])


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
        """Steady hops batched: wins (B, n, F+C, D) in the compute dtype,
        the tails (B, scl, 1) and (B, scl).  Returns (emit (B, n*F*u) f32,
        s_tail, w_tail)."""
        hift, scl = self.dec.hift, self.scl
        b, n = wins.shape[:2]
        flat = wins.reshape((b * n,) + tuple(wins.shape[2:]))
        ss = _in_batches(hift.source, flat).reshape(b, n, -1, 1)
        prev_s = torch.cat([last_s_tail[:, None].to(ss.dtype),
                            ss[:, :-1, -scl:]], dim=1)
        ss = torch.cat([prev_s, ss[:, :, scl:]], dim=2)
        ws = _in_batches(hift.decode, flat,
                         ss.reshape((b * n,) + tuple(ss.shape[2:])))
        ws = ws.reshape(b, n, -1)                        # (B, n, (F+C)u)
        prev_w = torch.cat([last_w_tail[:, None].to(ws.dtype),
                            ws[:, :-1, -scl:]], dim=1)
        heads = ws[..., :scl] * self._fade_in + prev_w * self._fade_out
        ws_fixed = torch.cat([heads, ws[..., scl:].float()], dim=2)
        emit = ws_fixed[..., : (self.F + self.C) * self.u - scl]
        return emit.reshape(b, -1), ss[:, -1, -scl:], ws[:, -1, -scl:]

    def _tail_hop(self, mel_t, last_s_tail, last_w_tail):
        """Finalize hop over mel (B, C + tail, D): emits everything."""
        hift, scl = self.dec.hift, self.scl
        s_t = _per_row(hift.source, mel_t)
        s_t = torch.cat([last_s_tail.to(s_t.dtype), s_t[:, scl:]], dim=1)
        w_t = _per_row(hift.decode, mel_t, s_t)
        head = w_t[:, :scl] * self._fade_in + last_w_tail * self._fade_out
        return torch.cat([head, w_t[:, scl:].float()], dim=1)

    def _impl(self, mel: torch.Tensor, n_steady: int, tail_frames: int,
              first_frames: int, hold: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """mel (B, Tm, D), hop plan [first] + [F] * n_steady + [tail].
        Returns (wav (B, samples) f32, s_tail, w_tail): the tails let a
        later segment continue the chain (``vocode_cont``).  ``hold`` marks
        a segment that more segments follow: a lone first hop then withholds
        its last ``scl`` samples for the next cross-fade instead of emitting
        everything."""
        dt = self.dec._dt()
        f, c, scl, u = self.F, self.C, self.scl, self.u
        hift = self.dec.hift
        mel0 = mel[:, :first_frames].to(dt)
        s0 = _per_row(hift.source, mel0)
        w0 = _per_row(hift.decode, mel0, s0)
        s_tail, w_tail = s0[:, -scl:], w0[:, -scl:]
        if n_steady == 0 and tail_frames == 0:
            if hold:                       # a mid-stream one-hop segment
                return w0[:, : f * u - scl].float(), s_tail, w_tail
            return w0.float(), s_tail, w_tail   # one hop: nothing withheld
        outs = [w0[:, : f * u - scl].float()]
        if n_steady > 0:
            starts = (1 + torch.arange(n_steady, device=mel.device)) * f - c
            emit, s_tail, w_tail = self._steady(
                self._windows(mel, starts).to(dt), s_tail, w_tail)
            outs.append(emit)
        if tail_frames > 0:
            t0 = (1 + n_steady) * f
            outs.append(self._tail_hop(mel[:, t0 - c: t0 + tail_frames].to(dt),
                                       s_tail, w_tail))
        return torch.cat(outs, dim=1), s_tail, w_tail

    def _windows(self, mel: torch.Tensor, starts: torch.Tensor
                 ) -> torch.Tensor:
        """The (B, n, F + C, D) hop windows of mel (B, Tm, D) at
        ``starts``."""
        idx = starts[:, None] + torch.arange(self.F + self.C,
                                             device=mel.device)
        return mel[:, idx]

    @torch.inference_mode()
    def vocode(self, mel: torch.Tensor, plan: Sequence[int]) -> torch.Tensor:
        """mel (B, Tm, D) f32 on the decoder's device, B lockstep streams;
        ``plan`` the per-hop emit mel-frame counts [F, ..., F, tail], or one
        finalize hop [n].  Returns the wav (B, sum(plan) * u) f32 on the
        device."""
        if any(p != self.F for p in plan[:-1]):
            raise ValueError(f"every hop but the last emits {self.F} frames, "
                             f"got {list(plan)}")
        n_steady = max(len(plan) - 2, 0)
        tail = plan[-1] if len(plan) > 1 else 0
        first = plan[0] if len(plan) == 1 else self.F
        return self._impl(mel, n_steady, tail, first)[0]

    @torch.inference_mode()
    def vocode_first(self, mel: torch.Tensor, n_steady: int,
                     tail_frames: int, hold: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The first segment of a segmented stream: the first hop and
        ``n_steady`` steady hops, plus the finalize tail when this is also
        the last segment (``hold=True`` when more segments follow).  mel
        (B, F * (1 + n_steady) + tail, D).  Returns (wav, s_tail, w_tail)
        for ``vocode_cont``."""
        return self._impl(mel, n_steady, tail_frames, self.F, hold)

    @torch.inference_mode()
    def vocode_cont(self, mel_ctx: torch.Tensor, s_tail: torch.Tensor,
                    w_tail: torch.Tensor, n_steady: int, tail_frames: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A continuation segment: ``mel_ctx`` (B, C + F * n_steady + tail,
        D) holds each stream's previous C mel frames, then the segment's;
        ``s_tail`` / ``w_tail`` the previous segment's.  Returns (wav
        (B, (F * n_steady + tail) * u) f32, s_tail, w_tail); the segments
        joined give the one-pass ``vocode`` bit for bit."""
        dt = self.dec._dt()
        f, c = self.F, self.C
        outs = []
        if n_steady > 0:
            starts = torch.arange(n_steady, device=mel_ctx.device) * f
            emit, s_tail, w_tail = self._steady(
                self._windows(mel_ctx, starts).to(dt), s_tail, w_tail)
            outs.append(emit)
        if tail_frames > 0:
            t0 = c + n_steady * f
            outs.append(self._tail_hop(
                mel_ctx[:, t0 - c: t0 + tail_frames].to(dt), s_tail, w_tail))
        return torch.cat(outs, dim=1), s_tail, w_tail
