"""Device-resident windowed streaming decode, after the JAX package's
``pipeline/device_session.py`` (``DeviceStreamDecoder``).

The host-mediated session (``audio_decoder.StreamSession``) hands every
window to the host and back.  This session keeps the stream on the device
and keeps the reference's windowed semantics:

- the token buffer is uploaded once, from pinned memory;
- each hop re-decodes a bounded window: ``max_token_len`` tokens gathered
  at the device token offset, the flow, the emit slice, HiFT with its mel,
  source and speech caches, and the Hamming cross-fade; the hop's audio
  goes into a device buffer of the whole stream, at a place computed from
  the device offset;
- runs of steady hops go in power-of-two buckets (64, 16, 4, 2): at batch
  1 all the windows of a bucket go through the flow as ONE batched forward
  (``_flow_batched``, ``bucket`` x 2 rows with CFG), at batch > 1 the
  bucket's flow hops run in sequence (``_flow_scan``: one flow hop at a
  device scan index, run ``bucket`` times); then the bucket's vocoder hops
  in sequence, carrying the caches (``_voc_scan``);
- the audio comes back in one copy at the end (``output="int16"``
  quantizes on the device first).

On CUDA (``graphs=True``, the default) every step is a CUDA graph
(``utils/graphs.StepGraphs``, all in one memory pool), keyed as the JAX
package keys its jits by their static arguments: ``("flow", emit,
finalize)``, ``("voc", first, finalize, emit)``, ``("fused", emit, first,
finalize)``, ``("fbatch", bucket, emit)``, ``("fscan", bucket, emit)`` and
``("vscan", bucket)`` (a steady hop emits the session's hop).  The
finalize hop emits the stream's tail, so its keys carry that length.  The
first call of a key runs eagerly and captures it; later calls replay it
(a flow scan's graph holds one hop and replays ``bucket`` times: a graph
of 16 flow forwards took minutes to capture).
A step reads its per-call values from the device (the state's token
offset, which each vocoder hop advances), and nothing is read back to the
host before the final copy.  The NSF source's draws are made once per
vocoder length, outside capture.  ``graphs=False`` runs the same steps
eagerly; on the CPU there are no graphs.

The windows are right-padded while the stream is shorter than the window,
and the flash chunk-attention kernel masks only a scalar length (the
estimator poisons its output then), so this path runs with
``use_flash_attention=False``, as ``bench.py`` does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.flops import DispatchMeter
from ..utils.graphs import StepGraphs
from .kv_session import KVVocState, _pcm16, vocode_hop

# bucket sizes of a run of steady hops, largest first
BUCKETS = (64, 16, 4, 2)


def _rows(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x`` with ``m`` rows: itself, or its one row broadcast."""
    return x if x.shape[0] == m else x.expand((m,) + tuple(x.shape[1:]))


@dataclasses.dataclass
class DeviceStreamState:
    """The stream's state: persistent device tensors, zeroed in place."""
    token_offset: torch.Tensor    # () long, emitted tokens so far
    mel_cache: torch.Tensor       # (B, mel_cache_len, n_mel) f32
    source_cache: torch.Tensor    # (B, scl, 1) f32
    speech_cache: torch.Tensor    # (B, scl) f32

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return (self.token_offset, self.mel_cache, self.source_cache,
                self.speech_cache)


class DeviceStreamDecoder:
    """Streaming decoder bound to an ``AudioDecoder``'s modules: hops of
    ``block_size`` tokens over windows of ``max_token_len``, ``batch``
    streams in lockstep sharing one prompt.  ``graphs`` replays each step
    as a CUDA graph on a CUDA device."""

    def __init__(self, dec, prompt_token: np.ndarray,
                 prompt_feat: np.ndarray, embedding: np.ndarray,
                 block_size: int, max_token_len: int, batch: int = 1,
                 graphs: bool = True):
        self.dec = dec
        self.batch = batch
        self.hop = block_size
        self.window = max_token_len
        self.p = int(prompt_token.shape[1])
        self.prompt_pad = int(
            math.ceil(self.p / self.hop) * self.hop - self.p)
        self.la = dec.lookahead
        self.ratio = dec.ratio
        self.frame = dec.hift_cfg.total_upsample
        self.mel_cache_len = dec.pipe_cfg.mel_cache_len
        self.scl = dec.source_cache_len
        self.n_mel = dec.flow_cfg.output_size
        self.dev = dec.device
        self.dt = dec._dt()

        def bcast(x: np.ndarray, dtype) -> torch.Tensor:
            return _rows(torch.from_numpy(np.ascontiguousarray(x)).to(
                self.dev, dtype), batch)
        self._prompt_tok = bcast(np.asarray(prompt_token), torch.long)
        self._prompt_feat = bcast(np.asarray(prompt_feat, np.float32),
                                  self.dt)
        self._emb = bcast(np.asarray(embedding, np.float32), self.dt)
        win = torch.from_numpy(np.hamming(2 * self.scl).astype(np.float32))
        self._fade_in = win[: self.scl].to(self.dev)
        self._fade_out = win[self.scl:].to(self.dev)

        self.meter = DispatchMeter()
        self._steps = StepGraphs(self.dev, graphs, self.meter)
        self._graphs = self._steps.enabled
        self._state: Optional[DeviceStreamState] = None
        self._tok: Optional[torch.Tensor] = None    # (B, cap) tokens
        self._out: Optional[torch.Tensor] = None    # (B, cap*r*u) audio
        self._mels: Dict[tuple, torch.Tensor] = {}  # the flow steps' output
        self._draws: Dict[int, tuple] = {}          # vocoder frames -> draws
        self._copier = None                 # stream_chunks' copy stream
        self._host_offset = 0               # the host's mirror of the offset
        self._scan_i: Optional[torch.Tensor] = None   # a flow scan's hop

    # ------------------------------------------------------------- state
    @torch.inference_mode()
    def init_state(self) -> DeviceStreamState:
        """The session's state, made at first use and zeroed in place:
        offset 0, empty vocoder caches."""
        if self._state is None:
            def z(*shape):
                return torch.zeros(shape, device=self.dev)
            self._state = DeviceStreamState(
                torch.zeros((), dtype=torch.long, device=self.dev),
                z(self.batch, self.mel_cache_len, self.n_mel),
                z(self.batch, self.scl, 1), z(self.batch, self.scl))
            self._scan_i = torch.zeros((), dtype=torch.long, device=self.dev)
        for t in self._state.tensors():
            t.zero_()
        self._host_offset = 0
        return self._state

    @torch.inference_mode()
    def _token_buf(self, tokens: np.ndarray) -> torch.Tensor:
        """The session's token buffer holding ``tokens`` (batch, n), then
        zeros: one upload, from pinned memory without a wait.  The token
        and audio buffers grow when a stream outgrows them, and the graphs
        captured on the old ones are dropped."""
        tokens = np.asarray(tokens)
        if tokens.ndim != 2 or tokens.shape[0] != self.batch:
            raise ValueError(f"tokens {tokens.shape} for a session of batch "
                             f"{self.batch}")
        if self._copier is not None:    # stream_chunks' copies read _out
            torch.cuda.current_stream(self.dev).wait_stream(self._copier)
        n = tokens.shape[1]
        if self._tok is None or self._tok.shape[1] < n + self.window:
            cap = -(-(n + self.window) // 256) * 256
            self._tok = torch.zeros((self.batch, cap), dtype=torch.long,
                                    device=self.dev)
            self._out = torch.zeros(
                (self.batch, cap * self.ratio * self.frame), device=self.dev)
            self._steps.graphs.clear()
        host = torch.zeros(self._tok.shape, dtype=torch.long,
                           pin_memory=self.dev.type == "cuda")
        host[:, :n] = torch.from_numpy(tokens.astype(np.int64))
        return self._tok.copy_(host, non_blocking=True)

    def _own(self, state, token_buf=None) -> None:
        if state is not self._state or (token_buf is not None
                                        and token_buf is not self._tok):
            raise ValueError("the steps run on the session's own buffers: "
                             "pass _token_buf(tokens) and init_state()")

    # ------------------------------------------------------------- steps
    def _window_mels(self, offsets: torch.Tensor, emit_tokens: int,
                     finalize: bool) -> torch.Tensor:
        """The flow over the windows at token offsets ``offsets`` ((m,) on
        the device: the batch's rows, or a bucket's windows at batch 1) ->
        their emit mels (m, emit*ratio, n_mel) f32.  A window is the prompt
        and the ``window`` tokens that end ``emit + la`` tokens past its
        offset (``emit`` at finalize), right-padded while the stream is
        shorter; indices are built on the device."""
        m, w, p, r, dev = (offsets.shape[0], self.window, self.p, self.ratio,
                           self.dev)
        ends = offsets + emit_tokens + (0 if finalize else self.la)
        starts = torch.clamp(ends - w, min=0)
        windows = _rows(self._tok, m).gather(
            1, starts[:, None] + torch.arange(w, device=dev))
        tokens = torch.cat([_rows(self._prompt_tok, m), windows], dim=1)
        valid = (torch.arange(p + w, device=dev)[None, :]
                 < (p + ends - starts)[:, None])
        mel = self.dec.flow(tokens, valid, _rows(self._prompt_feat, m),
                            _rows(self._emb, m), streaming=True,
                            finalize=finalize)
        frames = ((p + offsets - starts)[:, None] * r
                  + torch.arange(emit_tokens * r, device=dev))
        return mel.gather(1, frames[..., None].expand(-1, -1, mel.shape[-1]))

    def _offsets(self, shift=0) -> torch.Tensor:
        """The state's offset (+ ``shift``, a host int or a device scalar)
        for each of the batch's rows."""
        return (self._state.token_offset + shift).reshape(1).expand(
            self.batch)

    def _flow_impl(self, emit_tokens: int, finalize: bool) -> None:
        """Flow half of a hop at the state's offset (the JAX package's
        ``_flow_step_impl``): the emit mel into its buffer."""
        self._mels[emit_tokens, finalize].copy_(
            self._window_mels(self._offsets(), emit_tokens, finalize))

    def _voc_impl(self, mel: torch.Tensor, first: bool, finalize: bool,
                  draws) -> None:
        """Vocoder half of a hop (the JAX package's ``_voc_step_impl``):
        HiFT over the mel cache and ``mel`` (B, emit*ratio, n_mel), the
        cross-fade, the audio into the stream buffer at the state's offset,
        the caches updated and the offset advanced by emit."""
        st = self._state
        wav, new = vocode_hop(
            self.dec.hift, self._fade_in, self._fade_out, self.mel_cache_len,
            self.dt, mel, KVVocState(st.mel_cache, st.source_cache,
                                     st.speech_cache), first, finalize, draws)
        pos = (st.token_offset * (self.ratio * self.frame)
               - (0 if first else self.scl))
        self._out.index_copy_(
            1, pos + torch.arange(wav.shape[1], device=self.dev), wav)
        if not finalize:
            st.mel_cache.copy_(new.mel_cache)
            st.source_cache.copy_(new.source_cache)
            st.speech_cache.copy_(new.speech_cache)
        st.token_offset.add_(mel.shape[1] // self.ratio)

    def _step_impl(self, emit_tokens: int, first: bool, finalize: bool,
                   draws) -> None:
        """The whole hop as one step (the JAX package's ``_step_impl``)."""
        self._voc_impl(self._window_mels(self._offsets(), emit_tokens,
                                         finalize), first, finalize, draws)

    def _flow_batched_impl(self, bucket: int, emit_tokens: int) -> None:
        """All ``bucket`` steady windows as ONE flow forward at batch
        ``bucket`` (batch 1 only; the JAX package's ``_flow_batched_impl``):
        the flow hops are independent, only the vocoder caches chain."""
        offsets = self._state.token_offset + emit_tokens * torch.arange(
            bucket, device=self.dev)
        self._mels[bucket].copy_(
            self._window_mels(offsets, emit_tokens, False)[:, None])

    def _flow_scan_impl(self, bucket: int, emit_tokens: int) -> None:
        """One hop of a flow scan (the body of the JAX package's
        ``_flow_scan_impl``), run ``bucket`` times from ``_scan_i`` = 0: the
        steady hop ``_scan_i`` hops past the state's offset, its mel into
        row ``_scan_i`` of the bucket's buffer, then ``_scan_i`` += 1."""
        i = self._scan_i
        mel = self._window_mels(self._offsets(i * emit_tokens), emit_tokens,
                                False)
        self._mels[bucket].index_copy_(0, i.reshape(1), mel[None])
        i.add_(1)

    def _voc_scan_impl(self, bucket: int, draws) -> None:
        """The vocoder over the bucket's stacked mels in sequence, carrying
        the caches (the JAX package's ``_voc_scan_impl``)."""
        for i in range(bucket):
            self._voc_impl(self._mels[bucket][i], False, False, draws)

    def _mel_buf(self, key, rows: int, emit_tokens: int) -> torch.Tensor:
        """The flow output buffer of a step: (rows, emit*ratio, n_mel) for a
        hop, one more leading axis for a bucket."""
        got = self._mels.get(key)
        if got is None:
            shape = (rows, emit_tokens * self.ratio, self.n_mel)
            if isinstance(key, int):
                shape = (key,) + shape
            got = self._mels[key] = torch.empty(shape, device=self.dev)
        return got

    def _draws_for(self, frames: int):
        """The NSF draws of a vocoder hop over ``frames`` mel frames, made
        once per length outside any capture (HiFT's own draws build a
        generator per call)."""
        got = self._draws.get(frames)
        if got is None:
            hift = self.dec.hift
            got = self._draws[frames] = hift.draws(
                hift.cfg.nb_harmonics + 1, frames * self.frame, self.dev)
        return got

    def _launch(self, key: tuple) -> None:
        """Runs the step ``key`` (a key of ``dispatches``) on the session's
        buffers: eagerly, or captured then replayed as a graph."""
        kind, b = key[0], self.batch
        fn: Callable[[], None]
        emitted, reps = 0, 1
        if kind == "flow":
            _, emit, finalize = key
            self._mel_buf((emit, finalize), b, emit)
            fn = functools.partial(self._flow_impl, emit, finalize)
        elif kind == "voc":
            _, first, finalize, emitted = key
            frames = self._voc_frames(emitted, first)
            fn = functools.partial(
                self._voc_impl, self._mel_buf((emitted, finalize), b, emitted),
                first, finalize, self._draws_for(frames))
        elif kind == "fused":
            _, emitted, first, finalize = key
            fn = functools.partial(self._step_impl, emitted, first, finalize,
                                   self._draws_for(
                                       self._voc_frames(emitted, first)))
        elif kind == "fbatch":
            _, bucket, emit = key
            self._mel_buf(bucket, b, emit)
            fn = functools.partial(self._flow_batched_impl, bucket, emit)
        elif kind == "fscan":
            _, reps, emit = key
            self._mel_buf(reps, b, emit)
            self._scan_i.zero_()
            fn = functools.partial(self._flow_scan_impl, reps, emit)
        else:                                             # "vscan"
            bucket = key[1]
            emitted = bucket * self.hop
            fn = functools.partial(self._voc_scan_impl, bucket,
                                   self._draws_for(
                                       self._voc_frames(self.hop, False)))
        for _ in range(reps):
            self._steps.run(key, fn)
        self._host_offset += emitted

    def _voc_frames(self, emit_tokens: int, first: bool) -> int:
        """Mel frames into HiFT at a vocoder hop: the cache, then the hop's."""
        return emit_tokens * self.ratio + (0 if first else self.mel_cache_len)

    # ------------------------------------------ the JAX package's steps
    @torch.inference_mode()
    def _flow_step(self, token_buf, state, emit_tokens: int,
                   finalize: bool) -> torch.Tensor:
        """Flow half of the hop at the state's offset; returns the step's
        mel buffer (B, emit*ratio, n_mel)."""
        self._own(state, token_buf)
        self._launch(("flow", emit_tokens, bool(finalize)))
        return self._mels[emit_tokens, bool(finalize)]

    @torch.inference_mode()
    def _voc_step(self, mel: torch.Tensor, state, first: bool,
                  finalize: bool) -> Tuple[torch.Tensor, DeviceStreamState]:
        """Vocoder half of the hop over ``mel``; returns (the hop's audio,
        a view of the stream buffer, and the state)."""
        self._own(state)
        emit = mel.shape[1] // self.ratio
        buf = self._mel_buf((emit, bool(finalize)), self.batch, emit)
        if mel is not buf:
            buf.copy_(mel)
        a = self._seg_start(self._host_offset, first)
        self._launch(("voc", bool(first), bool(finalize), emit))
        return self._out[:, a:a + self._seg_len(emit, first, finalize)], state

    def _seg_len(self, emit_tokens: int, first: bool, finalize: bool) -> int:
        """Samples a hop emits: all it vocodes but the speech cache's, all
        at finalize."""
        return (self._voc_frames(emit_tokens, first) * self.frame
                - (0 if finalize else self.scl))

    def _seg_start(self, offset: int, first: bool) -> int:
        """Where the audio of the hop at token ``offset`` starts."""
        return offset * self.ratio * self.frame - (0 if first else self.scl)

    # ------------------------------------------------------------------
    def schedule(self, n_tokens: int) -> List[Tuple[int, bool, bool]]:
        """Hop plan: [(emit_tokens, first, finalize), ...] mirroring
        stream_inference (flow_inference.py:187-237)."""
        plan = []
        offset = 0
        first = True
        while True:
            this_hop = self.hop + self.prompt_pad if first else self.hop
            if n_tokens - offset < this_hop + self.la:
                break
            plan.append((this_hop, first, False))
            offset += this_hop
            first = False
        plan.append((n_tokens - offset, first, True))
        return plan

    def dispatches(self, n_tokens: int, fused: bool = False) -> List[tuple]:
        """The steps one ``stream_decode`` of ``n_tokens`` runs, in order, by
        graph key: runs of identical steady hops (split path) in buckets of
        64, 16, 4 and 2, a batched flow forward (batch 1) or a flow scan
        (batch > 1) then a vocoder scan each; every other hop as its flow
        and vocoder steps, or as one fused step."""
        plan = [p for p in self.schedule(n_tokens) if p[0] > 0]
        keys: List[tuple] = []
        i = 0
        while i < len(plan):
            emit, first, finalize = plan[i]
            if not fused and not first and not finalize:
                j = i
                while j < len(plan) and plan[j] == (emit, False, False):
                    j += 1
                run = j - i
                if run > 1:
                    for bucket in BUCKETS:
                        while run >= bucket:
                            keys.append(("fbatch" if self.batch == 1
                                         else "fscan", bucket, emit))
                            keys.append(("vscan", bucket))
                            run -= bucket
                    i = j - run
                    continue
            if fused:
                keys.append(("fused", emit, first, finalize))
            else:
                keys += [("flow", emit, finalize),
                         ("voc", first, finalize, emit)]
            i += 1
        return keys

    @torch.inference_mode()
    def _decode_device(self, tokens: np.ndarray, fused: bool
                       ) -> torch.Tensor:
        """Uploads ``tokens`` and enqueues every step of the stream; returns
        its audio (B, samples) f32, a view of the stream buffer on the
        device.  Reads nothing back to the host."""
        n = int(np.asarray(tokens).shape[1])
        self._token_buf(tokens)
        self.init_state()
        for key in self.dispatches(n, fused):
            self._launch(key)
        total = sum(self._seg_len(*p) for p in self.schedule(n) if p[0] > 0)
        return self._out[:, :total]

    @torch.inference_mode()
    def stream_decode(self, tokens: np.ndarray, fused: bool = False,
                      output: str = "float32") -> np.ndarray:
        """Whole-stream decode of (batch, n) tokens with one upload and one
        copy back.  ``fused=False`` (default) runs the split flow / vocoder
        steps with the bucketed steady hops; ``fused=True`` one step per
        hop; both give the same audio.  ``output='int16'`` quantizes on the
        device to 16-bit PCM (the reference's wire and file format), half
        the bytes to copy."""
        if output not in ("float32", "int16"):
            raise ValueError(f"output {output!r}: 'float32' or 'int16'")
        wav = self._decode_device(tokens, fused)
        if output == "int16":
            wav = _pcm16(wav)
        if self.dev.type != "cuda":
            return wav.clone().numpy()
        host = torch.empty(wav.shape, dtype=wav.dtype, pin_memory=True)
        host.copy_(wav, non_blocking=True)
        torch.cuda.current_stream(self.dev).synchronize()
        return host.numpy()

    def warmup(self, n_tokens: int):
        """Runs (and on CUDA captures) the steps of an n-token stream."""
        self.stream_decode(np.zeros((self.batch, n_tokens), np.int32))

    def program_flops(self, n_tokens: int, fused: bool = False) -> float:
        """The FLOPs of one ``stream_decode(n_tokens, fused)`` as the port
        runs it: one decode of n zero tokens through the session's meter
        (``utils/flops.py``), each step key's FLOPs counted in one eager run
        and multiplied by its dispatches (the JAX package's
        ``program_flops`` over the same dispatch sequence)."""
        self.meter.reset()
        self.meter.enabled = True
        try:
            self._decode_device(np.zeros((self.batch, n_tokens), np.int32),
                                fused)
        finally:
            self.meter.enabled = False
        return self.meter.total_flops()


@torch.inference_mode()
def _dispatch_hops(decoder: DeviceStreamDecoder, tokens: np.ndarray):
    """Enqueues every hop of the stream as its flow and vocoder steps and,
    on CUDA, each hop's audio copy into one pinned host buffer on a copy
    stream, after an event of that hop.  Returns (host audio (B, samples)
    f32 numpy, [(start, end, copy-done event or None)] per hop)."""
    n = int(np.asarray(tokens).shape[1])
    decoder._token_buf(tokens)
    decoder.init_state()
    hops = [p for p in decoder.schedule(n) if p[0] > 0]
    total = sum(decoder._seg_len(*p) for p in hops)
    cuda = decoder.dev.type == "cuda"
    host = None
    if cuda:
        if decoder._copier is None:
            decoder._copier = torch.cuda.Stream(decoder.dev)
        host = torch.empty((decoder.batch, total), pin_memory=True)
    spans = []
    for emit, first, finalize in hops:
        a = decoder._seg_start(decoder._host_offset, first)
        b = a + decoder._seg_len(emit, first, finalize)
        decoder._launch(("flow", emit, finalize))
        decoder._launch(("voc", first, finalize, emit))
        done = None
        if cuda:
            hop_done = torch.cuda.Event()
            hop_done.record()
            decoder._copier.wait_event(hop_done)
            with torch.cuda.stream(decoder._copier):
                host[:, a:b].copy_(decoder._out[:, a:b], non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        spans.append((a, b, done))
    if not cuda:
        host = decoder._out[:, :total].clone()
    return host.numpy(), spans


def stream_chunks(decoder: DeviceStreamDecoder, tokens: np.ndarray):
    """True-streaming consumer: enqueues every hop up front, then yields the
    hops' audio in order, each as soon as its copy to the host is done,
    while later hops compute and copy.  Yields float32 (B, samples) arrays,
    one per hop."""
    host, spans = _dispatch_hops(decoder, tokens)
    for a, b, done in spans:
        if done is not None:
            done.synchronize()
        yield host[:, a:b]
