"""KV-cached streaming decode, after the JAX package's
``pipeline/kv_session.py``.

The windowed session (``audio_decoder.StreamSession``) re-decodes a bounded
token window per hop, as the reference does.  This session pushes every
token through the flow once, attending to circular KV rings
(``models/flow/kv_stream.py``).  ``stream_decode`` runs:

- a prompt prefill through the per-hop KV step (when there is a prompt);
- the steady hops as a wavefront: the encoder per hop, then one estimator
  forward per iteration that batches all S ODE steps (slot s holds the
  chunk that has done s Euler steps).  The loop runs exactly the
  k + S - 1 live iterations; the JAX package's scan padded them to buckets
  of 16 for XLA;
- the finalize tail through the per-hop KV step;
- bulk vocoding of the whole hop chain (``bulk_voc.py``), or the per-hop
  vocoder chain;
- one copy back, of f32 audio or of 16-bit PCM quantized on the device
  (``output="int16"``).

``segmented=True`` runs the same wavefront iterations in segments of
``seg_iters``, vocodes each segment as it leaves (``BulkVocoder.
vocode_first`` / ``vocode_cont``, the tails carried) and copies it back on
a copy stream while the next segment computes; the segments joined are the
unsegmented stream bit for bit.  ``stream_chunks`` yields the audio hop by
hop, or (``wavefront=True``) segment by segment on a growing schedule, each
chunk as its copy lands.  Unlike the JAX package, a segment runs whatever
engine the session has, the ``fused_tf_group`` kernel engine included: a
segment is a run of the same iteration replays.

Dataflows (the JAX package's ``CausalConditionalCFMWave``):
``fused=True`` (the default) writes each layer's chunk K/V into a ring
extended to ring + chunk before attending; ``fused=False`` (the concat
dataflow) attends over [ring ++ chunk] and writes after the estimator, into
the canonical rings.  The write goes at one shared offset under per-slot
rotated slot numbering when the ring is a multiple of the hop (the rings
are rotated, or extended rotated, at the wavefront's entry and back at its
exit), else, or with ``write_mode="onehot"``, each row at its own position.
The kernel engine needs the fused dataflow and the shared offset.
``program_flops(n)`` counts one decode's FLOPs through the session's
``meter`` (``utils/flops.py``).

Lockstep streams (``batch=B``): B streams of the same length decode
together, every buffer, device scalar and graph sized for B.  Tokens are
(B, T); a prompt with a leading dim of 1 is shared by every stream.  The
wavefront's estimator then runs S * 2B rows (row order s * 2B + cfg * B +
b), one ``fused_tf_group`` launch per group as at B = 1, and the audio
comes back as (B, samples).  ``ring_quant=True`` stores the estimator rings
as int8 values with per-frame f32 scales (``kv_stream.quantize_ring_chunk``):
it needs the concat dataflow (``fused=False``) and runs the unfused engine
with per-row writes, as the JAX package does.

The estimator rings live in HBM at 56 layers x (S*2B, ring + chunk,
2*inner): 367 MB per stream in bf16 at the MOSS geometry.  They are updated
IN PLACE (the kernel writes each chunk into its ring), which takes the
place of the JAX package's buffer donation.

Stepped wavefront and hop (the JAX package's ``_wave_step[_k]`` and
``_hop``): the session holds one set of persistent buffers (token buffer,
enc and est caches, the extended est rings, the x / mu waves, the exit
mels) and the positions ``w``, ``n_tok``, ``k_total`` and ``base_frames``
as device scalars, reset in place by ``init_state`` and ``stream_decode``.
One wavefront iteration (``_wave_step_impl``; with the encoder hop while
w < k, without it after, where JAX had ``lax.cond``) and one per-hop step
(``_hop_impl``, per ``(emit_tokens, finalize)``) read and write only those,
so on CUDA each is captured once as a CUDA graph and replayed
(``graphs=True``, the default; ``StepGraphs``, which the continuous batcher
shares): the first call of each runs eagerly on the
capture stream, which is both its real work and the warm-up capture needs,
then records it.  Every later call is one graph launch.  ``graphs=False``
runs the same functions eagerly; on the CPU there are no graphs.  A failed
capture raises.  Each graph's fused-kernel launches are counted at capture
and added to the kernels' counters at every replay.  The prefill, the
extend / shrink (or rotation) of the rings around the wavefront and the
vocoders run eagerly.

Engines of the wavefront: ``kernel=True`` runs each resnet + transformer
group of the estimator as one ``fused_tf_group`` launch
(``ops/fused_block.py``); ``kernel=False`` runs the unfused per-layer
engine.  ``kernel="auto"`` picks the kernel engine whenever the geometry
allows it (``fused_block.kernel_limit`` for the down, mid and up groups: in
bf16 a hop of at most 32 frames, and rings whose layout fits the kernel's
shared memory), on every device: on the CPU its wrapper runs the plain
version.  ``enc_kernel=True`` (opt-in, as in the JAX package) runs the
wavefront's per-hop encoder with each conformer stack as one
``fused_conformer_group`` launch (``ops/fused_conformer.py``); the prefill
and the finalize hop keep the per-layer encoder step.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.flow.kv_stream import (
    dyn_slice, encoder_hop_kernel, est_cache_from_flat, est_cache_to_flat,
    extend_rings_for_fused, fuse_qkv_params, group_encoder_params,
    group_estimator_params, init_est_pool, init_kv_cache,
    kv_flow_encode_step, kv_flow_step, noise_chunk, pe_tables, rotate_rings,
    shrink_rings_from_fused, spk_embedding, tensor_leaves, ungroup_est_flat,
    wave_step, wave_step_kernel)
from ..ops.fused_block import kernel_limit
from ..utils.flops import DispatchMeter
from ..utils.graphs import StepGraphs
from .bulk_voc import BulkVocoder


def estimator_kernel_limit(est_cfg, cf: int, rp: int,
                           dtype: torch.dtype) -> Optional[str]:
    """``kernel_limit`` of the first of the estimator's down, mid and up
    groups (input channels in_channels, ch and 2 ch) that the kernel cannot
    run at chunk ``cf`` and ring ``rp``, or None."""
    ch = est_cfg.channels[0]
    for cin in (est_cfg.in_channels, ch, 2 * ch):
        why = kernel_limit(cf, rp, cin, ch, 4 * ch, 4 * ch,
                           est_cfg.num_heads, est_cfg.attention_head_dim,
                           dtype)
        if why:
            return why
    return None


def _pcm16(wav: torch.Tensor) -> torch.Tensor:
    """16-bit PCM on the device; the cast truncates toward zero."""
    return (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)


@dataclasses.dataclass
class KVVocState:
    """Per-hop vocoder caches on the device, one row per stream."""
    mel_cache: torch.Tensor        # (B, mel_cache_len, n_mel) f32
    source_cache: torch.Tensor     # (B, scl, 1) f32
    speech_cache: torch.Tensor     # (B, scl) f32


def vocode_hop(hift, fade_in: torch.Tensor, fade_out: torch.Tensor,
               mel_cache_len: int, dt: torch.dtype, emit_mel: torch.Tensor,
               voc: KVVocState, first: bool, finalize: bool, draws=None):
    """One hop of the per-hop vocoder (the JAX package's ``_voc_impl``):
    HiFT over the cached mel frames and the hop's, the source cache over
    the head of the excitation and the Hamming cross-fade with the speech
    cache, for B streams in lockstep.  ``draws`` the NSF source's draws
    (shared by the rows), else HiFT's own.  Returns (wav chunk (B, n) f32,
    new state); the finalize hop emits everything and returns ``voc`` as
    it was."""
    scl = fade_in.shape[0]
    if first:
        mel_in = emit_mel
        cache_source = None
    else:
        mel_in = torch.cat([voc.mel_cache.to(emit_mel.dtype), emit_mel], dim=1)
        cache_source = voc.source_cache.to(dt)
    wav, source = hift(mel_in.to(dt), cache_source, draws)
    wav = wav.float()
    if not first:
        head = wav[:, :scl] * fade_in + voc.speech_cache * fade_out
        wav = torch.cat([head, wav[:, scl:]], dim=1)
    if finalize:
        return wav, voc
    return wav[:, : wav.shape[1] - scl], KVVocState(
        mel_in[:, mel_in.shape[1] - mel_cache_len:].float(),
        source[:, source.shape[1] - scl:].float(),
        wav[:, wav.shape[1] - scl:])


class KVStreamDecoder:
    """Incremental streaming decoder bound to an ``AudioDecoder``'s modules,
    ``batch`` lockstep streams.  Geometry: ``block_size`` tokens per hop, a
    ring of ``ring_tokens`` tokens of left context, streams of at most
    ``token_cap`` tokens; ``fused`` selects the write-then-attend wavefront
    (else the concat dataflow), ``write_mode="onehot"`` the per-row write
    (the shared offset needs ``ring_tokens % block_size == 0``);
    ``ring_quant`` int8 estimator rings (concat dataflow only); ``graphs``
    replays the wavefront iteration and the per-hop step as CUDA graphs on
    a CUDA device.  ``enc_kernel`` with ``batch > 1`` raises."""

    def __init__(self, dec, prompt_token: np.ndarray,
                 prompt_feat: np.ndarray, embedding: np.ndarray,
                 block_size: int, ring_tokens: int = 35,
                 token_cap: int = 2048, fused: bool = True, kernel="auto",
                 enc_kernel: bool = False, graphs: bool = True,
                 write_mode: str = "auto", batch: int = 1,
                 ring_quant: bool = False):
        if write_mode not in ("auto", "onehot"):
            raise ValueError(f"write_mode {write_mode!r}: 'auto' or 'onehot'")
        if batch < 1:
            raise ValueError(f"batch {batch}: at least one stream")
        if ring_quant and fused:
            raise ValueError("ring_quant needs the concat dataflow "
                             "(fused=False)")
        if enc_kernel and batch > 1:
            raise ValueError("enc_kernel runs one stream: the "
                             "fused_conformer_group kernel takes batch 1, "
                             f"not {batch}")
        self.dec = dec
        self.b = batch
        self._quant = bool(ring_quant)
        self.hop = block_size
        self.ring_tokens = ring_tokens
        self.token_cap = token_cap
        self.la = dec.lookahead
        self.ratio = dec.ratio
        self.p = int(prompt_token.shape[1])
        cfg = dec.flow_cfg
        self.n_mel = cfg.output_size
        self.mel_cache_len = dec.pipe_cfg.mel_cache_len
        self.scl = dec.source_cache_len
        self.dev = dec.device
        self.dt = dec._dt()
        self.est_dt = dec.estimator_dtype or self.dt
        self.s_steps = cfg.cfm.n_timesteps
        self.cf = block_size * self.ratio
        self._fused = bool(fused)
        self._dataflow = "fused" if self._fused else "concat"
        # the shared-offset write needs the ring a multiple of the hop; else
        # (or with write_mode="onehot") each row writes at its own position
        self._dus_ok = (write_mode == "auto" and not self._quant
                        and ring_tokens % block_size == 0)
        self._write = "dus" if self._dus_ok else "onehot"
        # prompt alignment of the shared write offset (frames % hop)
        self._align = (self.p * self.ratio) % self.cf
        est_cfg = cfg.estimator
        why = estimator_kernel_limit(
            est_cfg, self.cf, ring_tokens * self.ratio + self.cf, self.est_dt)
        kernel_ok = (self._fused and self._dus_ok and not self._quant
                     and est_cfg.act_fn == "gelu" and not why)
        if kernel == "auto":
            kernel = kernel_ok
        if kernel and not kernel_ok:
            raise ValueError("the kernel engine needs fused=True, the "
                             "shared-offset geometry and exact GELU"
                             + (f"; {why}" if why else ""))
        self._kernel = bool(kernel)
        self.meter = DispatchMeter()
        self._steps = StepGraphs(self.dev, graphs, self.meter)
        self._graphs = self._steps.enabled
        self._graph = self._steps.graphs
        self._copier = None            # the D2H copy stream, made at use

        def bcast(a):              # one prompt shared by every stream
            a = np.asarray(a)
            if a.shape[0] == 1 and batch > 1:
                a = np.broadcast_to(a, (batch,) + a.shape[1:])
            if a.shape[0] != batch:
                raise ValueError(f"a prompt of {a.shape[0]} rows for "
                                 f"{batch} streams")
            return np.array(a)
        self._prompt_tok = torch.as_tensor(bcast(prompt_token),
                                           dtype=torch.long).to(self.dev)
        self._prompt_feat = torch.as_tensor(
            bcast(prompt_feat).astype(np.float32)).to(self.dev, self.dt)
        self._emb = torch.as_tensor(bcast(embedding).astype(np.float32)).to(
            self.dev, self.dt)
        self._pe_tok, self._pe_mel = pe_tables(cfg, token_cap + self.p + 16,
                                               self.dev)
        win = torch.from_numpy(np.hamming(2 * self.scl).astype(np.float32))
        self._fade_in = win[: self.scl].to(self.dev)
        self._fade_out = win[self.scl:].to(self.dev)

        # q/k/v re-pack and the kernel's packed weights: once per decoder
        self._fw = getattr(dec, "_fused_qkv", None)
        if self._fw is None:
            self._fw = dec._fused_qkv = fuse_qkv_params(dec.flow)
        self._gp = None
        if self._kernel:
            self._gp = getattr(dec, "_grouped_est_params", None)
            if self._gp is None:
                self._gp = dec._grouped_est_params = group_estimator_params(
                    dec.flow, self._fw)
        self._enc_kernel = bool(enc_kernel)
        self._egp = None
        if self._enc_kernel:
            self._egp = getattr(dec, "_grouped_enc_params", None)
            if self._egp is None:
                self._egp = dec._grouped_enc_params = group_encoder_params(
                    dec.flow, self._fw)
        self._spks = None
        self._bulk: Optional[BulkVocoder] = None
        self._cache: Optional[Dict] = None   # persistent state, made at use

    # ------------------------------------------------------------- state
    def _alloc(self) -> None:
        """The session's persistent buffers, made once: every graph reads and
        writes these addresses."""
        dev, cfg = self.dev, self.dec.flow_cfg
        est_cfg = cfg.estimator
        b = self.b
        cache = init_kv_cache(cfg, self.ring_tokens, batch=b, dtype=self.dt,
                              est_dtype=self.est_dt, device=dev,
                              est_quant=self._quant)
        cache["n_tok"] = torch.zeros((), dtype=torch.long, device=dev)
        # the extended rings in the kernel's grouped layout, and the flat
        # layout of the unfused engine as views of them; the canonical conv
        # caches are views of the same conv caches
        rows = self.s_steps * 2 * b
        rp = self.ring_tokens * self.ratio + (self.cf if self._fused else 0)
        self._ext_g = init_est_pool(cfg, rows, rp, self.est_dt, dev,
                                    quant=self._quant)
        self._ext = ungroup_est_flat(self._ext_g, est_cfg)
        if not self._fused:
            # concat dataflow: the wavefront's flat rings are the canonical
            # ones, so the canonical rings are views of them
            cache["est"]["kv"] = est_cache_from_flat(
                {"kv": self._ext["kv"], "convs": {}}, self.s_steps)["kv"]
        cache["est"]["convs"] = est_cache_from_flat(
            {"kv": (), "convs": self._ext["convs"]}, self.s_steps)["convs"]
        self._cache = cache
        self._rot_dev = torch.tensor(
            self._rot(rp) if self._dus_ok else [0] * rows, device=dev)

        s, cf, n_mel = self.s_steps, self.cf, self.n_mel
        sd = (torch.float32 if cfg.cfm.solver_dtype == "float32"
              else self.dt)
        self._x_w = torch.zeros((s, b, cf, n_mel), dtype=sd, device=dev)
        self._mu_w = torch.zeros((s, b, cf, n_mel), dtype=self.est_dt,
                                 device=dev)
        self._mu_zero = torch.zeros((b, cf, n_mel), dtype=self.dt,
                                    device=dev)
        self._w, self._k, self._base = (
            torch.zeros((), dtype=torch.long, device=dev) for _ in range(3))
        # exit mel of iteration w at row w
        self._mels = torch.zeros((self.token_cap // self.hop + s, b, cf,
                                  n_mel), dtype=torch.float32, device=dev)
        self._tok = torch.zeros((b, self.token_cap + self.hop + self.la + 1),
                                dtype=torch.long, device=dev)
        self._hop_out: Dict[Tuple[int, bool], torch.Tensor] = {}

    @torch.inference_mode()
    def init_state(self) -> Tuple[Dict, KVVocState]:
        """The session's cache, zeroed in place (n_tok 0), and fresh vocoder
        caches."""
        if self._cache is None:
            self._alloc()
        c = self._cache
        for t in list(tensor_leaves(c["enc"])) + list(tensor_leaves(
                c["est"])) + [c["n_tok"]]:
            t.zero_()
        z = lambda *s: torch.zeros(s, device=self.dev)  # noqa: E731
        b = self.b
        return c, KVVocState(z(b, self.mel_cache_len, self.n_mel),
                             z(b, self.scl, 1), z(b, self.scl))

    @torch.inference_mode()
    def _token_buf(self, tokens: np.ndarray) -> torch.Tensor:
        """The session's token buffer holding ``tokens`` (B, n <= token_cap)
        then zeros: one upload."""
        n = tokens.shape[1]
        if n > self.token_cap:
            raise ValueError(f"{n} tokens exceed the session's token_cap "
                             f"{self.token_cap}")
        if self._cache is None:
            self._alloc()
        buf = torch.zeros(self._tok.shape, dtype=torch.long)
        buf[:, :n] = torch.as_tensor(np.asarray(tokens))
        return self._tok.copy_(buf)

    def _own(self, token_buf, cache) -> None:
        if token_buf is not self._tok or cache is not self._cache:
            raise ValueError("the steps run on the session's own buffers: "
                             "pass _token_buf(tokens) and init_state()[0]")

    def _commit(self, enc: Dict, n_tok=None) -> None:
        """Copies a step's new conv caches (and token count) into the
        persistent cache; the rings were written in place."""
        for name in ("pre", "up_conv"):
            self._cache["enc"][name].copy_(enc[name])
        if n_tok is not None:
            self._cache["n_tok"].copy_(n_tok)

    def _slices(self, token_buf, n_tok, emit_tokens: int):
        """The hop's chunk and lookahead tokens at ``n_tok`` (a host int or a
        device scalar): a device gather, as JAX's dynamic_slice."""
        seg = dyn_slice(token_buf, n_tok - self.p, emit_tokens + self.la,
                        dim=1)
        return seg[:, :emit_tokens], seg[:, emit_tokens:]

    def _run(self, key: tuple, fn: Callable[[], None]) -> None:
        self._steps.run(key, fn)

    # ------------------------------------------------------------- steps
    def _hop_impl(self, emit_tokens: int, finalize: bool,
                  out: torch.Tensor) -> None:
        """One flow hop through the per-hop KV step at the cache's device
        n_tok (the JAX package's ``_hop_impl``); the mel into ``out``."""
        cache = self._cache
        chunk, ctx = self._slices(self._tok, cache["n_tok"], emit_tokens)
        cond = torch.zeros((self.b, emit_tokens * self.ratio, self.n_mel),
                           dtype=self.dt, device=self.dev)
        mel, new = kv_flow_step(self.dec.flow, self._fw, chunk, ctx, cond,
                                self._emb, cache, self._pe_tok, self._pe_mel,
                                finalize=finalize)
        self._commit(new["enc"], new["n_tok"])
        out.copy_(mel)

    def _wave_step_impl(self, with_enc: bool) -> None:
        """ONE wavefront iteration on the persistent state (the JAX package's
        ``_wave_step[_kernel]_impl``): the encoder hop at device n_tok when
        ``with_enc`` (w < k), the estimator over the x / mu waves, the exit
        mel into row w of the exit mels, then w += 1."""
        c = self._cache
        mu_new = self._mu_zero
        if with_enc:
            mu_new, enc = self._encode_hop(self._tok, c["enc"], c["n_tok"])
            self._commit(enc)
            c["n_tok"].add_(self.hop)
        flow = self.dec.flow
        if self._kernel:
            exit_mel, x_w, mu_w = wave_step_kernel(
                self._gp, flow.decoder, self._x_w, self._mu_w, mu_new,
                self._spks, self._ext_g, self._w, self._k, self._base)
        else:
            exit_mel, x_w, mu_w = wave_step(
                flow.decoder, self._fw, self._x_w, self._mu_w, mu_new,
                self._spks, self._ext, self._w, self._k, self._base,
                self._dataflow, self._write)
        self._x_w.copy_(x_w)
        self._mu_w.copy_(mu_w)
        self._mels.index_copy_(0, self._w.reshape(1), exit_mel[None])
        self._w.add_(1)

    @torch.inference_mode()
    def _prefill(self, token_buf, cache):
        """The prompt as one chunk, with the first ``la`` stream tokens as
        lookahead; warms every ring, emits nothing.  Eager."""
        self._own(token_buf, cache)
        _, new = self.meter.call(("prefill",), lambda: kv_flow_step(
            self.dec.flow, self._fw, self._prompt_tok,
            token_buf[:, :self.la], self._prompt_feat, self._emb, cache,
            self._pe_tok, self._pe_mel))
        self._commit(new["enc"], new["n_tok"])
        return cache

    @torch.inference_mode()
    def _hop(self, token_buf, cache, emit_tokens: int, finalize: bool):
        """One flow hop through the per-hop KV step: the next chunk (and its
        lookahead) at the cache's own position, replayed as a graph per
        ``(emit_tokens, finalize)``.  Returns (mel (B, frames, n_mel) f32,
        cache)."""
        self._own(token_buf, cache)
        key = (emit_tokens, bool(finalize))
        out = self._hop_out.get(key)
        if out is None:
            out = self._hop_out[key] = torch.empty(
                (self.b, emit_tokens * self.ratio, self.n_mel),
                dtype=torch.float32, device=self.dev)
        self._run(("hop",) + key, functools.partial(
            self._hop_impl, emit_tokens, bool(finalize), out))
        return out.clone(), cache

    @torch.inference_mode()
    def _voc(self, emit_mel, voc: KVVocState, first: bool, finalize: bool):
        """HiFT with the mel/source caches and the Hamming cross-fade.
        Returns (wav chunk (B, n) f32, new state)."""
        return self.meter.call(
            ("voc", first, finalize, emit_mel.shape[1]),
            lambda: vocode_hop(self.dec.hift, self._fade_in, self._fade_out,
                               self.mel_cache_len, self.dt, emit_mel, voc,
                               first, finalize))

    def schedule(self, n_tokens: int) -> List[Tuple[int, bool]]:
        """[(emit_tokens, finalize), ...]: steady hops while a full hop plus
        lookahead is available, then one finalize tail."""
        plan, off = [], 0
        while n_tokens - off >= self.hop + self.la:
            plan.append((self.hop, False))
            off += self.hop
        if n_tokens - off > 0:
            plan.append((n_tokens - off, True))
        return plan

    # -------------------------------------------------------------- flow
    def _flow_mels(self, token_buf, cache, plan):
        """The flow side of the plan hop by hop: (mel (B, T, n_mel), cache)."""
        mels = []
        for emit_tokens, finalize in plan:
            mel, cache = self._hop(token_buf, cache, emit_tokens, finalize)
            mels.append(mel)
        return torch.cat(mels, dim=1), cache

    @torch.inference_mode()
    def _encode_hop(self, token_buf, enc: Dict, n_tok):
        """The encoder of one steady hop at ``n_tok`` (a host int or a device
        scalar; the kernel hop when ``enc_kernel``): (mu chunk, new enc
        cache), rings written in place."""
        chunk, ctx = self._slices(token_buf, n_tok, self.hop)
        if self._enc_kernel:
            return encoder_hop_kernel(self._egp, self.dec.flow, chunk, ctx,
                                      enc, n_tok, self._pe_tok, self._pe_mel)
        return kv_flow_encode_step(self.dec.flow, self._fw, chunk, ctx, enc,
                                   n_tok, self._pe_tok, self._pe_mel)

    def _rot(self, rp: int) -> List[int]:
        """Per flat row, the slot rotation of the shared-offset scheme."""
        return [(s * self.cf) % rp for s in range(self.s_steps)
                for _ in range(2 * self.b)]

    def _wave_enter(self, cache, k: int) -> None:
        """The wavefront's entry: the x / mu waves and positions reset, the
        rings into the wavefront's layout in place (the JAX package's
        ``_prep_est``): extended to ring + chunk for the fused dataflow
        (rotated for the shared-offset write), rotated in place for the
        concat dataflow's shared-offset write."""
        flow, cf = self.dec.flow, self.cf
        base = self.p * self.ratio
        if self._spks is None:
            self._spks = spk_embedding(flow, self._emb)
        self._x_w.zero_()
        self._x_w[0].copy_(noise_chunk(flow.decoder, base, cf, self.n_mel,
                                       self.dev))
        self._mu_w.zero_()
        self._w.zero_()
        self._k.fill_(k)
        self._base.fill_(base)
        if self._fused:
            extend_rings_for_fused(est_cache_to_flat(cache["est"]), base, cf,
                                   self._rot_dev, out=self._ext["kv"])
        elif self._dus_ok:
            for ring in self._ext["kv"]:
                rotate_rings(ring, self._rot_dev)

    def _wave_exit(self, cache, k: int) -> None:
        """The inverse of ``_wave_enter`` (the JAX package's ``_fin_est``):
        the rings back to their canonical layout after k steady chunks."""
        if self._fused:
            shrink_rings_from_fused(
                self._ext, (self.p + k * self.hop) * self.ratio, self.cf,
                self._rot_dev, out=est_cache_to_flat(cache["est"])["kv"])
        elif self._dus_ok:
            for ring in self._ext["kv"]:
                rotate_rings(ring, self._rot_dev, inverse=True)

    def _wave_iters(self, k: int, lo: int, hi: int) -> None:
        """Wavefront iterations lo .. hi - 1 of a stream with k steady
        chunks, each one ``_wave_step_impl`` (a graph replay)."""
        for w in range(lo, hi):
            self._run(("wave", w < k),
                      functools.partial(self._wave_step_impl, w < k))

    @torch.inference_mode()
    def _flow_mels_wave(self, token_buf, cache, plan):
        """The wavefront: the encoder per steady hop, one batched estimator
        forward per iteration, over the k + S - 1 live iterations; the rings
        are brought into the wavefront's layout before and back after, in
        place.  Then the finalize tail through the per-hop step.  Returns
        (mel (B, T, n_mel) f32, cache)."""
        self._own(token_buf, cache)
        s_steps = self.s_steps
        k = sum(1 for _, fin in plan if not fin)
        self._wave_enter(cache, k)
        self._wave_iters(k, 0, k + s_steps - 1)
        self._wave_exit(cache, k)
        mels = [self._exit_mels(s_steps - 1, s_steps - 1 + k)] if k else []
        if plan and plan[-1][1]:
            mel, cache = self._hop(token_buf, cache, plan[-1][0], True)
            mels.append(mel)
        return torch.cat(mels, dim=1), cache

    def _exit_mels(self, lo: int, hi: int) -> torch.Tensor:
        """The exit mels of iterations lo .. hi - 1 as (B, frames, n_mel)."""
        return self._mels[lo:hi].transpose(0, 1).reshape(
            self.b, (hi - lo) * self.cf, self.n_mel)

    # ------------------------------------------------------ segmented
    def _seg_sizes(self, need: int, seg_iters: int,
                   grow: bool = False) -> List[int]:
        """Segment sizes covering ``need`` wavefront iterations (the JAX
        package's schedule): ``seg_iters`` iterations a segment, the tail in
        multiples of min(16, seg_iters).  ``grow``: a first segment of S
        iterations (the first chunk leaves as early as the ODE's depth
        allows), then 8, doubling up to ``seg_iters``.  The sizes set the
        segments' bounds; the session runs only the live iterations."""
        q = min(16, seg_iters)
        sizes, r = [], need
        if grow:
            first = min(self.s_steps, seg_iters)
            sizes.append(first)
            r -= first
            nxt = 8
            while r > max(q, nxt):
                sizes.append(nxt)
                r -= nxt
                nxt = min(nxt * 2, seg_iters)
        while r > 0:
            size = seg_iters if r >= seg_iters else q * ((r + q - 1) // q)
            sizes.append(size)
            r -= size
        return sizes

    def _segment_wavs(self, token_buf, cache, plan, sizes):
        """Yields each segment's wav (B, samples) f32 on the device: the
        segment's wavefront iterations (the session's own steps and engine,
        graph replays on CUDA), then its chunks through the bulk vocoder,
        carrying the vocoder's tails to the next segment; the last segment
        adds the finalize tail.  Joined, the segments are the unsegmented
        stream.  Reads nothing back to the host."""
        self._own(token_buf, cache)
        s_steps, cf, c = self.s_steps, self.cf, self.mel_cache_len
        k = sum(1 for _, fin in plan if not fin)
        has_tail = bool(plan and plan[-1][1])
        need = k + s_steps - 1
        if self._bulk is None:
            self._bulk = BulkVocoder(self.dec, cf)
        self._wave_enter(cache, k)
        done, w0 = 0, 0
        s_tail = w_tail = mel_ctx = None
        for si, size in enumerate(sizes):
            self._wave_iters(k, w0, min(w0 + size, need))
            lo, hi = max(w0, s_steps - 1), min(w0 + size, need)
            n_new = max(hi - lo, 0)
            last = si == len(sizes) - 1
            w0 += size
            if n_new == 0 and not last:
                continue
            seg_mel = self._exit_mels(lo, hi)
            parts = [seg_mel]
            tf, n_hops = 0, n_new
            if last:
                self._wave_exit(cache, k)
                if has_tail:
                    tail_mel, _ = self._hop(token_buf, cache, plan[-1][0],
                                            True)
                    parts.append(tail_mel)
                    tf = tail_mel.shape[1]
                else:
                    # the stream's last steady chunk is its finalize hop
                    tf, n_hops = cf, n_new - 1
            if done == 0:
                key = ("voc_first", n_hops - 1, tf, not last)
                wav, s_tail, w_tail = self.meter.call(
                    key, lambda: self._bulk.vocode_first(
                        torch.cat(parts, dim=1), n_hops - 1, tf,
                        hold=not last))
            else:
                key = ("voc_cont", n_hops, tf)
                wav, s_tail, w_tail = self.meter.call(
                    key, lambda: self._bulk.vocode_cont(
                        torch.cat([mel_ctx] + parts, dim=1), s_tail, w_tail,
                        n_hops, tf))
            mel_ctx = seg_mel[:, -c:]
            done += n_new
            yield wav

    def _copy_back(self, wavs, total: int, output: str):
        """Copies each device wav of ``wavs`` into one host buffer (B,
        total) as it is enqueued (16-bit PCM quantized on the device for
        ``output="int16"``): on CUDA into pinned memory on a copy stream,
        each copy after an event of its wav.  Yields (host buffer, start,
        end, copy-done event or None) as each copy is enqueued."""
        cuda = self.dev.type == "cuda"
        dtype = torch.int16 if output == "int16" else torch.float32
        host = torch.empty((self.b, total), dtype=dtype, pin_memory=cuda)
        if cuda and self._copier is None:
            self._copier = torch.cuda.Stream(self.dev)
        off = 0
        for wav in wavs:
            wav = _pcm16(wav) if output == "int16" else wav
            end = off + wav.shape[1]
            done = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record()
                self._copier.wait_event(ready)
                with torch.cuda.stream(self._copier):
                    host[:, off:end].copy_(wav, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                wav.record_stream(self._copier)
            else:
                host[:, off:end].copy_(wav)
            yield host, off, end, done
            off = end
        if off != total:
            raise RuntimeError(f"the chunks hold {off} samples, not {total}")

    def _enqueue_fetch(self, wavs, total: int, output: str):
        """Every copy of ``wavs`` to one host buffer enqueued: (the buffer,
        the last copy's event or None)."""
        done = None
        for host, _, _, done in self._copy_back(wavs, total, output):
            pass
        return host, done

    def _fetch(self, wavs, total: int, output: str) -> np.ndarray:
        """The stream of ``wavs`` on the host: every copy enqueued, then one
        wait for the last."""
        host, done = self._enqueue_fetch(wavs, total, output)
        if done is not None:
            done.synchronize()
        return host.numpy()

    # ----------------------------------------------------------- decode
    def _start(self, tokens: np.ndarray):
        """One token upload, a fresh state, the prompt prefill: (token
        buffer, cache, vocoder state, plan)."""
        tokens = np.asarray(tokens)
        if tokens.ndim != 2 or tokens.shape[0] != self.b:
            raise ValueError(f"tokens {tokens.shape}: the session decodes "
                             f"{self.b} lockstep streams, (B, T) with "
                             f"B = {self.b}")
        token_buf = self._token_buf(tokens)
        cache, voc = self.init_state()
        if self.p:
            cache = self._prefill(token_buf, cache)
        return token_buf, cache, voc, self.schedule(tokens.shape[1])

    def _hop_wavs(self, token_buf, cache, voc, plan):
        """Yields each hop's wav through the per-hop flow step and the
        per-hop vocoder."""
        for i, (emit_tokens, finalize) in enumerate(plan):
            mel, cache = self._hop(token_buf, cache, emit_tokens, finalize)
            seg, voc = self._voc(mel, voc, first=i == 0, finalize=finalize)
            yield seg

    @torch.inference_mode()
    def stream_decode(self, tokens: np.ndarray, output: str = "float32",
                      bulk_voc: bool = True, wavefront: bool = True,
                      segmented: bool = False,
                      seg_iters: int = 32) -> np.ndarray:
        """Whole-stream decode of (B, n) tokens -> (B, n*ratio*u) wav: one
        token upload, prompt prefill, the flow (wavefront or per hop), then
        bulk or per-hop vocoding, one copy back.  ``output="int16"``
        quantizes on the device to 16-bit PCM (``_pcm16`` of the f32
        stream).  ``segmented`` runs the wavefront in segments of
        ``seg_iters`` iterations, each vocoded and copied back as it
        leaves, the copies overlapping the later segments."""
        if output not in ("float32", "int16"):
            raise ValueError(f"output {output!r}: 'float32' or 'int16'")
        token_buf, cache, voc, plan = self._start(tokens)
        n_steady = sum(1 for _, fin in plan if not fin)
        if bulk_voc and len(plan) >= 2:
            if wavefront and n_steady >= 2 and segmented:
                sizes = self._seg_sizes(n_steady + self.s_steps - 1,
                                        seg_iters)
                return self._fetch(
                    self._segment_wavs(token_buf, cache, plan, sizes),
                    self._samples(plan), output)
            wav = self._bulk_wav(token_buf, cache, plan,
                                 wavefront and n_steady >= 2)
            return self._fetch([wav], wav.shape[1], output)
        return self._fetch(self._hop_wavs(token_buf, cache, voc, plan),
                           self._samples(plan), output)

    def _bulk_wav(self, token_buf, cache, plan, wavefront: bool
                  ) -> torch.Tensor:
        """The flow of the plan (the wavefront, or hop by hop) and the bulk
        vocoder: the streams' wav (B, samples) f32 on the device, nothing
        read back."""
        if wavefront:
            mel, _ = self._flow_mels_wave(token_buf, cache, plan)
        else:
            mel, _ = self._flow_mels(token_buf, cache, plan)
        if self._bulk is None:
            self._bulk = BulkVocoder(self.dec, self.cf)
        frames = [e * self.ratio for e, _ in plan]
        return self.meter.call(("bulk", tuple(frames)),
                               lambda: self._bulk.vocode(mel, frames))

    @torch.inference_mode()
    def launch(self, tokens: np.ndarray) -> torch.Tensor:
        """The wavefront decode of (B, n) tokens with at least two steady
        hops, enqueued: the wav (B, samples) f32 on the device; the host
        waits for nothing but the token upload (``fetch`` it)."""
        token_buf, cache, _, plan = self._start(tokens)
        if sum(1 for _, fin in plan if not fin) < 2:
            raise ValueError("launch needs at least 2 steady hops")
        return self._bulk_wav(token_buf, cache, plan, True)

    def _samples(self, plan) -> int:
        return sum(e for e, _ in plan) * self.ratio * (
            self.dec.hift_cfg.total_upsample)

    @torch.inference_mode()
    def stream_chunks(self, tokens: np.ndarray, wavefront: bool = False,
                      seg_iters: int = 32):
        """Yields the streams' wav as float32 (B, samples) chunks, each as
        soon as its copy to the host is done, while later chunks compute and
        copy: the chunks are enqueued in turn, and after each one every
        chunk whose copy has landed is yielded.  Default: one chunk per hop
        (the per-hop flow step and vocoder).  ``wavefront=True``: the
        segmented wavefront on the growing schedule (a first segment of S
        iterations, then 8, doubling up to ``seg_iters``), one chunk per
        segment.  The chunks joined are ``stream_decode``'s stream."""
        token_buf, cache, voc, plan = self._start(tokens)
        n_steady = sum(1 for _, fin in plan if not fin)
        if wavefront and n_steady >= 2:
            sizes = self._seg_sizes(n_steady + self.s_steps - 1, seg_iters,
                                    grow=True)
            wavs = self._segment_wavs(token_buf, cache, plan, sizes)
        else:
            wavs = self._hop_wavs(token_buf, cache, voc, plan)
        pending = collections.deque()
        for host, a, b, done in self._copy_back(wavs, self._samples(plan),
                                                "float32"):
            pending.append((a, b, done))
            while pending and (pending[0][2] is None
                               or pending[0][2].query()):
                a, b, _ = pending.popleft()
                yield host.numpy()[:, a:b]
        for a, b, done in pending:
            done.synchronize()
            yield host.numpy()[:, a:b]

    def warmup(self, n_tokens: int) -> None:
        """Runs (and on CUDA captures) the steps of an n-token stream."""
        self.stream_decode(np.zeros((self.b, n_tokens), np.int32))

    def program_flops(self, n_tokens: int, **decode_kw) -> float:
        """The FLOPs of one ``stream_decode(n_tokens, **decode_kw)`` as the
        port runs it: one decode of n zero tokens through the session's
        meter (``utils/flops.py``), each step's FLOPs counted in one eager
        run and multiplied by its dispatches, the kernels by the JAX
        package's formulas.  The live wavefront iterations only (the JAX
        package's scan also ran its bucket's dead ones); the speaker
        projection, made once per session, is not counted."""
        self.meter.reset()
        self.meter.enabled = True
        try:
            self.stream_decode(np.zeros((self.b, n_tokens), np.int32),
                               **decode_kw)
        finally:
            self.meter.enabled = False
        return self.meter.total_flops()
